"""The share of the traced window in which no device operation ran, in %
(1 - the profiler's busy union over the window)."""


def read(record):
    if record.tracer is None:
        return None
    return 100.0 * (1.0 - record.tracer.busy_s() / record.tracer.window_s)
