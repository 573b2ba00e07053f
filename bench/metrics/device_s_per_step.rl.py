"""Device seconds of one RL step: the profiler's busy union over the traced
steps, over their number.  The device's work per step is fixed by the
traffic, so this stays steady where the host's pace moves the step's
wall time."""


def read(record):
    if record.tracer is None or not record.steps:
        return None
    return record.tracer.busy_s() / len(record.steps)
