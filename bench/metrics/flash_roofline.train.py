"""Flash attention's least time over its device time in the traced steps,
in %: the bound of each forward and backward call at its shapes
(``bench.lib.flops.flash_bound``); the time is every ``flash_`` kernel the
profiler saw (forwards, backward preparation, dQ, dK/dV and their sums)."""


def read(record):
    if record.tracer is None or record.flash_bound_s is None:
        return None
    c = record.counters
    if (c["flash_fwd"], c["flash_bwd"]) != (c["flash_fwd_expected"], c["flash_bwd_expected"]):
        raise ValueError(f"flash launches {c['flash_fwd']} / {c['flash_bwd']}, the bound "
                         f"counts {c['flash_fwd_expected']} / {c['flash_bwd_expected']}")
    seconds = record.tracer.kernel_seconds("flash_")
    return 100.0 * record.flash_bound_s / seconds if seconds > 0 else None
