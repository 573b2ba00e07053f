"""Samples trained per second: the samples of the RL steps that ended in
the window over the window (end of step 0 to the end of its last step)."""
from bench.lib.stats import rate


def read(record):
    if not record.steps or "samples" not in record.steps[0]:
        return None
    return rate(sum(st["samples"] for st in record.steps), record.window_s)
