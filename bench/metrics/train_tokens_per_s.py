"""Trained tokens per second: the non-padding tokens (prompt and response)
of the samples of the train steps that ended in the window, over the
window."""
from bench.lib.stats import rate


def read(record):
    if not record.steps or "positions" not in record.steps[0]:
        return None
    return rate(sum(sum(st["lengths"]) for st in record.steps), record.window_s)
