"""Mean ``StepStats.sync_time`` of the window's RL steps, in seconds."""
from bench.lib.stats import mean


def read(record):
    return mean([st["sync_s"] for st in record.steps if "sync_s" in st])
