"""Mean ``StepStats.wait_time`` of the window's RL steps, in seconds."""
from bench.lib.stats import mean


def read(record):
    return mean([st["wait_s"] for st in record.steps if "wait_s" in st])
