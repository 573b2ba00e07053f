"""Mean ``StepStats.train_time`` of the window's RL steps, in seconds."""
from bench.lib.stats import mean


def read(record):
    return mean([st["train_s"] for st in record.steps if "train_s" in st])
