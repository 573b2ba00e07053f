"""The window over the engines' decode steps in it, in milliseconds."""


def read(record):
    steps = record.counters.get("total_decode_steps")
    return 1e3 * record.window_s / steps if steps else None
