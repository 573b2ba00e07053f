"""Padded positions over all positions of the window's batches, in %."""


def read(record):
    positions = sum(st.get("positions", 0) for st in record.steps)
    if not positions:
        return None
    return 100.0 * (1.0 - sum(sum(st["lengths"]) for st in record.steps) / positions)
