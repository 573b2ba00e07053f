"""Statistics over a measured window.

A rate is the work of the whole window over the whole window.  Nothing here
takes a median of chunks.
"""
from __future__ import annotations

from typing import Optional, Sequence


def rate(work: float, seconds: float) -> float:
    """Work per second over a window of ``seconds`` (> 0)."""
    if not seconds > 0:
        raise ValueError(f"a window of {seconds} s has no rate")
    return work / seconds


def mean(values: Sequence[float]) -> Optional[float]:
    return sum(values) / len(values) if values else None
