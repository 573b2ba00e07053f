"""SLO layer configuration: admission control, preemption, and the watchdog.

One ``SLOConfig`` is shared (by value) across the serving stack:

* **Admission control** (router front door, or a standalone proxy):
  ``queue_limit_per_class`` / ``queue_limit_total`` bound the pending
  queues; work that cannot be queued is resolved immediately with a typed
  :class:`~repro_torch.core.types.Rejected` result instead of silently waiting.
  When the total bound is hit by a request that outranks queued work, the
  lowest-priority queued request is shed (``reason="shed"``) to make room.
* **Preemption** (proxy event loop): when the head of the pending queue
  outranks an active request and no slot is free, the lowest-priority
  active request is aborted WITH its KV pages retained, freeing a slot for
  the high-priority arrival; the victim's continuation re-queues at its own
  priority and later resumes at zero re-prefill cost.
* **Watchdog** (proxy event loop, once per ``step_once``):
  - pending work past its deadline is shed (``Rejected("expired")``),
  - active work past its deadline is force-resolved exactly once with
    ``timed_out=True`` (partial tokens, pages released),
  - active work whose decode made no progress for ``stall_timeout_s`` is
    treated the same (hung engine / stuck tool call),
  - active work that decoded ``defer_after_tokens`` with substantial budget
    left while others queue is deferred (abort-with-retain, re-queued) so
    detected long-tails never monopolize slots — RollPacker-style tail
    taming on top of the abort/resume machinery.

``clock`` is injectable so deterministic drivers (lockstep benchmarks,
tests) can express deadlines in rounds instead of wall-clock seconds.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional


@dataclasses.dataclass
class SLOConfig:
    # --- admission control (None = unbounded) ---
    queue_limit_per_class: Optional[int] = None
    queue_limit_total: Optional[int] = None
    # --- scheduling ---
    preempt: bool = True             # high-priority arrivals evict low-priority decodes
    # --- watchdog ---
    enforce_deadlines: bool = True   # force-resolve active work past deadline_at
    shed_expired: bool = True        # drop queued work past deadline_at
    stall_timeout_s: Optional[float] = None   # no-decode-progress timeout (None = off)
    defer_after_tokens: Optional[int] = None  # long-tail defer threshold (None = off)
    defer_min_remaining: int = 4     # only defer if at least this much budget is left
    # --- router-level hang detection (real threads only) ---
    # A live replica with active work whose steps_executed counter has not
    # moved for this many WALL-CLOCK seconds is declared dead and failed
    # over (covers hung engine loops that still answer healthy()).  Must
    # exceed any legitimate pause (e.g. a blocking weight-sync suspend).
    replica_stall_s: Optional[float] = None
    # Time source for deadline / stall accounting (monotonic seconds).
    clock: Callable[[], float] = time.monotonic


def stamp_deadline(task, now: float) -> Optional[float]:
    """Return the task's absolute deadline, stamping it into
    ``meta["deadline_at"]`` on first sight.  Continuation legs copy meta, so
    the deadline is fixed at FIRST submission and survives abort->resume."""
    existing = task.meta.get("deadline_at")
    if existing is not None:
        return existing
    if getattr(task, "deadline_ms", None) is None:
        return None
    deadline_at = now + task.deadline_ms / 1000.0
    task.meta["deadline_at"] = deadline_at
    return deadline_at


def without_admission(slo: Optional[SLOConfig]) -> Optional[SLOConfig]:
    """Copy with queue bounds removed.  Behind a router the bounds are
    enforced fleet-wide at the front door; per-replica bounds would
    double-count and reject work the router already admitted."""
    if slo is None:
        return None
    return dataclasses.replace(
        slo, queue_limit_per_class=None, queue_limit_total=None)
