"""Shared dataclasses for the ROLL Flash pipeline."""
from __future__ import annotations

import dataclasses
import itertools
import threading
from typing import Any, Callable, List, Optional

import numpy as np

_uid = itertools.count()


class NotifyingEvent(threading.Event):
    """A ``threading.Event`` that invokes subscriber callbacks on ``set()``.

    Lets composite waiters (e.g. the router's fleet-wide ``FleetSyncEvent``)
    park on their own condition and be woken push-style the moment any
    constituent event fires, instead of polling ``is_set()``.

    Callbacks run on the *setting* thread, outside any subscriber lock the
    callee wants to take — keep them tiny (a ``notify_all``).  A callback
    registered after ``set()`` fires immediately on the registering thread.
    Duplicate ``set()`` calls fire callbacks once."""

    def __init__(self) -> None:
        super().__init__()
        self._cbs_lock = threading.Lock()
        self._cbs: List[Callable[[], None]] = []  # guarded-by: _cbs_lock
        self._fired = False                       # guarded-by: _cbs_lock

    def on_set(self, cb: Callable[[], None]) -> None:
        with self._cbs_lock:
            if not self._fired:
                self._cbs.append(cb)
                return
        cb()

    def set(self) -> None:  # noqa: A003 - matching threading.Event API
        super().set()
        with self._cbs_lock:
            if self._fired:
                return
            self._fired = True
            cbs, self._cbs = self._cbs, []
        for cb in cbs:
            cb()

# Priority classes for SLO-aware scheduling.  Higher value = more important.
# Any int works as a priority; these three are the conventional tenant tiers.
PRIORITY_LOW = 0
PRIORITY_NORMAL = 1
PRIORITY_HIGH = 2


def next_uid() -> int:
    return next(_uid)


@dataclasses.dataclass
class RolloutTask:
    """One schedulable unit of generation (after prompt replication, one
    task == one candidate response; without it, one task == a whole group)."""
    task_id: int
    prompt_id: int
    replica_idx: int                 # which of the G candidates
    prompt_tokens: Any               # np.ndarray int32
    max_new_tokens: int
    group_id: int = -1
    meta: dict = dataclasses.field(default_factory=dict)
    # --- SLO fields (see core/slo.py) ---
    # Scheduling class: higher wins the queue and may preempt lower classes.
    priority: int = PRIORITY_NORMAL
    # Latency budget relative to FIRST submission.  The proxy/router stamp
    # the absolute deadline into meta["deadline_at"] once, so abort->resume
    # continuation legs (which copy meta) inherit the original deadline.
    deadline_ms: Optional[float] = None


def expand_replicas(task: "RolloutTask", n: int) -> "List[RolloutTask]":
    """Expand a non-replicated group task (meta ``num_return_sequences=G``)
    into G schedulable candidates sharing its group id.  Used by both the
    LLMProxy (raw callers) and the RolloutClient (handle callers) — engines
    decode one sequence per request, so the group is realized as a group
    submission."""
    meta = {k: v for k, v in task.meta.items() if k != "num_return_sequences"}
    return [RolloutTask(task_id=task.task_id if i == 0 else next_uid(),
                        prompt_id=task.prompt_id, replica_idx=i,
                        prompt_tokens=task.prompt_tokens,
                        max_new_tokens=task.max_new_tokens,
                        group_id=task.group_id, meta=dict(meta),
                        priority=task.priority, deadline_ms=task.deadline_ms)
            for i in range(n)]


@dataclasses.dataclass
class Sample:
    """A finished (prompt, response) pair flowing through the SampleBuffer."""
    sample_id: int
    prompt_id: int
    replica_idx: int
    prompt_tokens: Any               # np.ndarray int32 (P,)
    response_tokens: Any             # np.ndarray int32 (R,)
    logprobs: Any                    # np.ndarray f32 (R,) behaviour-policy logprobs
    reward: Optional[float] = None
    version_started: int = 0         # policy version that *initiated* generation
    version_finished: int = 0
    group_id: int = -1
    is_positive: bool = False
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def response_len(self) -> int:
        return int(np.asarray(self.response_tokens).shape[0])


@dataclasses.dataclass
class Turn:
    observation_tokens: Any
    action_tokens: Any
    logprobs: Any
    env_latency: float = 0.0


@dataclasses.dataclass
class Trajectory:
    """Agentic rollout: multi-turn env interaction."""
    traj_id: int
    env_id: int
    group_id: int
    turns: List[Turn] = dataclasses.field(default_factory=list)
    reward: Optional[float] = None
    version_started: int = 0
    version_finished: int = 0
    done: bool = False
    failed: bool = False

    def to_sample(self) -> Sample:
        prompt = np.concatenate([np.asarray(t.observation_tokens) for t in self.turns]) \
            if self.turns else np.zeros((0,), np.int32)
        resp = np.concatenate([np.asarray(t.action_tokens) for t in self.turns]) \
            if self.turns else np.zeros((0,), np.int32)
        lps = np.concatenate([np.asarray(t.logprobs) for t in self.turns]) \
            if self.turns else np.zeros((0,), np.float32)
        return Sample(
            sample_id=next_uid(), prompt_id=self.env_id, replica_idx=0,
            prompt_tokens=prompt, response_tokens=resp, logprobs=lps,
            reward=self.reward, version_started=self.version_started,
            version_finished=self.version_finished, group_id=self.group_id,
            is_positive=bool(self.reward and self.reward > 0),
        )


@dataclasses.dataclass
class GenerationRequest:
    """In-flight request inside the LLMProxy / engine."""
    request_id: int
    task: RolloutTask
    version_started: int
    callback: Callable[["GenerationResult"], None]
    # set on a resumed request: the retained (aborted) request_id whose
    # KV pages the engine re-attaches instead of prefilling the prompt.
    resume_from: Optional[int] = None
    # incremental-token subscriber: called from the proxy loop with the
    # request's NEWLY decoded tokens (a delta, this leg only) whenever
    # they grow.  None = no streaming overhead for this request.
    stream_cb: Optional[Callable[[Any], None]] = None
    streamed: int = 0                # tokens already pushed to stream_cb
    # SLO watchdog bookkeeping (proxy-loop private): decoded tokens seen at
    # the last watchdog tick, and the clock reading when they last grew.
    decoded_seen: int = 0
    last_progress: float = 0.0


@dataclasses.dataclass
class GenerationResult:
    request_id: int
    task: RolloutTask
    tokens: Any                      # np int32 (R,)
    logprobs: Any                    # np f32 (R,)
    version_started: int
    aborted: bool = False
    partial: bool = False
    # ABORT with retained KV pages: the engine can resume this request
    # (by its request_id) without re-prefilling the decoded prefix.
    resumable: bool = False
    # filled by the RolloutClient on handle resolution: one (version,
    # num_tokens) entry per abort->resume leg the response was decoded
    # under.  None for raw engine/proxy results (single-leg, version ==
    # version_started).
    legs: Optional[List[tuple]] = None
    # SLO watchdog verdict: the request was force-resolved (deadline hit or
    # decode stalled).  Pages are RELEASED (not retained) — the partial
    # tokens are final and the client must not schedule a continuation.
    timed_out: bool = False


@dataclasses.dataclass
class Rejected(GenerationResult):
    """Typed admission-control outcome: the request never ran (or was shed
    from the queue).  Always ``aborted=True, partial=True`` with no tokens
    beyond previously-decoded legs; ``reason`` is one of ``"expired"``
    (deadline already/now past while queued), ``"queue_full"`` (per-class or
    total bound hit), or ``"shed"`` (evicted to admit higher-priority work)."""
    reason: str = ""
