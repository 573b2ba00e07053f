"""RolloutClient: the handle-based rollout programming surface (§4.2).

The raw ``LLMProxy`` speaks a callback protocol: ``generate(task, version,
cb)`` fires ``cb`` once per completion *or abort*, and every consumer used to
re-implement the abort→resume continuation by hand (token stitching, budget
clamping, ``resumed_tokens`` meta threading).  This module moves all of that
into one client layer so schedulers, env managers and user code consume
plain handles:

* ``submit(task) -> GenerationHandle`` — an awaitable result.
  ``handle.result(timeout)`` blocks for the final sample;
  ``handle.abort(retain=)`` cancels (``retain=False``) or interrupts with
  transparent re-admission (``retain=True``); ``handle.stream()`` iterates
  incremental token chunks.
* ``submit_group(tasks) -> GroupHandle`` — the G candidates of one GRPO
  prompt as a unit (COW prefix sharing on engines that support it).
* ``session(...) -> Session`` — first-class multi-turn agentic interaction:
  the session owns the conversation context (``turn``/``full`` modes), turns
  ride the radix prefix cache as incremental prefill, and every turn is
  version-tagged.

**Proxy-owned continuation.**  A request aborted under a newer policy
version (``LLMProxy.abort_stale``, or ``handle.abort(retain=True)``) is
transparently re-admitted by the client: paged engines re-attach the
retained KV pages (zero prefix re-prefill), slot engines re-prefill the
concatenated prefix.  Behind a ``ProxyRouter`` fleet, a retained request
whose home replica is draining or overloaded migrates to another replica
instead — the router TRANSFERS the parked pages to the target, which
resumes at zero re-prefill too (only when the transfer can't run does the
concatenated prefix re-prefill there).
The handle resolves EXACTLY once, with the
budget-clamped, logprob-stitched final result; ``result.legs`` tags each
leg with the policy version it was decoded under (what IS-based off-policy
correctors need).  Behaviour-policy logprobs of every leg are kept;
new-policy logprobs are recomputed by the trainer's forward pass, never
here.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.locks import new_rlock
from repro_torch.core.types import (GenerationResult, Rejected, RolloutTask,
                                    expand_replicas, next_uid)

# The continuation path re-admits work on the proxy/router while holding the
# client lock (declared for concheck's cross-class cycle check):
# lock-order: RolloutClient._lock -> ProxyRouter._lock
# lock-order: RolloutClient._lock -> LLMProxy._load_lock

_SENTINEL = object()


def _np_tokens(x) -> np.ndarray:
    return (np.asarray(x, np.int32).ravel() if x is not None
            else np.zeros((0,), np.int32))


def _np_logprobs(x) -> np.ndarray:
    return (np.asarray(x, np.float32).ravel() if x is not None
            else np.zeros((0,), np.float32))


class GenerationHandle:
    """One submitted generation: resolves exactly once with the final,
    budget-clamped, logprob-stitched result — however many abort→resume
    legs it took to produce it."""

    def __init__(self, client: "RolloutClient", task: RolloutTask,
                 version: int, *, stream: bool = False):
        self._client = client
        self.task = task                     # the ORIGINAL task (leg 0)
        self.budget = int(task.max_new_tokens)
        self.orig_prompt = _np_tokens(task.prompt_tokens)
        self._tokens: List[np.ndarray] = []  # guarded-by: _client._lock — stitched per-leg chunks
        self._logprobs: List[np.ndarray] = []    # guarded-by: _client._lock
        self.legs: List[tuple] = []          # guarded-by: _client._lock — (version, tokens_in_leg)
        self._cur_rid = task.task_id         # guarded-by: _client._lock
        self._cur_version = version          # guarded-by: _client._lock
        self._streaming = stream
        self._emitted = 0                    # guarded-by: _client._lock — tokens pushed to stream queues
        self._done_len = 0                   # guarded-by: _client._lock — tokens across completed legs
        self._leg_tokens: List[np.ndarray] = []  # guarded-by: _client._lock — current leg's stream deltas
        self._leg_len = 0                    # guarded-by: _client._lock
        self._queues: List["queue.Queue"] = []   # guarded-by: _client._lock
        self._callbacks: List[Callable[[GenerationResult], None]] = []  # guarded-by: _client._lock
        self._cancelled = False              # guarded-by: _client._lock
        self._result: Optional[GenerationResult] = None  # guarded-by: _client._lock
        self._event = threading.Event()

    # ------------------------------------------------------------- waiting
    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)

    def result(self, timeout: Optional[float] = None) -> GenerationResult:
        """Block for the final result (raises TimeoutError on timeout)."""
        if not self._event.wait(timeout):
            raise TimeoutError(f"generation {self.task.task_id} not done "
                               f"within {timeout}s")
        # the resolving thread writes _result strictly before _event.set():
        # Event.wait() returning True happens-after that write, so this
        # lock-free read observes the final value.
        # concheck: disable=guarded-by
        return self._result

    def add_done_callback(self, fn: Callable[[GenerationResult], None]) -> None:
        """Run ``fn(final_result)`` on resolution (immediately if already
        resolved).  Callbacks run on the proxy thread — keep them quick."""
        with self._client._lock:
            if self._result is None:
                self._callbacks.append(fn)
                return
            res = self._result
        fn(res)

    # ------------------------------------------------------------ aborting
    def abort(self, retain: bool = False) -> None:
        """``retain=False``: cancel — the handle resolves with the partial,
        aborted result and any retained pages are freed.  ``retain=True``:
        interrupt now, transparently re-admit (the continuation keeps the
        decoded prefix; on paged engines the KV pages are re-attached).

        Cancellation is best-effort and asynchronous: the cancel flag and
        the current leg's request id are taken under the client lock (so a
        concurrent continuation either sees the flag and stops, or has
        already swapped in the new id, which is then the one aborted), but
        a request that COMPLETES before the abort command lands resolves
        normally — the finished sample is not discarded."""
        with self._client._lock:
            if self._result is not None:
                return
            if not retain:
                self._cancelled = True
            rid = self._cur_rid
        self._client.proxy.abort(rid, retain=retain)

    # ----------------------------------------------------------- streaming
    def stream(self):
        """Iterator of incremental np.int32 token chunks, ending when the
        handle resolves.  Live per-step chunks require the handle to have
        been submitted with ``stream=True`` (and an engine that supports
        ``peek_tokens``); otherwise chunks arrive per completed leg."""
        q: "queue.Queue" = queue.Queue()
        with self._client._lock:
            if self._result is None:
                # catch up on everything decoded so far (one-time concat),
                # then live deltas keep the cursor in sync.
                parts = [*self._tokens, *self._leg_tokens]
                total = (np.concatenate(parts)[:self.budget] if parts
                         else np.zeros((0,), np.int32))
                if len(total) > self._emitted:
                    q.put(total[self._emitted:])
                    self._emitted = len(total)
                self._queues.append(q)
                q_live = None
            else:
                total = self._stitched_tokens()[:self.budget]
                q_live = total[self._emitted:]
                self._emitted = len(total)

        def gen():
            if q_live is not None:
                if len(q_live):
                    yield q_live
                return
            while True:
                chunk = q.get()
                if chunk is _SENTINEL:
                    return
                yield chunk
        return gen()

    # ------------------------------------------------- client-side internals
    # All _-methods below run under the client lock, on the proxy thread.
    def _stitched_tokens(self) -> np.ndarray:  # holds: _client._lock
        return (np.concatenate(self._tokens) if self._tokens
                else np.zeros((0,), np.int32))

    def _stitched_logprobs(self) -> np.ndarray:  # holds: _client._lock
        return (np.concatenate(self._logprobs) if self._logprobs
                else np.zeros((0,), np.float32))

    def _append_leg(self, tokens, logprobs, version: int) -> None:  # holds: _client._lock
        t = _np_tokens(tokens)
        self._tokens.append(t)
        self._logprobs.append(_np_logprobs(logprobs))
        self.legs.append((version, len(t)))
        self._done_len += len(t)
        self._leg_tokens = []
        self._leg_len = 0

    def _push_stream(self) -> List[tuple]:  # holds: _client._lock
        """Emit everything stitched beyond what streams have seen.  Returns
        deferred (queue, chunk) pairs — the caller delivers them OUTSIDE the
        client lock."""
        total = self._stitched_tokens()[:self.budget]
        # the cursor only advances when subscribers exist: a post-hoc
        # ``stream()`` on an unconsumed handle yields everything.
        if len(total) <= self._emitted or not self._queues:
            return []
        chunk = total[self._emitted:]
        self._emitted = len(total)
        return [(q, chunk) for q in self._queues]

    def _on_leg_tokens(self, delta) -> None:
        """Proxy-loop stream hook: the current leg's NEWLY decoded tokens
        (a delta — the proxy keeps the per-leg cursor), so a streaming
        request costs O(1) amortized per token, not O(decoded)."""
        delta = _np_tokens(delta)
        out: List[tuple] = []
        with self._client._lock:
            if self._result is not None or len(delta) == 0:
                return
            start_abs = self._done_len + self._leg_len
            self._leg_tokens.append(delta)
            self._leg_len += len(delta)
            if self._queues:
                lo = max(self._emitted - start_abs, 0)
                hi = min(self.budget - start_abs, len(delta))
                if hi > lo:
                    chunk = delta[lo:hi]
                    self._emitted = start_abs + hi
                    out = [(q, chunk) for q in self._queues]
        for q, c in out:
            q.put(c)

    def _resolve(self, *, aborted: bool, resumable: bool = False,  # holds: _client._lock
                 timed_out: bool = False,
                 rejected_reason: Optional[str] = None) -> None:
        """Build the final stitched result.  Caller holds the client lock;
        the returned closure (callbacks + stream flush) is run by the client
        after releasing it."""
        tokens = self._stitched_tokens()[:self.budget]
        logprobs = self._stitched_logprobs()[:self.budget]
        version = self.legs[-1][0] if self.legs else self._cur_version
        # published leg counts are clamped like tokens/logprobs, so they
        # exactly segment those arrays (per-leg IS-corrector slicing);
        # self.legs keeps the raw counts for budget accounting.
        legs, acc = [], 0
        for v, n in self.legs:
            take = max(0, min(n, len(tokens) - acc))
            legs.append((v, take))
            acc += take
        kwargs = dict(
            request_id=self.task.task_id, task=self.task, tokens=tokens,
            logprobs=logprobs, version_started=version, aborted=aborted,
            partial=aborted, resumable=resumable, legs=legs,
            timed_out=timed_out)
        if rejected_reason is not None:
            self._result = Rejected(reason=rejected_reason, **kwargs)
        else:
            self._result = GenerationResult(**kwargs)


class GroupHandle:
    """The G candidate handles of one prompt, submitted as a unit."""

    def __init__(self, handles: List[GenerationHandle]):
        self.handles = handles

    def done(self) -> bool:
        return all(h.done() for h in self.handles)

    def wait(self, timeout: Optional[float] = None) -> bool:
        import time as _t
        deadline = None if timeout is None else _t.monotonic() + timeout
        for h in self.handles:
            left = None if deadline is None else max(0.0, deadline - _t.monotonic())
            if not h.wait(left):
                return False
        return True

    def results(self, timeout: Optional[float] = None) -> List[GenerationResult]:
        if not self.wait(timeout):
            raise TimeoutError(f"group of {len(self.handles)} not done "
                               f"within {timeout}s")
        return [h.result(0) for h in self.handles]

    def abort(self, retain: bool = False) -> None:
        for h in self.handles:
            h.abort(retain=retain)

    def add_done_callback(self, fn) -> None:
        for h in self.handles:
            h.add_done_callback(fn)


class Session:
    """First-class multi-turn agentic interaction over a RolloutClient.

    The session owns the conversation context:

    * ``context_mode="turn"`` — each turn's prompt is the bare observation
      (for envs whose observation already encodes full state).
    * ``context_mode="full"`` — each turn resubmits the growing
      conversation (obs₀ a₀ obs₁ ... obsₜ); on an engine with automatic
      prefix caching this is *incremental prefill per turn* (the shared
      history aliases cached pages, only the new suffix is computed).
      ``max_context_tokens`` caps the prompt by dropping oldest turns.

    Each turn is version-tagged (``turn_versions``; multi-leg turns carry
    their full ``legs``), and an in-flight turn interrupted by a weight
    sync transparently resumes under the new version — the caller only
    ever sees the finished turn.
    """

    def __init__(self, client: "RolloutClient", *, session_id: int,
                 max_new_tokens: int, context_mode: str = "turn",
                 max_context_tokens: Optional[int] = None, group_id: int = -1,
                 priority: Optional[int] = None,
                 deadline_ms: Optional[float] = None):
        if context_mode not in ("turn", "full"):
            raise ValueError(f"context_mode must be turn|full, got {context_mode!r}")
        if context_mode == "full" and max_context_tokens is None:
            # an uncapped growing conversation would eventually overrun the
            # engine's sequence budget and assert inside the proxy thread.
            raise ValueError("context_mode='full' requires max_context_tokens")
        self.client = client
        self.session_id = session_id
        self.group_id = group_id
        self.max_new_tokens = max_new_tokens
        self.context_mode = context_mode
        self.max_context_tokens = max_context_tokens
        self.context: List[np.ndarray] = []   # alternating obs/action turns
        self.turn_versions: List[int] = []
        self.num_turns = 0
        self.priority = priority
        # per-TURN latency budget: each turn() stamps a fresh deadline
        # (an env step in between resets the clock, unlike a continuation).
        self.deadline_ms = deadline_ms

    def _build_prompt(self, obs: np.ndarray) -> np.ndarray:
        if self.context_mode != "full":
            return obs
        parts = list(self.context) + [obs]
        if self.max_context_tokens is not None:
            total = sum(len(p) for p in parts)
            while len(parts) > 1 and total > self.max_context_tokens:
                total -= len(parts.pop(0))   # drop oldest turns first
            if total > self.max_context_tokens:
                parts = [parts[0][-self.max_context_tokens:]]
        return np.concatenate(parts) if len(parts) > 1 else parts[0]

    def turn(self, obs_tokens,
             max_new_tokens: Optional[int] = None) -> GenerationHandle:
        """Submit one conversation turn; returns its handle.  On resolution
        the session appends (observation, action) to its context and
        records the turn's version tag — callers just ``.result()``."""
        obs = _np_tokens(obs_tokens)
        slo_kw = {}
        if self.priority is not None:
            slo_kw["priority"] = self.priority
        if self.deadline_ms is not None:
            slo_kw["deadline_ms"] = self.deadline_ms
        task = RolloutTask(
            task_id=next_uid(), prompt_id=self.session_id, replica_idx=0,
            prompt_tokens=self._build_prompt(obs),
            max_new_tokens=max_new_tokens or self.max_new_tokens,
            group_id=self.group_id,
            meta={"session_id": self.session_id, "turn": self.num_turns},
            **slo_kw)
        self.num_turns += 1
        handle = self.client.submit(task)

        def record(res: GenerationResult) -> None:
            if res.aborted:
                return
            self.context.append(obs)
            self.context.append(_np_tokens(res.tokens))
            self.turn_versions.append(res.version_started)

        handle.add_done_callback(record)
        return handle

    def reset(self) -> None:
        self.context = []
        self.turn_versions = []
        self.num_turns = 0


class RolloutClient:
    """Handle-issuing layer over an ``LLMProxy``.

    * ``version_fn`` — policy version used to tag new submissions and
      resume legs (pipelines pass the SampleBuffer's version).
    * ``resume_gate`` — continuation predicate: when it returns False an
      aborted request resolves instead of re-admitting (pipelines gate on
      buffer-closed / producer-stopped).
    """

    def __init__(self, proxy, *, version_fn: Optional[Callable[[], int]] = None,
                 resume_gate: Optional[Callable[[], bool]] = None):
        self.proxy = proxy
        self._version_fn = version_fn or (lambda: 0)
        self._resume_gate = resume_gate or (lambda: True)
        self._lock = new_rlock("RolloutClient._lock")
        self._inflight: Dict[int, GenerationHandle] = {}  # guarded-by: _lock
        self._closed = False             # guarded-by: _lock
        self.resumes = 0                 # guarded-by: _lock — retained-page re-attach legs
        self.reprefills = 0              # guarded-by: _lock — slot-engine concatenated-prefix legs
        self.migrations = 0              # guarded-by: _lock — cross-replica re-admission legs

    @classmethod
    def ensure(cls, proxy_or_client, **kwargs) -> "RolloutClient":
        """The proxy-or-client coercion every consumer needs: pass an
        existing RolloutClient through UNTOUCHED (the kwargs apply only
        when wrapping a raw LLMProxy — a pre-built client keeps its own
        version_fn / resume_gate, which is the point of passing one)."""
        if isinstance(proxy_or_client, cls):
            return proxy_or_client
        return cls(proxy_or_client, **kwargs)

    # ------------------------------------------------------------- submit
    def submit(self, task: RolloutTask, *, version: Optional[int] = None,
               stream: bool = False):
        """Submit one task; returns its ``GenerationHandle``.

        A task carrying ``meta["num_return_sequences"] = G > 1`` (the
        non-replicated group encoding from ``expand_tasks``) is expanded
        into G candidate handles and returns a ``GroupHandle`` — engines
        decode one sequence per request, so the group is realized as a COW
        group submission (or G singles on engines without group support).
        """
        n = int(task.meta.get("num_return_sequences", 1))
        if n > 1:
            if stream:
                raise ValueError("stream is unsupported for "
                                 "num_return_sequences-expanded tasks — "
                                 "submit the replicas individually")
            return self.submit_group(expand_replicas(task, n),
                                     version=version)
        v = self._version_fn() if version is None else version
        h = GenerationHandle(self, task, v, stream=stream)
        with self._lock:
            self._inflight[task.task_id] = h
        self.proxy.generate(task, v, self._dispatch,
                            **({"stream_cb": h._on_leg_tokens} if stream else {}))
        return h

    def submit_group(self, tasks: List[RolloutTask], *,
                     version: Optional[int] = None) -> GroupHandle:
        """Submit the G candidates of ONE prompt as a unit (COW prefix
        sharing where the engine supports it)."""
        assert tasks, "empty group"
        v = self._version_fn() if version is None else version
        handles = [GenerationHandle(self, t, v) for t in tasks]
        with self._lock:
            for t, h in zip(tasks, handles, strict=True):
                self._inflight[t.task_id] = h
        if len(tasks) > 1:
            self.proxy.generate_group(tasks, v, self._dispatch)
        else:
            self.proxy.generate(tasks[0], v, self._dispatch)
        return GroupHandle(handles)

    def session(self, *, session_id: Optional[int] = None,
                max_new_tokens: int, context_mode: str = "turn",
                max_context_tokens: Optional[int] = None,
                group_id: int = -1, priority: Optional[int] = None,
                deadline_ms: Optional[float] = None) -> Session:
        return Session(self, session_id=next_uid() if session_id is None
                       else session_id, max_new_tokens=max_new_tokens,
                       context_mode=context_mode,
                       max_context_tokens=max_context_tokens,
                       group_id=group_id, priority=priority,
                       deadline_ms=deadline_ms)

    def close(self) -> None:
        """Stop issuing continuations: subsequent aborts resolve their
        handles instead of re-admitting."""
        with self._lock:
            self._closed = True

    @property
    def num_inflight(self) -> int:
        with self._lock:
            return len(self._inflight)

    # ------------------------------------------------------- continuation
    def _dispatch(self, res: GenerationResult) -> None:
        """THE proxy callback: routes every leg's completion or abort to
        its handle and owns the abort→resume continuation."""
        deliver: List[tuple] = []
        fns: List = []
        final: Optional[GenerationResult] = None
        with self._lock:
            h = self._inflight.pop(res.request_id, None)
            if h is None:
                return
            if not res.aborted:
                h._append_leg(res.tokens, res.logprobs, res.version_started)
                h._resolve(aborted=False)
            else:
                h._append_leg(res.tokens, res.logprobs, res.version_started)
                decoded = sum(n for _, n in h.legs)
                remaining = h.budget - decoded
                # SLO terminal verdicts never continue: a timed-out request
                # had its pages released (partial tokens are final), and a
                # rejected one was refused admission — re-submitting it
                # would defeat the load shed.
                timed_out = bool(getattr(res, "timed_out", False))
                rejected_reason = res.reason if isinstance(res, Rejected) \
                    else None
                terminal = timed_out or rejected_reason is not None
                resume = (not terminal and not h._cancelled
                          and not self._closed and self._resume_gate())
                if resume and remaining > 0:
                    self._continue(h, res, remaining)
                    deliver = h._push_stream()
                    final = None
                else:
                    if res.resumable:
                        # parked pages nobody will re-attach
                        self.proxy.release_retained(res.request_id)
                    # budget spent => the sample is COMPLETE, not aborted:
                    # resuming would decode >= 1 extra token per cycle.
                    budget_done = (remaining <= 0 and not h._cancelled
                                   and not terminal)
                    h._resolve(aborted=not budget_done, timed_out=timed_out,
                               rejected_reason=rejected_reason)
            if h._result is not None:
                final = h._result
                deliver = h._push_stream()
                deliver += [(q, _SENTINEL) for q in h._queues]
                fns, h._callbacks = h._callbacks, []
        for q, chunk in deliver:
            q.put(chunk)
        if final is not None:
            # done callbacks run BEFORE the event trips so result() waiters
            # observe their effects (e.g. Session context updates); the
            # event is set even if a callback raises.
            try:
                for fn in fns:
                    fn(final)
            finally:
                h._event.set()

    def _continue(self, h: GenerationHandle, res: GenerationResult,  # holds: _lock
                  remaining: int) -> None:
        """Re-admit an interrupted request (caller holds the lock).  Paged
        engines re-attach the retained pages (zero prefix re-prefill);
        others re-prefill the concatenated prefix.  Behind a fleet router,
        a resumable request whose home replica is draining or overloaded
        (``prefer_resume`` → False) MIGRATES instead: the router transfers
        the parked pages to the target replica, which resumes at zero
        re-prefill.  The concatenated task built here is the transfer's
        fallback — when the pages can't move (crashed home, page pressure
        on the target) the target re-prefills it, incremental wherever its
        radix cache has seen the prefix."""
        new_rid = next_uid()
        version = self._version_fn()
        h._cur_rid = new_rid
        h._cur_version = version
        t = h.task
        # lineage tags the watchdog stamped on the CURRENT leg's task (the
        # long-tail defer marker) must survive into the next leg, whose
        # meta is copied from the leg-0 task.
        if res.task is not None and res.task.meta.get("slo_deferred") \
                and not t.meta.get("slo_deferred"):
            t.meta["slo_deferred"] = True
        stream = {"stream_cb": h._on_leg_tokens} if h._streaming else {}
        if res.resumable:
            prefer = getattr(self.proxy, "prefer_resume", None)
            if prefer is not None and not prefer(res.request_id, remaining):
                concat = RolloutTask(
                    task_id=new_rid, prompt_id=t.prompt_id,
                    replica_idx=t.replica_idx,
                    prompt_tokens=np.concatenate([h.orig_prompt,
                                                  h._stitched_tokens()]),
                    max_new_tokens=remaining, group_id=t.group_id,
                    meta=dict(t.meta), priority=t.priority,
                    deadline_ms=t.deadline_ms)
                self._inflight[new_rid] = h
                try:
                    self.proxy.generate_migrated(
                        concat, version, self._dispatch,
                        release_from=res.request_id, **stream)
                    self.migrations += 1
                    return
                except Exception:
                    # no replica can take the grown concatenated prompt;
                    # the pages are still parked (the router releases only
                    # after placing) — resume in place instead.
                    self._inflight.pop(new_rid, None)
            resumed = RolloutTask(
                task_id=new_rid, prompt_id=t.prompt_id,
                replica_idx=t.replica_idx, prompt_tokens=h.orig_prompt,
                max_new_tokens=remaining, group_id=t.group_id,
                meta=dict(t.meta), priority=t.priority,
                deadline_ms=t.deadline_ms)
            self._inflight[new_rid] = h
            try:
                self.proxy.generate_resumed(resumed, version, self._dispatch,
                                            resume_from=res.request_id,
                                            **stream)
                self.resumes += 1
                return
            except Exception:
                # the replica holding the retained pages died between the
                # abort and this resume (router raises: nothing left to
                # re-attach) — fall through to re-prefilling the
                # concatenated prefix on a live replica.
                self._inflight.pop(new_rid, None)
        self.reprefills += 1
        resumed = RolloutTask(
            task_id=new_rid, prompt_id=t.prompt_id, replica_idx=t.replica_idx,
            prompt_tokens=np.concatenate([h.orig_prompt,
                                          h._stitched_tokens()]),
            max_new_tokens=remaining, group_id=t.group_id, meta=dict(t.meta),
            priority=t.priority, deadline_ms=t.deadline_ms)
        self._inflight[new_rid] = h
        self.proxy.generate(resumed, version, self._dispatch, **stream)
