"""LLMProxy: command-driven event loop orchestrating an inference engine.

Mirrors the paper's §4.2 LLMProxy exactly:

* **Step-wise inference** — each loop iteration advances the engine by a
  single decode step over the whole active batch (continuous batching).
* **Post-processing** — completed requests immediately trigger the
  registered callback with the result.
* **Process commands** — ADD enqueues new requests; ABORT interrupts
  running requests and returns partials for reclamation into the
  SampleBuffer (recompute/resume under a newer policy version).

The proxy owns the engine thread-exclusively: all cross-thread interaction
goes through the command queue.  ``suspend``/``resume``/``update_weights``
implement the AsyncController's 3-phase weight synchronization.
"""
from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Protocol

from repro_torch.analysis.sanitizer import new_lock
from repro_torch.core.slo import SLOConfig, stamp_deadline
from repro_torch.core.types import (PRIORITY_NORMAL, GenerationRequest,
                                    GenerationResult, NotifyingEvent, Rejected,
                                    RolloutTask, expand_replicas)


class InferenceEngine(Protocol):
    """Continuous-batching engine (slot-based: rollout/engine.py; paged-KV
    with chunked prefill + COW prefix sharing: rollout/paged_engine.py).

    Optional capabilities, feature-detected by the proxy via getattr:

    * ``supports_retain`` (bool) — ``abort(rid, retain=True)`` parks the
      request's KV pages; ``resume_request(old_rid, new_rid, max_new)``
      re-attaches them (no prefix re-prefill); ``release_retained(rid)``
      frees parked pages; ``can_resume(rid, max_new)`` gates admission.
    * ``can_admit(prompt_len, max_new)`` — admission gate beyond free
      slots (e.g. page-pool headroom in the paged engine).
    * ``supports_group`` (bool) — ``submit_group([rids], prompt, max_new)``
      admits the G candidates of one prompt as a unit, prefilling the
      prompt ONCE and forking G decode lanes whose block tables alias the
      shared prefix pages (copy-on-write); ``can_admit_group(plen, G,
      max_new)`` gates it.  Engines without it get the group expanded into
      G independent requests by the proxy.
    """

    @property
    def num_free_slots(self) -> int: ...

    def add_request(self, request_id: int, prompt_tokens, max_new_tokens: int) -> None: ...

    def abort(self, request_id: int) -> GenerationResult | Any: ...

    def step(self) -> List[Any]:
        """One decode step; returns finished (request_id, tokens, logprobs)."""
        ...

    def update_weights(self, params) -> None: ...


@dataclasses.dataclass
class _PendingGroup:
    """G candidates of one prompt awaiting an all-or-nothing group admit."""
    requests: List[GenerationRequest]


class LLMProxy:
    def __init__(self, engine: InferenceEngine, *, name: str = "llm_proxy",
                 slo: Optional[SLOConfig] = None):
        self.engine = engine
        self.name = name
        self._slo = slo
        self._commands: "queue.Queue[tuple]" = queue.Queue()
        # entries: GenerationRequest | _PendingGroup
        self._pending: collections.deque = collections.deque()
        self._active: Dict[int, GenerationRequest] = {}
        self._suspended = threading.Event()
        self._resumed = threading.Event()
        self._resumed.set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._idle_sleep = 0.0005
        self._num_streaming = 0          # active requests with a stream_cb
        # cheap load metric for fleet routers: outstanding decode work in
        # tokens (unprefilled prompt + unspent budget), updated at SUBMIT
        # time on the caller thread so a router sees its own placements
        # immediately (the command queue only drains on the loop thread).
        self._load_lock = new_lock("LLMProxy._load_lock")
        self._load_by_rid: Dict[int, int] = {}  # guarded-by: _load_lock
        self._outstanding_tokens = 0            # guarded-by: _load_lock
        self.steps_executed = 0
        self.requests_completed = 0
        self.requests_aborted = 0
        self.suspend_count = 0
        self.staged_weight_updates = 0   # non-blocking (overlapped) swaps
        # --- SLO counters (monotonic; aggregated fleet-wide by the router) ---
        self.deadline_misses = 0         # expired rejections + enforced timeouts
        self.preemptions = 0             # active work aborted-with-retain for priority
        self.long_tail_defers = 0        # detected long-tails parked to unblock others
        self.stall_aborts = 0            # no-decode-progress force-resolutions
        self.rejected = 0                # requests resolved with a typed Rejected

    # ------------------------------------------------------------- load
    def _load_add(self, request_id: int, tokens: int) -> None:
        with self._load_lock:
            self._load_by_rid[request_id] = tokens
            self._outstanding_tokens += tokens

    def _load_drop(self, request_id: int) -> None:
        with self._load_lock:
            self._outstanding_tokens -= self._load_by_rid.pop(request_id, 0)

    def _load_add_group(self, reqs: List[GenerationRequest]) -> None:
        """COW sharing prefills the prompt once: charge it to the leader
        only, so fleet load stays comparable across engine types."""
        for i, r in enumerate(reqs):
            self._load_add(r.request_id, r.task.max_new_tokens
                           + (len(r.task.prompt_tokens) if i == 0 else 0))

    def load(self) -> int:
        """Outstanding decode work admitted to this proxy, in tokens
        (prompt prefill + generation budget of every pending/active
        request).  Routers dispatch each request to the least-loaded
        replica (queue scheduling)."""
        with self._load_lock:
            return self._outstanding_tokens

    def can_accept(self, prompt_len: int, max_new_tokens: int) -> bool:
        """Static admission feedback for routers: whether this replica
        could EVER take one request of this shape (sequence / page-pool
        capacity), independent of current load.  A request failing this
        must be routed elsewhere — queued here it would block the pending
        queue forever.  Group size doesn't enter: a group that fits only
        as singles is expanded by the admission path."""
        eng = self.engine
        max_total = getattr(eng, "max_total_len", None)
        if max_total is not None and prompt_len + max_new_tokens > max_total:
            return False
        fits = getattr(eng, "group_fits_pool", None)
        if fits is not None and not fits(prompt_len, 1, max_new_tokens):
            return False
        return True

    def owns_request(self, request_id: int) -> bool:
        """Whether this replica currently knows the request — active,
        queued pending, or parked as retained pages.  Fleet audits use
        this to prove the router's rid→replica map never leaks entries
        for requests that already finished.  Commands still in the
        submit queue are not visible: call at quiescence."""
        if request_id in self._active:
            return True
        while True:     # lock-free snapshot, same idiom as num_pending
            try:
                pending = [r.request_id for e in tuple(self._pending)
                           for r in self._entry_requests(e)]
                break
            except RuntimeError:
                continue
        if request_id in pending:
            return True
        return request_id in getattr(self.engine, "retained", {})

    # ------------------------------------------------------------- commands
    def generate(self, task: RolloutTask, version: int,
                 callback: Callable[[GenerationResult], None],
                 stream_cb: Optional[Callable] = None):
        """Submit one task.  A task carrying ``meta["num_return_sequences"]
        = G > 1`` (the non-replicated group encoding) is expanded into G
        candidate requests sharing its group id — engines decode one
        sequence per request, so the proxy realizes the group as a group
        submission (COW sharing where supported); the callback then fires
        once per candidate.  Returns the request id (list of ids when
        expanded)."""
        n = int(task.meta.get("num_return_sequences", 1))
        if n > 1:
            if stream_cb is not None:
                # one stream_cb cannot disambiguate G interleaved candidate
                # streams — submit the replicas individually to stream them.
                raise ValueError("stream_cb is unsupported for "
                                 "num_return_sequences-expanded tasks")
            tasks = expand_replicas(task, n)
            if not self._admit_submission(tasks, version, callback):
                return [t.task_id for t in tasks]
            reqs = [GenerationRequest(request_id=t.task_id, task=t,
                                      version_started=version,
                                      callback=callback)
                    for t in tasks]
            self._load_add_group(reqs)
            self._commands.put(("ADD_GROUP", _PendingGroup(reqs)))
            return [r.request_id for r in reqs]
        if not self._admit_submission([task], version, callback):
            return task.task_id
        req = GenerationRequest(request_id=task.task_id, task=task,
                                version_started=version, callback=callback,
                                stream_cb=stream_cb)
        self._load_add(req.request_id,
                       len(task.prompt_tokens) + task.max_new_tokens)
        self._commands.put(("ADD", req))
        return req.request_id

    def generate_group(self, tasks: List[RolloutTask], version: int,
                       callback: Callable[[GenerationResult], None]) -> List[int]:
        """Submit the G candidates of ONE prompt as a single group.

        Engines with COW prefix sharing (``supports_group``) prefill the
        prompt once and fork G decode lanes sharing its KV pages; other
        engines transparently get G independent requests.  All tasks must
        carry the same prompt and budget (they are replicas)."""
        assert tasks, "empty group"
        t0 = tasks[0]
        assert all(t.max_new_tokens == t0.max_new_tokens
                   and len(t.prompt_tokens) == len(t0.prompt_tokens)
                   for t in tasks), "group tasks must be replicas"
        if not self._admit_submission(tasks, version, callback):
            return [t.task_id for t in tasks]
        reqs = [GenerationRequest(request_id=t.task_id, task=t,
                                  version_started=version, callback=callback)
                for t in tasks]
        self._load_add_group(reqs)
        self._commands.put(("ADD_GROUP", _PendingGroup(reqs)))
        return [r.request_id for r in reqs]

    def generate_resumed(self, task: RolloutTask, version: int,
                         callback: Callable[[GenerationResult], None],
                         resume_from: int,
                         stream_cb: Optional[Callable] = None) -> int:
        """Re-initiate an ABORTed-with-retain request: the engine re-attaches
        the retained KV pages instead of prefilling the prompt."""
        # no queue-bound admission: a continuation holds pages the fleet
        # wants back — rejecting it would leak them.  The watchdog still
        # sheds it from pending if its (inherited) deadline expires.
        if self._slo is not None:
            stamp_deadline(task, self._slo.clock())
        req = GenerationRequest(request_id=task.task_id, task=task,
                                version_started=version, callback=callback,
                                resume_from=resume_from, stream_cb=stream_cb)
        # no prefill work: the retained pages re-attach
        self._load_add(req.request_id, task.max_new_tokens)
        self._commands.put(("ADD", req))
        return req.request_id

    # ------------------------------------------- cross-replica page transfer
    def export_retained(self, request_id: int) -> Optional[dict]:
        """Host-side snapshot of a retained request's KV pages (for a
        router-directed migration to another replica).  The engine is only
        safe to touch from its own loop thread, so this degrades to None —
        and the caller to the concat re-prefill path — when invoked from
        anywhere else while the loop is running.  In practice migration runs
        either on this proxy's loop thread (the abort callback chain) or on
        the single driver thread of a lockstep fleet, so the fast path is
        the common case."""
        t = self._thread
        if (t is not None and t.is_alive()
                and threading.current_thread() is not t):
            return None
        export = getattr(self.engine, "export_retained", None)
        return None if export is None else export(request_id)

    def generate_transferred(self, task: RolloutTask, version: int,
                             callback: Callable[[GenerationResult], None],
                             record: dict, resume_from: int,
                             stream_cb: Optional[Callable] = None) -> int:
        """Submit a migrated continuation together with its exported KV
        record as ONE command: the loop imports the pages and queues the
        request as a resume — or, if the import is rejected at processing
        time (pool pressure, quant mismatch), degrades it in place to a
        plain re-prefill of ``task`` (which carries the full concatenated
        prompt).  Either way the request is admitted exactly once and can
        never hang on pages that failed to land."""
        if self._slo is not None:
            stamp_deadline(task, self._slo.clock())
        req = GenerationRequest(request_id=task.task_id, task=task,
                                version_started=version, callback=callback,
                                resume_from=resume_from, stream_cb=stream_cb)
        # charged as a resume (no prefill); _do_transfer adds the prompt
        # back if the import fails and the request degrades to re-prefill.
        self._load_add(req.request_id, task.max_new_tokens)
        if self._thread is None or not self._thread.is_alive():
            self._do_transfer(req, record)
        else:
            self._commands.put(("TRANSFER", (req, record)))
        return req.request_id

    def _do_transfer(self, req: GenerationRequest, record: dict) -> None:
        imp = getattr(self.engine, "import_retained", None)
        if imp is None or not imp(req.resume_from, record):
            # degrade: the task already carries the concatenated prompt —
            # admit it as a plain re-prefill and re-charge the prompt work.
            req.resume_from = None
            with self._load_lock:
                extra = len(req.task.prompt_tokens)
                self._load_by_rid[req.request_id] = \
                    self._load_by_rid.get(req.request_id, 0) + extra
                self._outstanding_tokens += extra
        self._enqueue_pending(req)

    def export_prefix(self, tokens, deliver: Callable[[Optional[dict]],
                                                      None]) -> None:
        """Snapshot this replica's cached prefix pages for ``tokens`` and
        hand the record to ``deliver`` (which typically forwards it to
        another proxy's ``import_prefix``).  Runs on the loop thread; fires
        inline when the loop isn't started (lockstep fleets)."""
        if self._thread is None or not self._thread.is_alive():
            self._do_export_prefix(tokens, deliver)
        else:
            self._commands.put(("EXPORT_PREFIX", (tokens, deliver)))

    def _do_export_prefix(self, tokens, deliver) -> None:
        export = getattr(self.engine, "export_prefix", None)
        deliver(None if export is None else export(tokens))

    def import_prefix(self, record: dict) -> None:
        """Admit a pulled prefix record into this replica's radix cache
        (best-effort: the engine skips it under page pressure or across a
        weight-epoch boundary)."""
        if self._thread is None or not self._thread.is_alive():
            imp = getattr(self.engine, "import_prefix", None)
            if imp is not None:
                imp(record)
        else:
            self._commands.put(("IMPORT_PREFIX", record))

    @property
    def pages_transferred(self) -> int:
        eng = self.engine
        return int(getattr(eng, "pages_transferred_in", 0)
                   + getattr(eng, "pages_transferred_out", 0))

    @property
    def transfer_bytes(self) -> int:
        eng = self.engine
        return int(getattr(eng, "transfer_bytes_in", 0)
                   + getattr(eng, "transfer_bytes_out", 0))

    def abort(self, request_id: int, retain: bool = False) -> None:
        self._commands.put(("ABORT", (request_id, retain)))

    def abort_stale(self, min_version: int, retain: bool = False) -> None:
        """ABORT every in-flight request initiated before min_version.

        ``retain=True`` (engines with ``supports_retain``) parks each
        victim's KV pages so the subsequent resume skips the prefix."""
        self._commands.put(("ABORT_STALE", (min_version, retain)))

    def release_retained(self, request_id: int) -> None:
        """Free the KV pages of a retained request that won't be resumed."""
        self._commands.put(("RELEASE", request_id))

    def shed_lowest(self, below_priority: int) -> None:
        """Evict the newest queued request of the lowest priority class
        strictly below ``below_priority`` (its callback fires with
        ``Rejected(reason="shed")``).  Routers use this to make room at the
        fleet-wide total bound for higher-priority arrivals."""
        self._commands.put(("SHED", below_priority))

    # ----------------------------------------------------- admission control
    def _admit_submission(self, tasks: List[RolloutTask], version: int,
                          callback: Callable) -> bool:
        """Admission control at the submit boundary (caller thread).  Stamps
        absolute deadlines, then rejects the submission outright — callback
        fired immediately with a typed ``Rejected`` — if its deadline is
        already past or the pending queue bounds leave no room.  Queue depth
        is read as a snapshot, so bounds are approximate under concurrent
        submitters (a few over, never silent unbounded growth)."""
        slo = self._slo
        if slo is None:
            return True
        now = slo.clock()
        for t in tasks:
            stamp_deadline(t, now)
        t0 = tasks[0]
        priority = getattr(t0, "priority", PRIORITY_NORMAL)
        reason = None
        deadline_at = t0.meta.get("deadline_at")
        if slo.shed_expired and deadline_at is not None and now >= deadline_at:
            reason = "expired"
        if reason is None and slo.queue_limit_per_class is not None:
            depth = self.pending_by_priority.get(priority, 0)
            if depth + len(tasks) > slo.queue_limit_per_class:
                reason = "queue_full"
        if reason is None and slo.queue_limit_total is not None:
            if self.num_pending + len(tasks) > slo.queue_limit_total:
                lower = self.pending_by_priority
                if any(c > 0 for p, c in lower.items() if p < priority):
                    # outranked work is queued: shed it (async command)
                    # instead of bouncing the higher-priority arrival.
                    for _ in range(len(tasks)):
                        self.shed_lowest(priority)
                else:
                    reason = "queue_full"
        if reason is None:
            return True
        for t in tasks:
            self.rejected += 1
            if reason == "expired":
                self.deadline_misses += 1
            callback(Rejected(request_id=t.task_id, task=t, tokens=None,
                              logprobs=None, version_started=version,
                              aborted=True, partial=True, reason=reason))
        return False

    def suspend(self) -> None:
        """Pause the loop after the current engine step (weight-sync phase 1)."""
        self.suspend_count += 1
        self._resumed.clear()
        self._suspended.wait()

    def update_weights(self, params) -> None:
        """Blocking weight-sync phase 2 (call between suspend and resume)."""
        assert self._suspended.is_set(), "update_weights requires suspend()"
        self.engine.update_weights(params)

    def update_weights_async(self, params) -> NotifyingEvent:
        """NON-BLOCKING weight sync: stage a parameter swap that the proxy
        loop applies between engine steps — rollout keeps advancing; there
        is no suspend barrier.  Returns an event set once the engine holds
        the new weights (a ``NotifyingEvent``: composite fleet waiters
        subscribe instead of polling).  (Do not mix with a concurrent
        ``suspend()``: a parked loop processes no commands.)"""
        done = NotifyingEvent()
        if self._thread is None or not self._thread.is_alive():
            # loop not running (tests, pre-start staging): apply inline
            self.engine.update_weights(params)
            self.staged_weight_updates += 1
            done.set()
            return done
        self._commands.put(("UPDATE", (params, done)))
        return done

    def resume(self) -> None:
        """Weight-sync phase 3."""
        self._suspended.clear()
        self._resumed.set()

    def healthy(self) -> bool:
        """Heartbeat/health-probe hook for fleet routers: True while the
        proxy can still make progress (loop thread alive, or not started —
        lockstep drivers step un-started proxies by hand)."""
        if self._stop.is_set():
            return False
        t = self._thread
        return t is None or t.is_alive()

    def stop(self) -> None:
        self._stop.set()
        self._resumed.set()
        if self._thread is not None:
            self._thread.join(timeout=30)

    # ------------------------------------------------------------ the loop
    def start(self) -> "LLMProxy":
        self._thread = threading.Thread(target=self.run_loop, name=self.name,
                                        daemon=True)
        self._thread.start()
        return self

    def run_loop(self) -> None:
        while not self._stop.is_set():
            if not self._resumed.is_set():
                # suspend handshake: acknowledge, park until resume()
                self._suspended.set()
                self._resumed.wait()
                self._suspended.clear()
            if self._stop.is_set():
                break
            if not self.step_once():
                time.sleep(self._idle_sleep)

    def step_once(self) -> bool:
        """One proxy iteration: drain commands, admit, and — if anything is
        active — run one engine step and dispatch completions.  ``run_loop``
        is exactly this under the suspend handshake; calling it directly
        (proxy thread NOT started) drives the proxy deterministically, which
        is what lockstep fleet benchmarks and parity tests need.  Returns
        True iff an engine step ran."""
        self._process_commands()
        if self._slo is not None:
            self._watchdog_tick()
            self._maybe_preempt()
        self._admit_pending()
        if not self._active:
            return False
        finished = self.engine.step()
        self.steps_executed += 1
        for rid, tokens, logprobs in finished:
            req = self._active.pop(rid, None)
            if req is None:
                continue
            if req.stream_cb is not None:
                self._num_streaming -= 1
                # flush the final decode step's tokens — the request is
                # no longer active, so _publish_streams won't see it.
                if len(tokens) > req.streamed:
                    req.stream_cb(list(tokens[req.streamed:]))
                    req.streamed = len(tokens)
            self.requests_completed += 1
            self._load_drop(rid)
            req.callback(GenerationResult(
                request_id=rid, task=req.task, tokens=tokens,
                logprobs=logprobs, version_started=req.version_started))
        if self._num_streaming > 0:
            self._publish_streams()
        return True

    def _publish_streams(self) -> None:
        """Push NEWLY decoded tokens (a delta per call) of stream-subscribed
        active requests — engines expose ``peek_tokens(rid, start)``;
        without it, subscribers only see per-leg chunks from the client
        layer.  The per-request cursor keeps this O(new tokens), not
        O(decoded), per step."""
        peek = getattr(self.engine, "peek_tokens", None)
        if peek is None:
            return
        for rid, req in list(self._active.items()):
            if req.stream_cb is None:
                continue
            delta = peek(rid, req.streamed)
            if delta:
                req.streamed += len(delta)
                req.stream_cb(delta)

    def _process_commands(self) -> None:
        while True:
            try:
                op, arg = self._commands.get_nowait()
            except queue.Empty:
                return
            if op == "ADD":
                self._enqueue_pending(arg)
            elif op == "ADD_GROUP":
                self._enqueue_pending(arg)
            elif op == "SHED":
                self._do_shed(arg)
            elif op == "ABORT":
                rid, retain = arg
                self._do_abort(rid, retain)
            elif op == "ABORT_STALE":
                min_version, retain = arg
                stale = [rid for rid, r in self._active.items()
                         if r.version_started < min_version]
                for rid in stale:
                    self._do_abort(rid, retain)
                # pending (not yet started) requests simply re-tag: they will
                # start under the current weights.
                for entry in self._pending:
                    for r in self._entry_requests(entry):
                        r.version_started = max(r.version_started, min_version)
            elif op == "RELEASE":
                release = getattr(self.engine, "release_retained", None)
                if release is not None:
                    release(arg)
            elif op == "TRANSFER":
                req, record = arg
                self._do_transfer(req, record)
            elif op == "EXPORT_PREFIX":
                tokens, deliver = arg
                self._do_export_prefix(tokens, deliver)
            elif op == "IMPORT_PREFIX":
                imp = getattr(self.engine, "import_prefix", None)
                if imp is not None:
                    imp(arg)
            elif op == "UPDATE":
                params, done = arg
                self.engine.update_weights(params)
                self.staged_weight_updates += 1
                done.set()

    def _do_abort(self, request_id: int, retain: bool = False) -> None:
        req = self._active.pop(request_id, None)
        if req is not None:
            if req.stream_cb is not None:
                self._num_streaming -= 1
            retain = retain and getattr(self.engine, "supports_retain", False)
            if retain:
                partial = self.engine.abort(request_id, retain=True)
            else:
                partial = self.engine.abort(request_id)
            self.requests_aborted += 1
            self._load_drop(request_id)
            req.callback(GenerationResult(
                request_id=request_id, task=req.task,
                tokens=getattr(partial, "tokens", None),
                logprobs=getattr(partial, "logprobs", None),
                version_started=req.version_started,
                aborted=True, partial=True,
                resumable=getattr(partial, "resumable", False)))
        else:
            # not yet admitted: drop from pending — free the retained pages
            # of a dropped resume request (nobody else will) and still fire
            # the callback with an empty aborted result so handle-layer
            # consumers always resolve.
            release = getattr(self.engine, "release_retained", None)
            for r in self._take_pending(request_id):
                if r.resume_from is not None and release is not None:
                    release(r.resume_from)
                self.requests_aborted += 1
                self._load_drop(r.request_id)
                r.callback(GenerationResult(
                    request_id=r.request_id, task=r.task, tokens=None,
                    logprobs=None, version_started=r.version_started,
                    aborted=True, partial=True))

    def _take_pending(self, request_id: int) -> List[GenerationRequest]:
        """Remove (and return) the pending request with this id, unwrapping
        it from a pending group if needed (the group's other members stay
        queued)."""
        taken: List[GenerationRequest] = []
        kept: collections.deque = collections.deque()
        for entry in self._pending:
            if isinstance(entry, _PendingGroup):
                hit = [r for r in entry.requests if r.request_id == request_id]
                entry.requests = [r for r in entry.requests
                                  if r.request_id != request_id]
                taken.extend(hit)
                if entry.requests:
                    kept.append(entry)
            elif entry.request_id == request_id:
                taken.append(entry)
            else:
                kept.append(entry)
        self._pending = kept
        return taken

    @staticmethod
    def _entry_requests(entry) -> List[GenerationRequest]:
        return entry.requests if isinstance(entry, _PendingGroup) else [entry]

    # --------------------------------------------------- SLO: priority queue
    @classmethod
    def _entry_priority(cls, entry) -> int:
        reqs = cls._entry_requests(entry)
        if not reqs:
            return PRIORITY_NORMAL
        return max(getattr(r.task, "priority", PRIORITY_NORMAL) for r in reqs)

    def _enqueue_pending(self, entry) -> None:
        """Insert by priority class, FIFO within a class: an entry lands
        after every queued entry of >= priority.  With uniform priorities
        (the default) this degenerates to a plain append, so non-SLO
        behavior is unchanged byte-for-byte."""
        priority = self._entry_priority(entry)
        if not self._pending or self._entry_priority(self._pending[-1]) >= priority:
            self._pending.append(entry)
            return
        items = list(self._pending)
        idx = next(i for i, e in enumerate(items)
                   if self._entry_priority(e) < priority)
        items.insert(idx, entry)
        self._pending = collections.deque(items)

    def _do_shed(self, below_priority: int) -> None:
        """Evict the newest pending entry of the lowest class < below."""
        cands = [(self._entry_priority(e), i)
                 for i, e in enumerate(self._pending)
                 if self._entry_priority(e) < below_priority]
        if not cands:
            return
        lowest = min(p for p, _ in cands)
        idx = max(i for p, i in cands if p == lowest)
        items = list(self._pending)
        entry = items.pop(idx)
        self._pending = collections.deque(items)
        for r in self._entry_requests(entry):
            self._reject_queued(r, "shed")

    def _reject_queued(self, req: GenerationRequest, reason: str) -> None:
        """Resolve an already-queued request with a typed Rejected (shed or
        expired-in-queue).  Retained pages of a rejected continuation are
        freed — its partial tokens are final."""
        release = getattr(self.engine, "release_retained", None)
        if req.resume_from is not None and release is not None:
            release(req.resume_from)
        self._load_drop(req.request_id)
        self.rejected += 1
        if reason == "expired":
            self.deadline_misses += 1
        req.callback(Rejected(request_id=req.request_id, task=req.task,
                              tokens=None, logprobs=None,
                              version_started=req.version_started,
                              aborted=True, partial=True, reason=reason))

    # ------------------------------------------------------- SLO: preemption
    def _decoded(self, request_id: int) -> int:
        """Tokens decoded so far in the CURRENT leg of an active request."""
        num_decoded = getattr(self.engine, "num_decoded", None)
        if num_decoded is not None:
            return int(num_decoded(request_id))
        peek = getattr(self.engine, "peek_tokens", None)
        if peek is not None:
            return len(peek(request_id, 0))
        return 0

    def _maybe_preempt(self) -> None:
        """If the head of the queue outranks active work and no slot is
        free, abort-with-retain the lowest-priority active request(s): the
        victim's pages park in the engine, its continuation re-queues at
        its own priority, and the high-priority head admits immediately.
        Zero re-prefill on resume — preemption is the abort/resume
        machinery pointed at priority inversion instead of staleness."""
        slo = self._slo
        if (slo is None or not slo.preempt or not self._pending
                or not getattr(self.engine, "supports_retain", False)):
            return
        entry = self._pending[0]
        reqs = self._entry_requests(entry)
        if not reqs:
            return
        head_priority = self._entry_priority(entry)
        need = len(reqs) - self.engine.num_free_slots
        if need <= 0:
            return
        # Preemption frees SLOTS, not pages: victims keep their retained
        # pages until resumed.  Only preempt when the page pool can cover
        # the head anyway (checked for one candidate — a group head that
        # still doesn't fit simply stays queued, no harm done).
        t0 = reqs[0].task
        cover = getattr(self.engine, "can_cover_pages", None)
        if cover is not None and not cover(len(t0.prompt_tokens),
                                           t0.max_new_tokens):
            return
        victims = sorted(
            ((rid, r) for rid, r in self._active.items()
             if getattr(r.task, "priority", PRIORITY_NORMAL) < head_priority),
            key=lambda kv: (getattr(kv[1].task, "priority", PRIORITY_NORMAL),
                            -(kv[1].task.max_new_tokens - self._decoded(kv[0]))))
        for rid, _ in victims[:need]:
            self.preemptions += 1
            self._do_abort(rid, retain=True)

    # --------------------------------------------------------- SLO: watchdog
    def _watchdog_tick(self) -> None:
        """Once per step: shed expired queued work, force-resolve active
        work past deadline or stalled, and defer detected long-tails."""
        slo = self._slo
        now = slo.clock()
        if slo.shed_expired and self._pending:
            expired = [r.request_id
                       for e in self._pending for r in self._entry_requests(e)
                       if r.task.meta.get("deadline_at") is not None
                       and now >= r.task.meta["deadline_at"]]
            for rid in expired:
                for r in self._take_pending(rid):
                    self._reject_queued(r, "expired")
        if not self._active:
            return
        if slo.enforce_deadlines:
            for rid, req in list(self._active.items()):
                deadline_at = req.task.meta.get("deadline_at")
                if deadline_at is not None and now >= deadline_at:
                    self._do_timeout(rid, stall=False)
        if slo.stall_timeout_s is None and slo.defer_after_tokens is None:
            return
        for rid, req in list(self._active.items()):
            if rid not in self._active:
                continue
            decoded = self._decoded(rid)
            # != not >: a resumed leg's count restarts below the old one.
            progressed = decoded != req.decoded_seen
            if progressed:
                req.decoded_seen = decoded
                req.last_progress = now
            if (slo.stall_timeout_s is not None and not progressed
                    and now - req.last_progress >= slo.stall_timeout_s):
                self._do_timeout(rid, stall=True)
                continue
            if (slo.defer_after_tokens is not None
                    and self._pending
                    and self.engine.num_free_slots <= 0
                    and not req.task.meta.get("slo_deferred")
                    and decoded >= slo.defer_after_tokens
                    and req.task.max_new_tokens - decoded >= slo.defer_min_remaining
                    and getattr(req.task, "priority", PRIORITY_NORMAL)
                    <= self._entry_priority(self._pending[0])
                    and getattr(self.engine, "supports_retain", False)):
                # Likely long-tail: park it (pages retained, resume later at
                # zero re-prefill) so queued peers aren't stuck behind it.
                # Tag the lineage so a rollout is deferred at most once.
                req.task.meta["slo_deferred"] = True
                self.long_tail_defers += 1
                self._do_abort(rid, retain=True)

    def _do_timeout(self, request_id: int, *, stall: bool) -> None:
        """Exactly-once forced resolution of an active request: pop it,
        release its pages (plain abort — nothing to resume), and fire the
        callback with the partial tokens and ``timed_out=True``.  The
        client layer sees timed_out and resolves WITHOUT a continuation."""
        req = self._active.pop(request_id, None)
        if req is None:
            return
        if req.stream_cb is not None:
            self._num_streaming -= 1
        partial = self.engine.abort(request_id)
        self.requests_aborted += 1
        if stall:
            self.stall_aborts += 1
        else:
            self.deadline_misses += 1
        self._load_drop(request_id)
        req.callback(GenerationResult(
            request_id=request_id, task=req.task,
            tokens=getattr(partial, "tokens", None),
            logprobs=getattr(partial, "logprobs", None),
            version_started=req.version_started,
            aborted=True, partial=True, resumable=False, timed_out=True))

    def _try_admit(self, req: GenerationRequest) -> bool:
        """Admit one request if the engine can take it right now."""
        if req.resume_from is not None:
            can_resume = getattr(self.engine, "can_resume", None)
            if can_resume is not None and not can_resume(
                    req.resume_from, req.task.max_new_tokens):
                return False
            self.engine.resume_request(req.resume_from, req.request_id,
                                       req.task.max_new_tokens)
            return True
        can_admit = getattr(self.engine, "can_admit", None)
        if can_admit is not None and not can_admit(
                len(req.task.prompt_tokens), req.task.max_new_tokens):
            return False
        self.engine.add_request(req.request_id, req.task.prompt_tokens,
                                req.task.max_new_tokens)
        return True

    def _try_admit_group(self, grp: _PendingGroup):
        """All-or-nothing group admission.  Returns True (admitted), False
        (blocked — not enough slots/pages right now) or "expand" (the engine
        cannot take this group as a unit; split into singles)."""
        reqs = grp.requests
        if len(reqs) == 1:
            return True if self._try_admit(reqs[0]) else False
        eng = self.engine
        t = reqs[0].task
        if (not getattr(eng, "supports_group", False)
                or len(reqs) > getattr(eng, "num_slots", len(reqs))):
            return "expand"
        fits = getattr(eng, "group_fits_pool", None)
        if fits is not None and not fits(len(t.prompt_tokens), len(reqs),
                                         t.max_new_tokens):
            # the group can NEVER be admitted as a unit (pool too small):
            # expand instead of blocking the queue head forever.
            return "expand"
        if eng.num_free_slots < len(reqs):
            # All-or-nothing admission convoys here while the previous
            # group's lanes drain at different speeds.  Deliberate: letting
            # singles backfill would admit the next group's candidates
            # WITHOUT sharing, silently reverting the COW win.  Size
            # num_slots >= 2*G (the default settings do) so two groups
            # interleave and cover each other's drain.
            return False
        can = getattr(eng, "can_admit_group", None)
        if can is not None and not can(len(t.prompt_tokens), len(reqs),
                                       t.max_new_tokens):
            return False
        eng.submit_group([r.request_id for r in reqs], t.prompt_tokens,
                         t.max_new_tokens)
        return True

    def _activate(self, req: GenerationRequest) -> None:
        self._active[req.request_id] = req
        # record the engine's numeric config on the task at admission time:
        # samples produced from this request carry the quantization mode
        # their tokens were actually generated under, so buffer consumers /
        # StepStats can report mixed-precision batches after a mid-run
        # set_quant_mode change (stamped per leg — the LAST engine to
        # touch a resumed request wins, which is the engine that decoded
        # its reported tokens).
        task = req.task
        if task is not None and isinstance(getattr(task, "meta", None), dict):
            task.meta["quant_mode"] = self.quant_mode
            kv = getattr(self.engine, "kv_quant", "off")
            if kv != "off":
                task.meta["kv_quant"] = kv
        if self._slo is not None:
            req.last_progress = self._slo.clock()
        if req.stream_cb is not None:
            self._num_streaming += 1

    def _admit_pending(self) -> None:
        while self._pending and self.engine.num_free_slots > 0:
            entry = self._pending[0]
            if isinstance(entry, _PendingGroup):
                verdict = self._try_admit_group(entry)
                if verdict == "expand":
                    # engine can't take the group as a unit: requeue the
                    # members as ordinary head-of-queue requests.
                    self._pending.popleft()
                    self._pending.extendleft(reversed(entry.requests))
                    continue
                if verdict:
                    self._pending.popleft()
                    for r in entry.requests:
                        self._activate(r)
                    continue
            elif self._try_admit(entry):
                self._pending.popleft()
                self._activate(entry)
                continue
            # Head is blocked (e.g. page-starved).  Resume requests further
            # back MUST be allowed to bypass it: they re-attach pages that
            # are already allocated and are often the only way pages ever
            # free up again — strict FIFO here would deadlock the pool.
            admitted_any = False
            for e in list(self._pending):
                if self.engine.num_free_slots <= 0:
                    break
                if (isinstance(e, GenerationRequest) and e.resume_from is not None
                        and self._try_admit(e)):
                    self._pending.remove(e)
                    self._activate(e)
                    admitted_any = True
            if not admitted_any:
                break

    # ------------------------------------------------------------- metrics
    @property
    def num_active(self) -> int:
        return len(self._active)

    @property
    def num_pending(self) -> int:
        # metrics readers run off-thread while the loop mutates _pending;
        # retry the lock-free snapshot instead of serializing the hot path
        # (mutation windows are a few appends/pops — retries are rare).
        while True:
            try:
                return sum(len(self._entry_requests(e))
                           for e in tuple(self._pending))
            except RuntimeError:
                continue

    @property
    def pending_by_priority(self) -> Dict[int, int]:
        """Queued request count per priority class (lock-free snapshot,
        same idiom as num_pending)."""
        while True:
            try:
                depth: Dict[int, int] = {}
                for e in tuple(self._pending):
                    for r in self._entry_requests(e):
                        priority = getattr(r.task, "priority", PRIORITY_NORMAL)
                        depth[priority] = depth.get(priority, 0) + 1
                return depth
            except RuntimeError:
                continue

    @property
    def oldest_active_version(self) -> Optional[int]:
        """Policy version of the stalest in-flight request (None when
        idle) — per-replica staleness for fleet dashboards."""
        while True:
            try:
                versions = [r.version_started
                            for r in list(self._active.values())]
                break
            except RuntimeError:     # loop thread resized _active mid-copy
                continue
        return min(versions) if versions else None

    @property
    def quant_mode(self) -> str:
        """The engine's weight-quantization mode ("off" when unsupported)."""
        return getattr(self.engine, "quant_mode", "off")

    @property
    def cache_hit_tokens(self) -> int:
        """Prefill tokens the engine skipped via automatic prefix caching."""
        return getattr(self.engine, "cache_hit_tokens", 0)

    @property
    def cache_stats(self) -> Dict[str, int]:
        """Prefix-cache hit/miss counters (zeros on engines without one)."""
        eng = self.engine
        lookups = getattr(eng, "cache_lookups", 0)
        hits = getattr(eng, "cache_hits", 0)
        return {
            "lookups": lookups,
            "hits": hits,
            "misses": lookups - hits,
            "extension_hits": getattr(eng, "cache_ext_hits", 0),
            "hit_tokens": getattr(eng, "cache_hit_tokens", 0),
            "evicted_pages": getattr(eng, "cache_evicted_pages", 0),
            "pages_held": getattr(eng, "cache_pages_held", 0),
        }
