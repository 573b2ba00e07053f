"""Queue scheduling + prompt replication + dynamic filtering (§5.1).

Two entry points, both thin consumers of the handle-based RolloutClient
(`repro_torch.core.rollout_client`) — abort→resume continuation, token stitching
and budget clamping live in the client layer, never here:

* ``collect_rollout`` — one synchronous rollout step under queue scheduling:
  stream group completions, reward immediately, filter, top up redundant
  prompts, cancel leftovers once the batch qualifies.  (Sync-ROLL mode.)
* ``RolloutProducer`` — the continuous producer thread for the asynchronous
  architecture: keeps the SampleBuffer saturated subject to the freshness
  capacity (1+alpha)B, assembling GRPO groups before publishing.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.core.locks import new_condition
from repro_torch.core.rollout_client import (GenerationHandle, GroupHandle,
                                             RolloutClient)
from repro_torch.core.sample_buffer import SampleBuffer
from repro_torch.core.types import (PRIORITY_NORMAL, GenerationResult, Rejected,
                                    RolloutTask, Sample, next_uid)


def expand_tasks(prompt_id: int, prompt_tokens, group_size: int,
                 max_new_tokens: int, *, replicate: bool,
                 priority: int = PRIORITY_NORMAL,
                 deadline_ms: Optional[float] = None) -> List[RolloutTask]:
    """Prompt replication (`num_return_sequences_expand`): one prompt with G
    candidates becomes G independently schedulable tasks; without it the
    whole group is a single task (one submission decoding G sequences —
    realized by the client/proxy as a group expansion, COW-shared where the
    engine supports it)."""
    gid = next_uid()
    if replicate:
        return [RolloutTask(task_id=next_uid(), prompt_id=prompt_id,
                            replica_idx=i, prompt_tokens=prompt_tokens,
                            max_new_tokens=max_new_tokens, group_id=gid,
                            priority=priority, deadline_ms=deadline_ms)
                for i in range(group_size)]
    return [RolloutTask(task_id=next_uid(), prompt_id=prompt_id, replica_idx=0,
                        prompt_tokens=prompt_tokens,
                        max_new_tokens=max_new_tokens, group_id=gid,
                        meta={"num_return_sequences": group_size},
                        priority=priority, deadline_ms=deadline_ms)]


def _make_sample(result: GenerationResult) -> Sample:
    """A finished handle result (already stitched + clamped) as a Sample."""
    task = result.task
    meta = dict(task.meta)
    if result.legs:
        meta["legs"] = list(result.legs)   # per-leg (version, ntokens) tags
    if getattr(result, "timed_out", False):
        meta["timed_out"] = True           # partial sample: deadline/stall hit
    if isinstance(result, Rejected):
        meta["rejected"] = result.reason
    return Sample(
        sample_id=next_uid(), prompt_id=task.prompt_id,
        replica_idx=task.replica_idx,
        prompt_tokens=np.asarray(task.prompt_tokens, np.int32),
        response_tokens=np.asarray(result.tokens, np.int32),
        logprobs=np.asarray(result.logprobs, np.float32),
        version_started=result.version_started, group_id=task.group_id,
        meta=meta)


class _GroupCollector:
    """Assemble per-prompt groups, reward on completion, apply the filter.

    Consumers wait on the collector's condition — no polling."""

    def __init__(self, group_size: int, reward_fn: Callable,
                 filter_fn: Optional[Callable] = None):
        self.group_size = group_size
        self.reward_fn = reward_fn
        self.filter_fn = filter_fn
        self._cond = new_condition(name="_GroupCollector._cond")
        self._partial: Dict[int, List[Sample]] = \
            collections.defaultdict(list)  # guarded-by: _cond
        self.done_groups: "collections.deque[List[Sample]]" = \
            collections.deque()  # guarded-by: _cond
        self.filtered_groups = 0  # guarded-by: _cond

    def add(self, result: GenerationResult) -> None:
        """Handle done-callback: samples carry result.version_started."""
        if result.aborted:
            with self._cond:
                self._cond.notify_all()
            return
        sample = _make_sample(result)
        # reward immediately on completion (overlaps with ongoing generation)
        sample.reward = float(self.reward_fn(sample))
        sample.is_positive = sample.reward > 0
        with self._cond:
            group = self._partial[result.task.group_id]
            group.append(sample)
            if len(group) == self.group_size:
                del self._partial[result.task.group_id]
                if self.filter_fn is not None and not self.filter_fn(group):
                    self.filtered_groups += 1
                else:
                    self.done_groups.append(group)
            self._cond.notify_all()

    def wait(self, timeout: float) -> None:
        """Park until the next completion/filter event (or timeout)."""
        with self._cond:
            if self.done_groups or self.filtered_groups:
                return
            # concheck: disable=cond-wait-loop — single timed park by design:
            # the caller (collect_rollout) re-evaluates its own predicate
            # each iteration; a spurious wakeup just re-enters the loop.
            self._cond.wait(timeout)

    def take_filtered(self) -> int:
        with self._cond:
            n, self.filtered_groups = self.filtered_groups, 0
            return n

    def pop_groups(self, max_samples: int) -> List[Sample]:
        out: List[Sample] = []
        with self._cond:
            while self.done_groups and len(out) < max_samples:
                out.extend(self.done_groups.popleft())
        return out

    def has_ready(self) -> bool:
        with self._cond:
            return bool(self.done_groups)


def variance_filter(group: List[Sample]) -> bool:
    """Dynamic-filtering default: drop zero intra-group reward variance."""
    rewards = [s.reward for s in group]
    return float(np.var(rewards)) > 0.0


def collect_rollout(
    proxy,
    prompts: Iterator[tuple[int, np.ndarray]],
    *,
    num_groups: int,
    group_size: int,
    max_new_tokens: int,
    reward_fn: Callable[[Sample], float],
    replicate: bool = True,
    filter_fn: Optional[Callable] = None,
    max_additional_running_prompts: int = 0,
    version: int = 0,
    timeout: float = 300.0,
    group_submit: bool = True,
    priority: int = PRIORITY_NORMAL,
    deadline_ms: Optional[float] = None,
) -> List[Sample]:
    """One rollout step (queue scheduling): returns num_groups qualifying
    groups, flattened.  Extra in-flight generations are cancelled on return.

    ``proxy`` may be a raw ``LLMProxy`` (wrapped in a RolloutClient
    internally) or an existing ``RolloutClient``.  With ``group_submit``
    (default) the G replicated candidates of a prompt go down as ONE group
    submission (COW prefix sharing on engines that support it); with
    ``replicate=False`` the single group task is expanded by the client, so
    both configurations yield exactly G samples per prompt.

    A finite prompt stream may exhaust mid-step (e.g. during filtered-group
    top-up at the end of an epoch): the step then returns the qualifying
    groups it could assemble (possibly fewer than ``num_groups``) instead of
    raising or spinning until the timeout."""
    client = RolloutClient.ensure(proxy, version_fn=lambda: version)
    collector = _GroupCollector(group_size, reward_fn, filter_fn)
    handles: List[GenerationHandle] = []
    exhausted = False

    def submit_one_prompt() -> bool:
        nonlocal exhausted
        try:
            pid, toks = next(prompts)
        except StopIteration:
            # a bare StopIteration would escape the caller's generator frames
            # as RuntimeError (PEP 479) — degrade to "no more prompts".
            exhausted = True
            return False
        tasks = expand_tasks(pid, toks, group_size, max_new_tokens,
                             replicate=replicate, priority=priority,
                             deadline_ms=deadline_ms)
        if replicate and group_submit and len(tasks) > 1:
            new = client.submit_group(tasks, version=version).handles
        else:
            new = []
            for task in tasks:
                h = client.submit(task, version=version)
                new.extend(h.handles if isinstance(h, GroupHandle) else [h])
        for h in new:
            h.add_done_callback(collector.add)
        handles.extend(new)
        return True

    for _ in range(num_groups + max_additional_running_prompts):
        if not submit_one_prompt():
            break

    want = num_groups * group_size
    out: List[Sample] = []
    deadline = time.monotonic() + timeout
    try:
        while len(out) < want:
            out.extend(collector.pop_groups(want - len(out)))
            if len(out) >= want:
                break
            # top up for filtered-out groups so the step always completes
            for _ in range(collector.take_filtered()):
                if not submit_one_prompt():
                    break
            if exhausted and all(h.done() for h in handles) \
                    and not collector.has_ready():
                break      # nothing in flight, no prompts left: partial
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError("collect_rollout timed out")
            collector.wait(min(remaining, 1.0))
        out.extend(collector.pop_groups(want - len(out)))
    finally:
        # cancel whatever is still running — on the normal exit the step
        # has what it needs; on the timeout exit the leftovers must not
        # keep decoding (and rewarding into an abandoned collector) on a
        # shared proxy.
        for h in handles:
            if not h.done():
                h.abort()
    return out


class _GroupAssembler:
    """Prompt-aligned group assembly over a (pid, tokens) stream.

    Owns the two pieces of cross-group state the producer used to thread by
    hand: the *held prompt* (a pull that crossed a prompt boundary during
    partial-group assembly seeds the next group, keeping grouping aligned
    with the stream) and the *group uid* (consecutive pulls of one prompt
    share a fresh ``next_uid()`` until group_size is reached, so a
    capacity-pinch partial flush stays one logical group while a prompt
    repeated in a later epoch never collides with its earlier group)."""

    def __init__(self, prompts: Iterator[tuple], group_size: int):
        self.prompts = prompts
        self.group_size = group_size
        self.held: Optional[tuple] = None
        self._uid: Optional[int] = None
        self._pid: Optional[int] = None
        self._count = 0

    def pull(self, group_pid: Optional[int]) -> Tuple[str, Optional[int], Optional[np.ndarray]]:
        """Next prompt for a group anchored at ``group_pid``: ("ok", pid,
        toks), ("boundary", ...) when the stream crossed into the next
        prompt (held back to seed the next group), or ("exhausted", ...)."""
        if self.held is not None:
            pid, toks = self.held
            self.held = None
        else:
            try:
                pid, toks = next(self.prompts)
            except StopIteration:
                return "exhausted", None, None
        if group_pid is not None and pid != group_pid:
            self.held = (pid, toks)
            return "boundary", None, None
        return "ok", pid, toks

    def group_id(self, pid: int) -> int:
        if (self._uid is None or pid != self._pid
                or self._count >= self.group_size):
            self._uid = next_uid()
            self._pid = pid
            self._count = 0
        self._count += 1
        return self._uid


class RolloutProducer(threading.Thread):
    """Continuous RLVR producer for the async architecture — a thin consumer
    of RolloutClient handles.

    Each candidate generation claims a freshness slot from the buffer before
    starting (begin_generation), guaranteeing occupancy <= (1+alpha)B.
    Completed handles are rewarded and published sample-by-sample; an
    in-flight generation interrupted by a weight sync is transparently
    resumed BY THE CLIENT under the new version (the producer only ever
    sees final results)."""

    def __init__(self, proxy, buffer: SampleBuffer,
                 prompts: Iterator[tuple[int, np.ndarray]], *,
                 group_size: int, max_new_tokens: int,
                 reward_fn: Callable[[Sample], float],
                 replicate: bool = True, name: str = "rollout_producer",
                 priority: int = PRIORITY_NORMAL,
                 deadline_ms: Optional[float] = None):
        super().__init__(name=name, daemon=True)
        self.buffer = buffer
        self.group_size = group_size
        self.max_new_tokens = max_new_tokens
        self.reward_fn = reward_fn
        self.replicate = replicate
        self.priority = priority
        self.deadline_ms = deadline_ms
        # NB: not named _stop — threading.Thread owns that attribute,
        # and join() calls it as a method
        self._halt = threading.Event()
        self._owns_client = not isinstance(proxy, RolloutClient)
        self.client = RolloutClient.ensure(
            proxy, version_fn=lambda: self.buffer.version,
            resume_gate=lambda: not (self.buffer.closed
                                     or self._halt.is_set()))
        self.proxy = self.client.proxy
        self._groups = _GroupAssembler(prompts, group_size)

    def stop(self) -> None:
        self._halt.set()
        if self._owns_client:
            # a caller-provided (possibly shared) client is left open —
            # other consumers may still rely on its continuations.
            self.client.close()

    def _publish(self, result: GenerationResult) -> None:
        """Handle done-callback: reward + publish, or release the freshness
        slot of a cancelled/shutdown generation."""
        if result.aborted:
            self.buffer.reclaim(1)
            return
        sample = _make_sample(result)
        sample.reward = float(self.reward_fn(sample))
        sample.is_positive = sample.reward > 0
        try:
            self.buffer.put(sample)
        except Exception:
            self.buffer.reclaim(1)

    def _submit(self, tasks: List[RolloutTask], version: int) -> None:
        if not tasks:
            return
        if not self.replicate and len(tasks) > 1:
            # non-replicated group: ONE submission decoding k sequences
            # (client expands it; COW group sharing where supported)
            t0 = tasks[0]
            handle = self.client.submit(RolloutTask(
                task_id=t0.task_id, prompt_id=t0.prompt_id, replica_idx=0,
                prompt_tokens=t0.prompt_tokens,
                max_new_tokens=t0.max_new_tokens, group_id=t0.group_id,
                meta={"num_return_sequences": len(tasks)},
                priority=t0.priority, deadline_ms=t0.deadline_ms),
                version=version)
        elif len(tasks) > 1:
            handle = self.client.submit_group(tasks, version=version)
        else:
            handle = self.client.submit(tasks[0], version=version)
        handle.add_done_callback(self._publish)

    def _produce_group(self) -> bool:
        """Claim up to group_size freshness slots and submit them as ONE
        group (prompt_stream repeats each prompt group_size times, so
        consecutive pulls are replicas of the same prompt).  A capacity
        pinch flushes a partial group — COW sharing degrades for that group,
        correctness doesn't: assembly downstream keys on group_id.  Groups
        always cut at prompt boundaries (see _GroupAssembler).  Returns
        False to stop the producer."""
        tasks: List[RolloutTask] = []
        version = 0
        exhausted = False
        while len(tasks) < self.group_size:
            if self._halt.is_set() or self.buffer.closed:
                self.buffer.reclaim(len(tasks))
                return False
            v = self.buffer.begin_generation(timeout=0.1)
            if v is None:
                if tasks:
                    break  # freshness capacity pinch: flush a partial group
                continue
            status, pid, toks = self._groups.pull(
                tasks[0].prompt_id if tasks else None)
            if status != "ok":
                self.buffer.reclaim(1)
                exhausted = status == "exhausted"
                break
            version = max(version, v)
            tasks.append(RolloutTask(task_id=next_uid(), prompt_id=pid,
                                     replica_idx=len(tasks),
                                     prompt_tokens=toks,
                                     max_new_tokens=self.max_new_tokens,
                                     group_id=self._groups.group_id(pid),
                                     priority=self.priority,
                                     deadline_ms=self.deadline_ms))
        self._submit(tasks, version)
        return not exhausted

    def run(self) -> None:
        while not self._halt.is_set() and not self.buffer.closed:
            if not self._produce_group():
                return
