"""AsyncController: the rollout–train decoupling orchestrator (§4.2).

Per training iteration:
    batch = SampleBuffer.get_batch()          (blocking)
    train_step(batch)                          on the trainer resources
    weight sync (see below); advance policy version; ABORT in-flight
    generations that would exceed the asynchronous ratio.  With
    ``abort_retain=True`` the victims' KV pages are parked and the
    RolloutClient continuation transparently resumes them under the new
    version — nothing is wasted and nothing re-prefills.

Weight synchronization has two modes:

* ``weight_sync="blocking"`` — the 3-phase barrier: suspend every proxy,
  swap params, resume.  Rollout stalls for the whole window.
* ``weight_sync="overlapped"`` (default) — per-proxy staged swap: each
  proxy applies ``update_weights`` between two of its own engine steps
  (``LLMProxy.update_weights_async``); there is NO global suspend and
  rollout keeps advancing while the trainer gathers/stages the weights.
  Version advance waits until every engine holds the new params, so
  staleness accounting is identical to blocking mode.

Synchronous mode (async_generation_ratio == 0) is the documented switch:
suspend immediately after get_batch so every subsequent trajectory is
generated by the freshest weights (always the 3-phase path).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core.llm_proxy import LLMProxy
from repro_torch.core.router import MultiEvent
from repro_torch.core.sample_buffer import SampleBuffer
from repro_torch.core.types import Sample


@dataclasses.dataclass
class StepStats:
    step: int
    wait_time: float       # blocked on get_batch
    train_time: float
    sync_time: float       # weight-sync window (trainer-side)
    staleness_mean: float
    staleness_max: int
    reward_mean: float
    # train_fn metrics + fleet utilization (observable, not discarded)
    loss: float = 0.0
    queue_depth: int = 0   # fleet-wide submitted-but-unadmitted requests
    active_per_replica: List[int] = dataclasses.field(default_factory=list)
    # elasticity / fault-tolerance counters (router-backed fleets only)
    replicas_alive: int = 0
    failovers: int = 0     # cumulative handles failed over off dead replicas
    lost_tokens: int = 0   # cumulative decode progress lost to crashes
    # cross-replica KV movement / cache-aware routing (cumulative)
    pages_transferred: int = 0  # KV pages moved between replicas
    transfer_bytes: int = 0     # host-side bytes those moves shipped
    cache_routed: int = 0       # placements won by the cache-affinity tier
    cache_pulls: int = 0        # prefix pulls issued ahead of admission
    # SLO counters (cumulative; zero when the SLO layer is off)
    deadline_misses: int = 0   # expired work: shed pending + timed-out active
    preemptions: int = 0       # low-priority decodes paused for high-priority
    rejected: int = 0          # typed Rejected results (expired/full/shed)
    queue_depth_by_class: Dict[int, int] = dataclasses.field(
        default_factory=dict)  # pending requests per priority class
    # batch composition by rollout quantization mode ("off"/"int8"/"fp8"
    # -> sample count): after a mid-run set_quant_mode change, one batch
    # legitimately mixes precisions — this makes that visible instead of
    # silently averaging across numerically different behaviour policies.
    quant_modes: Dict[str, int] = dataclasses.field(default_factory=dict)


class AsyncController:
    def __init__(
        self,
        buffer: SampleBuffer,
        proxies: List[LLMProxy],
        train_fn: Callable[[List[Sample]], Dict[str, Any]],
        get_weights_fn: Callable[[], Any],
        *,
        alpha: float = 1.0,
        sync_mode: Optional[bool] = None,
        weight_sync: str = "overlapped",
        weight_sync_timeout: float = 60.0,
        abort_retain: bool = True,
        router=None,
    ):
        if weight_sync not in ("blocking", "overlapped"):
            raise ValueError(f"weight_sync must be blocking|overlapped, "
                             f"got {weight_sync!r}")
        self.buffer = buffer
        self.proxies = proxies
        # with an elastic fleet, control ops fan out THROUGH the router so
        # they skip dead/retired replicas and cover ones added mid-run; the
        # static proxies list would go stale the first time the fleet flexes.
        self.router = router
        self._targets = [router] if router is not None else proxies
        self.train_fn = train_fn
        self.get_weights_fn = get_weights_fn
        self.alpha = alpha
        self.sync_mode = (alpha == 0) if sync_mode is None else sync_mode
        self.weight_sync = weight_sync
        self.weight_sync_timeout = weight_sync_timeout
        self.abort_retain = abort_retain
        self.stats: List[StepStats] = []

    # --------------------------------------------------------------- phases
    def _abort_stale(self, version: int) -> None:
        """Per-sample freshness: ABORT anything initiated too long ago.
        retain=True parks the KV pages so the client-layer continuation
        resumes under the new version with zero prefix re-prefill."""
        floor_v = version - int(math.floor(self.alpha))
        for p in self._targets:
            p.abort_stale(floor_v, retain=self.abort_retain)

    def _weight_sync_blocking(self) -> float:
        t0 = time.monotonic()
        for p in self._targets:
            p.suspend()
        weights = self.get_weights_fn()
        for p in self._targets:
            p.update_weights(weights)
        version = self.buffer.advance_version()
        self._abort_stale(version)
        for p in self._targets:
            p.resume()
        return time.monotonic() - t0

    def _weight_sync_overlapped(self) -> float:
        """Decoupled, non-blocking sync: stage the swap on every proxy and
        wait only for the acknowledgements (one command-queue hop each —
        the proxies never stop stepping)."""
        t0 = time.monotonic()
        weights = self.get_weights_fn()
        staged = MultiEvent([p.update_weights_async(weights)
                             for p in self._targets])
        # one shared deadline for the whole fleet, not timeout-per-replica
        if not staged.wait(timeout=self.weight_sync_timeout):
            raise TimeoutError("staged weight update not applied on every "
                               "replica (proxy loop stalled or suspended?)")
        version = self.buffer.advance_version()
        self._abort_stale(version)
        return time.monotonic() - t0

    def _weight_sync(self) -> float:
        if self.weight_sync == "overlapped":
            return self._weight_sync_overlapped()
        return self._weight_sync_blocking()

    # ----------------------------------------------------------------- run
    def train(self, num_steps: int, *, batch_size: Optional[int] = None,
              timeout: float = 600.0) -> List[StepStats]:
        for step in range(num_steps):
            t0 = time.monotonic()
            batch = self.buffer.get_batch(batch_size, timeout=timeout)
            t1 = time.monotonic()

            if self.sync_mode:
                # pause generation NOW: everything after this trains on and
                # generates with the newest weights only
                for p in self._targets:
                    p.suspend()

            metrics = self.train_fn(batch)
            t2 = time.monotonic()

            if self.sync_mode:
                weights = self.get_weights_fn()
                for p in self._targets:
                    p.update_weights(weights)
                self.buffer.advance_version()
                for p in self._targets:
                    p.resume()
                sync_t = time.monotonic() - t2
            else:
                sync_t = self._weight_sync()

            version = self.buffer.version
            staleness = [version - 1 - s.version_started for s in batch]
            rewards = [s.reward for s in batch if s.reward is not None]
            metrics = metrics or {}
            self.stats.append(StepStats(
                step=step,
                wait_time=t1 - t0,
                train_time=t2 - t1,
                sync_time=sync_t,
                staleness_mean=sum(staleness) / max(len(staleness), 1),
                staleness_max=max(staleness) if staleness else 0,
                reward_mean=sum(rewards) / max(len(rewards), 1),
                loss=float(metrics.get("loss",
                                       metrics.get("policy_loss", 0.0))),
                queue_depth=sum(getattr(p, "num_pending", 0)
                                for p in self._targets),
                active_per_replica=(
                    self.router.active_per_replica
                    if self.router is not None
                    else [getattr(p, "num_active", 0)
                          for p in self.proxies]),
                replicas_alive=(self.router.replicas_alive
                                if self.router is not None
                                else len(self.proxies)),
                failovers=(self.router.failovers
                           if self.router is not None else 0),
                lost_tokens=(self.router.lost_tokens
                             if self.router is not None else 0),
                pages_transferred=(self.router.pages_transferred
                                   if self.router is not None else 0),
                transfer_bytes=(self.router.transfer_bytes
                                if self.router is not None else 0),
                cache_routed=(self.router.cache_routed
                              if self.router is not None else 0),
                cache_pulls=(self.router.cache_pulls
                             if self.router is not None else 0),
                deadline_misses=sum(getattr(p, "deadline_misses", 0)
                                    for p in self._targets),
                preemptions=sum(getattr(p, "preemptions", 0)
                                for p in self._targets),
                rejected=sum(getattr(p, "rejected", 0)
                             for p in self._targets),
                queue_depth_by_class=self._class_depths(),
                quant_modes=self._quant_mix(batch),
            ))
        return self.stats

    @staticmethod
    def _quant_mix(batch: List[Sample]) -> Dict[str, int]:
        """Sample count per rollout quantization mode in this batch (the
        proxy stamps ``meta["quant_mode"]`` at admission)."""
        mix: Dict[str, int] = {}
        for s in batch:
            mode = (s.meta or {}).get("quant_mode", "off")
            mix[mode] = mix.get(mode, 0) + 1
        return mix

    def _class_depths(self) -> Dict[int, int]:
        # router exposes the fleet aggregate; a bare proxy its own queue
        merged: Dict[int, int] = {}
        for p in self._targets:
            depths = getattr(p, "queue_depth_by_class",
                             getattr(p, "pending_by_priority", {}))
            for pr, n in depths.items():
                merged[pr] = merged.get(pr, 0) + n
        return merged
