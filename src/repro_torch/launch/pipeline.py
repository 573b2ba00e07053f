"""Pipeline assembly: wire models + rollout fleet + buffer + controller.

This is the host-level composition root used by `launch/train.py` and the
integration tests.  Everything is config-driven, mirroring the paper's
appendix-A YAML (async_generation_ratio, pg_variant, rollout_batch_size,
num_return_sequences, actor_train/actor_infer split...).
``num_rollout_replicas`` sizes the rollout fleet: 1 (default) is the plain
single proxy/engine path; >= 2 shards slots/pages across N replicas behind
a ``ProxyRouter`` (queue scheduling, co-located groups/sessions,
cross-replica abort-resume migration).

The port of the JAX package's ``launch/pipeline.py``.  What differs:

* ``device``: ``build_rlvr_pipeline`` and ``build_agentic_pipeline`` run
  on the card unless the caller passes another device (``"cpu"``); without
  a card and without ``device`` they raise.  The trainer, the engines and
  every replica share the one device.
* ``attn_impl`` ("kernel", the default, or "ref") reaches both engines and
  the trainer.  The train step of the ``ssm`` and ``hybrid`` families
  runs the scans' plain versions (their kernels have no backward); their
  logprob passes run the kernels.  An MoE config is served on the paged
  engine with the reference's capacity dispatch and trained with every
  expert on every token (``moe_mode="dense"``), as in the reference.
  ``auto`` serves a VLM on the slot engine, text-only (no paged views).
* An enc-dec (``audio``) config is refused before anything is built: the
  slot engine cannot prefill it without frames.  The reference's pipeline
  builds, then fails at its first rollout (``KeyError: 'frames'``) and
  times out in ``get_batch``.
* The trainer's params are drawn from ``seed`` by ``torch.Generator``, not
  ``jax.random``: the same seed gives other weights than the JAX pipeline.
* Every replica's engine holds the trainer's tensors by reference
  (``quant_mode="off"``); each train step replaces them with new tensors,
  so a tree an engine holds never changes under it.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, List, Optional, Tuple, Union

from repro_torch.algos import LossConfig
from repro_torch.core.async_controller import AsyncController
from repro_torch.core.env_manager import EnvManagerPool
from repro_torch.core.llm_proxy import LLMProxy
from repro_torch.core.router import AutoscalePolicy, ProxyRouter
from repro_torch.core.sample_buffer import SampleBuffer
from repro_torch.core.scheduler import RolloutProducer
from repro_torch.core.slo import SLOConfig, without_admission
from repro_torch.core.types import PRIORITY_NORMAL
from repro_torch.data.dataset import ArithmeticTask, EOS
from repro_torch.models import ModelConfig, get_api
from repro_torch.rewards.verifier import ArithmeticVerifier
from repro_torch.rollout.engine import DecodeEngine, refuse_audio
from repro_torch.rollout.paged_engine import PagedDecodeEngine
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.trainer import HostTrainer, TrainerConfig

RolloutEngine = Union[DecodeEngine, PagedDecodeEngine]


@dataclasses.dataclass
class PipelineSettings:
    """The paper's launch-config surface (appendix A.1 naming)."""
    async_generation_ratio: float = 1.0    # 0 => Sync
    pg_variant: str = "ppo"
    rollout_batch_size: int = 16           # samples per train step
    num_return_sequences_in_group: int = 4
    is_num_return_sequences_expand: bool = True  # prompt replication
    max_new_tokens: int = 12
    max_seq_len: int = 32
    num_slots: int = 8                     # decode slots (infer "GPUs")
    minibatches: int = 1
    ppo_epochs: int = 1
    adv_estimator: str = "grpo"            # grpo (paper default) | gae (critic)
    kl_beta: float = 0.0
    learning_rate: float = 3e-3
    seed: int = 0
    # rollout engine selection: "auto" runs the paged COW engine for
    # families with paged KV views (dense, moe) and the slot engine for the
    # others (rwkv6 / hybrid: ``api.init_paged_cache is None``).
    rollout_engine: str = "auto"           # auto | paged | slot
    page_size: int = 16                    # paged engine: KV page tokens
    prefill_chunk: int = 16                # paged engine: prefill chunk tokens
    num_pages: Optional[int] = None        # paged engine: pool size (auto)
    # "kernel": the hand-written CUDA kernels on the card (their plain
    # versions on CPU tensors); "ref": the plain versions everywhere
    attn_impl: str = "kernel"              # kernel | ref
    # automatic cross-prompt prefix caching (radix tree over KV pages).
    # "auto"/"on": enabled on the paged engine; "off": disabled.  The slot
    # engine has no page pool — the setting passes through as a no-op there.
    prefix_cache: str = "auto"             # auto | on | off
    # agentic rollouts: "turn" submits only each turn's observation; "full"
    # resubmits the growing conversation every turn, which the prefix cache
    # turns into incremental prefill (only the new suffix is computed).
    agentic_context: str = "turn"          # turn | full
    # weight synchronization (async modes only; alpha=0 always uses the
    # 3-phase suspend barrier): "overlapped" stages a per-proxy parameter
    # swap between engine steps — rollout never stops; "blocking" is the
    # 3-phase suspend -> update -> resume barrier.
    weight_sync: str = "overlapped"        # overlapped | blocking
    # max seconds to wait for every replica to acknowledge a staged
    # (overlapped) weight swap before declaring the fleet stalled.
    weight_sync_timeout: float = 60.0
    # rollout fleet size.  1 (default) keeps the single proxy/engine path;
    # >= 2 shards num_slots/num_pages across N replicas behind a
    # ProxyRouter (per-request least-loaded queue scheduling,
    # GRPO-group/session co-location, cross-replica abort-resume
    # migration).
    num_rollout_replicas: int = 1
    # elasticity: autoscale_max_replicas > num_rollout_replicas arms
    # load-triggered scaling — the fleet grows toward the max under queue
    # pressure and drains/retires idle replicas back toward the min
    # (AutoscalePolicy hysteresis).  0 (default) disables the autoscaler.
    autoscale_max_replicas: int = 0
    autoscale_min_replicas: int = 1
    # crash detection: > 0 runs the router's background heartbeat monitor
    # at this period (seconds) — dead replicas are detected and their
    # in-flight work failed over without waiting for a dispatch to hit
    # them.  0 (default) relies on dispatch-time detection only.
    health_probe_interval: float = 0.0
    # fleet-global prefix cache (N >= 2 fleets with a prefix cache):
    # cache_aware_routing arms the router's FleetRadixIndex — placement
    # routes to the replica holding a prompt's longest cached prefix when
    # its load is within cache_affinity_slack tokens of the fleet minimum,
    # otherwise least-loaded wins and the prefix pages are pulled across
    # before admission (cache_pull).  Cross-replica migration always moves
    # retained pages when it can (page-transfer fast path).
    cache_aware_routing: bool = True
    cache_affinity_slack: int = 256
    cache_pull: bool = True
    # --- SLO layer (admission control / preemption / watchdog) ---
    # slo_enabled arms the layer; all numeric knobs use 0 = off/unbounded.
    # Queue bounds are enforced fleet-wide at the router front door (replicas
    # behind a router carry an admission-stripped copy so admitted work is
    # never double-rejected).
    slo_enabled: bool = False
    slo_queue_limit_per_class: int = 0     # pending bound per priority class
    slo_queue_limit_total: int = 0         # pending bound across classes
    slo_preempt: bool = True               # high-priority arrivals evict decodes
    slo_stall_timeout: float = 0.0         # s without decode progress => timeout
    slo_defer_after_tokens: int = 0        # long-tail defer threshold (tokens)
    slo_replica_stall: float = 0.0         # s of frozen replica steps => dead
    # default SLO class stamped on produced rollout tasks
    rollout_priority: int = PRIORITY_NORMAL
    rollout_deadline_ms: float = 0.0       # 0 = no deadline
    # --- quantized rollouts (FlashRL recipe) ---
    # rollout_quant quantizes rollout-engine WEIGHTS at every weight sync
    # (trainer stays full precision); kv_quant stores KV pages as int8 with
    # per-(page,slot,kv-head) scales (paged engine only).  tis_clip > 0
    # tightens the eq. 12 truncated-IS cap to absorb the resulting
    # train/rollout engine mismatch (0 = off).
    rollout_quant: str = "off"             # off | int8 | fp8
    kv_quant: str = "off"                  # off | int8
    tis_clip: float = 0.0                  # 0 = off; typical quantized: 2.0


def make_slo_config(s: PipelineSettings) -> Optional[SLOConfig]:
    """Translate the flat settings knobs into an ``SLOConfig`` (or None
    when the layer is disabled)."""
    if not s.slo_enabled:
        return None
    return SLOConfig(
        queue_limit_per_class=s.slo_queue_limit_per_class or None,
        queue_limit_total=s.slo_queue_limit_total or None,
        preempt=s.slo_preempt,
        stall_timeout_s=s.slo_stall_timeout or None,
        defer_after_tokens=s.slo_defer_after_tokens or None,
        replica_stall_s=s.slo_replica_stall or None)


def make_rollout_engine(api, params, s: PipelineSettings) -> RolloutEngine:
    """Construct the rollout engine per ``s.rollout_engine`` (see above),
    on the device of ``api``."""
    if s.prefix_cache not in ("auto", "on", "off"):
        raise ValueError(f"unknown prefix_cache {s.prefix_cache!r} "
                         "(expected auto | on | off)")
    choice = s.rollout_engine
    if choice == "auto":
        choice = "paged" if api.init_paged_cache is not None else "slot"
    if choice == "paged":
        return PagedDecodeEngine(
            api, params, num_slots=s.num_slots, max_total_len=s.max_seq_len,
            page_size=s.page_size, prefill_chunk=s.prefill_chunk,
            num_pages=s.num_pages, eos_id=EOS, seed=s.seed,
            attn_impl=s.attn_impl, prefix_cache=s.prefix_cache != "off",
            quant_mode=s.rollout_quant, kv_quant=s.kv_quant, device=api.device)
    if choice != "slot":
        raise ValueError(f"unknown rollout_engine {s.rollout_engine!r} "
                         "(expected auto | paged | slot)")
    if s.kv_quant != "off":
        raise ValueError("kv_quant requires the paged engine (the slot "
                         "engine has no page pool to quantize); set "
                         "rollout_engine='paged' or kv_quant='off'")
    return DecodeEngine(api, params, num_slots=s.num_slots,
                        max_total_len=s.max_seq_len, eos_id=EOS, seed=s.seed,
                        quant_mode=s.rollout_quant, attn_impl=s.attn_impl,
                        device=api.device)


def make_rollout_fleet(api, params, s: PipelineSettings,
                       ) -> Tuple[List[RolloutEngine], List[LLMProxy],
                                  Optional[ProxyRouter]]:
    """Build ``s.num_rollout_replicas`` proxy/engine replicas.

    N = 1 (default) returns the single-engine construction (no router —
    the producer talks straight to the proxy).  N >= 2 shards the decode
    capacity: each replica gets ceil(num_slots / N) slots and
    ceil(num_pages / N) pages (when pinned), and a ProxyRouter fronts the
    fleet with least-outstanding-tokens queue scheduling.

    With ``autoscale_max_replicas`` armed the router also gets a
    ``replica_factory`` (same shard shape, fresh per-replica seed) so
    ``add_replica``/scale-up can grow the fleet mid-run, plus the
    hysteresis policy driving load-triggered elasticity."""
    n = max(1, int(s.num_rollout_replicas))
    elastic = s.autoscale_max_replicas > n
    slo = make_slo_config(s)
    if n == 1 and not elastic:
        engine = make_rollout_engine(api, params, s)
        # a lone proxy IS the front door: it keeps the full SLO config,
        # queue bounds included
        return [engine], [LLMProxy(engine, slo=slo)], None
    # behind a router the queue bounds are enforced fleet-wide at the front
    # door; replicas keep the preemption/watchdog parts only
    replica_slo = without_admission(slo)
    shard = s if n == 1 else dataclasses.replace(
        s, num_slots=max(1, -(-s.num_slots // n)),
        num_pages=None if s.num_pages is None else max(2, -(-s.num_pages // n)))
    # per-replica sampler seeds: identical streams across replicas would
    # silently duplicate stochastic rollouts (greedy is seed-invariant)
    engines = [make_rollout_engine(api, params,
                                   dataclasses.replace(shard, seed=s.seed + i))
               for i in range(n)]
    proxies = [LLMProxy(e, name=f"llm_proxy_{i}", slo=replica_slo)
               for i, e in enumerate(engines)]
    counter = itertools.count(n)

    def factory() -> LLMProxy:
        i = next(counter)
        e = make_rollout_engine(api, params,
                                dataclasses.replace(shard, seed=s.seed + i))
        return LLMProxy(e, name=f"llm_proxy_{i}", slo=replica_slo)

    policy = AutoscalePolicy(
        min_replicas=max(1, s.autoscale_min_replicas),
        max_replicas=s.autoscale_max_replicas) if elastic else None
    return engines, proxies, ProxyRouter(
        proxies, replica_factory=factory, autoscale=policy, slo=slo,
        cache_aware=s.cache_aware_routing and s.prefix_cache != "off",
        cache_affinity_slack=s.cache_affinity_slack,
        cache_pull=s.cache_pull)


def make_trainer(api, s: PipelineSettings, group_size: int) -> HostTrainer:
    """The pipeline's ``HostTrainer`` on the device of ``api``, with
    ``s.attn_impl`` (the engines and the trainer refuse any value but
    "kernel" and "ref")."""
    loss_cfg = LossConfig(pg_variant=s.pg_variant, kl_beta=s.kl_beta,
                          tis_clip=s.tis_clip or None)
    opt_cfg = OptConfig(learning_rate=s.learning_rate, warmup_steps=5)
    tcfg = TrainerConfig(max_seq_len=s.max_seq_len, group_size=group_size,
                         minibatches=s.minibatches, ppo_epochs=s.ppo_epochs,
                         adv_estimator=s.adv_estimator)
    return HostTrainer(api, s.seed, loss_cfg, opt_cfg, tcfg, attn_impl=s.attn_impl)


@dataclasses.dataclass
class RLVRPipeline:
    settings: PipelineSettings
    trainer: HostTrainer
    engine: RolloutEngine          # primary replica (engines[0])
    proxy: LLMProxy                # primary replica (proxies[0])
    buffer: SampleBuffer
    producer: RolloutProducer
    controller: AsyncController
    engines: List[RolloutEngine] = dataclasses.field(default_factory=list)
    proxies: List[LLMProxy] = dataclasses.field(default_factory=list)
    router: Optional[ProxyRouter] = None    # None on a 1-replica fleet
    chaos: List = dataclasses.field(default_factory=list)  # FaultInjectors

    def attach_chaos(self, injector) -> None:
        """Register a ``FaultInjector`` so ``shutdown()`` halts and joins
        it — chaos threads must not outlive the pipeline they torment."""
        self.chaos.append(injector)

    @property
    def client(self):
        """The handle-issuing RolloutClient over this pipeline's fleet."""
        return self.producer.client

    @property
    def rollout_target(self):
        """What producers submit to: the router, or the lone proxy."""
        return self.router if self.router is not None else self.proxy

    def run(self, num_steps: int, timeout: float = 600.0):
        if self.router is not None:
            self.router.start()
            if self.settings.health_probe_interval > 0:
                self.router.start_health_monitor(
                    self.settings.health_probe_interval)
        else:
            for p in (self.proxies or [self.proxy]):
                p.start()
        self.producer.start()
        try:
            return self.controller.train(num_steps, timeout=timeout)
        finally:
            self.shutdown()

    def shutdown(self):
        for inj in self.chaos:
            inj.stop()              # sets halt AND joins the chaos thread
        self.producer.stop()
        self.buffer.close()
        if self.producer.is_alive():
            self.producer.join(timeout=10)
        if self.router is not None:
            self.router.stop()      # joins the health monitor too
        else:
            for p in (self.proxies or [self.proxy]):
                p.stop()


def build_rlvr_pipeline(model_cfg: ModelConfig, s: PipelineSettings,
                        *, task: Optional[ArithmeticTask] = None,
                        reward_fn: Optional[Callable] = None,
                        device=None) -> RLVRPipeline:
    refuse_audio(model_cfg, "build_rlvr_pipeline")
    task = task or ArithmeticTask(seed=s.seed)
    reward_fn = reward_fn or ArithmeticVerifier(task)
    api = get_api(model_cfg, device=device)
    trainer = make_trainer(api, s, s.num_return_sequences_in_group)

    engines, proxies, router = make_rollout_fleet(api, trainer.get_weights(), s)
    alpha = s.async_generation_ratio
    buffer = SampleBuffer(batch_size=s.rollout_batch_size, alpha=alpha)
    producer = RolloutProducer(
        router if router is not None else proxies[0], buffer,
        task.prompt_stream(group_size=s.num_return_sequences_in_group),
        group_size=s.num_return_sequences_in_group,
        max_new_tokens=s.max_new_tokens, reward_fn=reward_fn,
        replicate=s.is_num_return_sequences_expand,
        priority=s.rollout_priority,
        deadline_ms=s.rollout_deadline_ms or None)
    controller = AsyncController(buffer, proxies, trainer.train_on_samples,
                                 trainer.get_weights, alpha=alpha,
                                 weight_sync=s.weight_sync,
                                 weight_sync_timeout=s.weight_sync_timeout,
                                 router=router)
    return RLVRPipeline(s, trainer, engines[0], proxies[0], buffer, producer,
                        controller, engines=engines, proxies=proxies,
                        router=router)


@dataclasses.dataclass
class AgenticPipeline:
    settings: PipelineSettings
    trainer: HostTrainer
    engine: RolloutEngine          # primary replica (engines[0])
    proxy: LLMProxy                # primary replica (proxies[0])
    buffer: SampleBuffer
    pool: EnvManagerPool
    controller: AsyncController
    engines: List[RolloutEngine] = dataclasses.field(default_factory=list)
    proxies: List[LLMProxy] = dataclasses.field(default_factory=list)
    router: Optional[ProxyRouter] = None    # None on a 1-replica fleet
    chaos: List = dataclasses.field(default_factory=list)  # FaultInjectors

    def attach_chaos(self, injector) -> None:
        """Register a ``FaultInjector`` so ``shutdown()`` halts and joins
        it — chaos threads must not outlive the pipeline they torment."""
        self.chaos.append(injector)

    @property
    def client(self):
        """The handle-issuing RolloutClient shared by the env-manager pool."""
        return self.pool.client

    @property
    def rollout_target(self):
        """What env managers submit to: the router, or the lone proxy."""
        return self.router if self.router is not None else self.proxy

    def run(self, num_steps: int, timeout: float = 600.0):
        if self.router is not None:
            self.router.start()
            if self.settings.health_probe_interval > 0:
                self.router.start_health_monitor(
                    self.settings.health_probe_interval)
        else:
            for p in (self.proxies or [self.proxy]):
                p.start()
        self.pool.start()
        try:
            return self.controller.train(num_steps, timeout=timeout)
        finally:
            self.shutdown()

    def shutdown(self):
        for inj in self.chaos:
            inj.stop()              # sets halt AND joins the chaos thread
        self.pool.stop(join=False)  # stop flag + abort every in-flight turn
        self.buffer.close()         # wake managers parked in begin_generation
        # join managers BEFORE stopping the proxies: an aborted turn still
        # needs a live proxy to resolve its handle, and env-manager threads
        # must not outlive the pipeline (leak-checked by the test suite).
        self.pool.stop(join=True)
        if self.router is not None:
            self.router.stop()      # joins the health monitor too
        else:
            for p in (self.proxies or [self.proxy]):
                p.stop()


def build_agentic_pipeline(model_cfg: ModelConfig, s: PipelineSettings, *,
                           make_env: Callable, num_env_groups: int,
                           group_size: int, max_env_steps: int = 8,
                           device=None) -> AgenticPipeline:
    refuse_audio(model_cfg, "build_agentic_pipeline")
    api = get_api(model_cfg, device=device)
    trainer = make_trainer(api, s, group_size)
    engines, proxies, router = make_rollout_fleet(api, trainer.get_weights(), s)
    buffer = SampleBuffer(batch_size=s.rollout_batch_size,
                          alpha=s.async_generation_ratio)
    pool = EnvManagerPool(make_env, router if router is not None else proxies[0],
                          buffer,
                          num_env_groups=num_env_groups, group_size=group_size,
                          max_steps=max_env_steps,
                          max_new_tokens=s.max_new_tokens,
                          context_mode=s.agentic_context,
                          max_context_tokens=s.max_seq_len - s.max_new_tokens)
    controller = AsyncController(buffer, proxies, trainer.train_on_samples,
                                 trainer.get_weights,
                                 alpha=s.async_generation_ratio,
                                 weight_sync=s.weight_sync,
                                 weight_sync_timeout=s.weight_sync_timeout,
                                 router=router)
    return AgenticPipeline(s, trainer, engines[0], proxies[0], buffer, pool,
                           controller, engines=engines, proxies=proxies,
                           router=router)
