"""Deterministic discrete-event simulator of the ROLL Flash pipeline.

Used by the benchmark suite to reproduce the paper's timing figures
(Fig 1b, 3a, 3b, 7, 8, 9, 10, Table 1) and by property tests to validate
Propositions 1 & 2.  This container has one CPU core, so wall-clock
concurrency measurements are meaningless; the simulator gives seeded,
reproducible timing under the paper's own cost model:

* a generation *worker* is a decode slot (GPUs x slots_per_gpu);
* a sequence occupies one slot for (length x per-token time);
* without prompt replication, a group of G candidates is one request that
  occupies G co-located slots until its *longest* member finishes
  (the paper's "single worker synchronously decodes all n responses");
* training takes B x mu_train / train_gpus + fixed overhead;
* async mode runs disjoint pools with the SampleBuffer freshness gate
  (occupancy <= (1+alpha) x B) and ABORT-continue on version advance.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Callable, List, Optional, Sequence

import numpy as np


# ---------------------------------------------------------------------------
# Prop-1-level primitives: scheduling a fixed set of durations on K workers
# ---------------------------------------------------------------------------

def simulate_queue_completion(durations: Sequence[float], k: int) -> float:
    """Queue scheduling: task -> earliest-free worker (greedy list schedule)."""
    if not len(durations):
        return 0.0
    free = [0.0] * min(k, len(durations))
    heapq.heapify(free)
    end = 0.0
    for d in durations:
        t0 = heapq.heappop(free)
        t1 = t0 + d
        end = max(end, t1)
        heapq.heappush(free, t1)
    return end


def simulate_static_completion(durations: Sequence[float], k: int) -> float:
    """Batch rollout: round-robin pre-partition, no work stealing."""
    loads = [0.0] * k
    for i, d in enumerate(durations):
        loads[i % k] += d
    return max(loads)


def simulate_group_queue_completion(group_durations: Sequence[Sequence[float]],
                                    k: int) -> float:
    """Queue scheduling WITHOUT prompt replication: each group occupies
    len(group) co-located slots until its longest member completes."""
    free = [0.0] * k
    heapq.heapify(free)
    end = 0.0
    for group in group_durations:
        g = len(group)
        # claim the g earliest-free slots (must be co-located / simultaneous)
        claimed = [heapq.heappop(free) for _ in range(min(g, k))]
        start = max(claimed)
        finish = start + max(group)
        end = max(end, finish)
        for _ in claimed:
            heapq.heappush(free, finish)
    return end


# ---------------------------------------------------------------------------
# Fig 7: queue scheduling + dynamic filtering + redundant prompts
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FilteringResult:
    gen_time: float
    groups_generated: int
    groups_kept: int


def simulate_filtered_rollout(
    rng: np.random.Generator,
    *,
    batch_groups: int,            # qualifying groups needed per step
    group_size: int,
    k_slots: int,
    length_sampler: Callable[[np.random.Generator, int], np.ndarray],
    per_token_time: float,
    p_filter: float,              # P(group filtered out: zero reward variance)
    mode: str,                    # "batch" | "queue"
    extra_prompts: int = 0,       # max_additional_running_prompts
) -> FilteringResult:
    """One rollout step under dynamic filtering.

    batch mode: full-batch rounds; rewards/filters only after the whole batch
    completes; insufficient -> another full round.
    queue mode: groups stream; each completion is immediately rewarded and
    filtered; generation stops the moment batch_groups qualify.
    """
    if mode == "batch":
        t, produced, kept = 0.0, 0, 0
        while kept < batch_groups:
            n = batch_groups
            durs = [length_sampler(rng, group_size) * per_token_time for _ in range(n)]
            flat = [d for g in durs for d in g]
            t += simulate_queue_completion(flat, k_slots)
            produced += n
            kept += int(np.sum(rng.random(n) >= p_filter))
        return FilteringResult(t, produced, kept)

    # queue mode: pre-launch batch_groups + extra_prompts groups, stream
    # completions in group-finish order, top up on filtered groups, and stop
    # the moment batch_groups qualify (remaining generations are ABORTed).
    launched = 0
    target_launch = batch_groups + extra_prompts
    free = [0.0] * k_slots
    heapq.heapify(free)
    groups: List[List[float]] = []
    kept_flags: List[bool] = []

    def launch_group():
        nonlocal launched
        lens = length_sampler(rng, group_size) * per_token_time
        ends = []
        for d in lens:
            t0 = heapq.heappop(free)
            t1 = t0 + float(d)
            ends.append(t1)
            heapq.heappush(free, t1)
        groups.append(ends)
        kept_flags.append(bool(rng.random() >= p_filter))
        launched += 1

    for _ in range(target_launch):
        launch_group()

    # stream completions in group-finish order; top-up on filtered groups
    kept, t_done, produced = 0, 0.0, 0
    order = sorted(range(len(groups)), key=lambda i: max(groups[i]))
    i = 0
    while kept < batch_groups:
        if i >= len(order):
            launch_group()
            order = sorted(range(len(groups)), key=lambda i2: max(groups[i2]))
        gi = order[i]
        i += 1
        produced += 1
        if kept_flags[gi]:
            kept += 1
            t_done = max(groups[gi])  # time the batch_groups-th keeper lands
    return FilteringResult(t_done, produced, kept)


# ---------------------------------------------------------------------------
# End-to-end pipeline: sync-naive / sync-queue / async
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PipelineConfig:
    rollout_batch_size: int            # N samples consumed per train step
    group_size: int = 1
    gpus: int = 32
    train_gpus: Optional[int] = None   # async split; sync uses all for both
    infer_gpus: Optional[int] = None
    slots_per_gpu: int = 16
    per_token_time: float = 0.01       # s per decoded token per sequence
    mu_train_per_sample: float = 0.05  # s per sample on ONE gpu (scales /gpus)
    train_overhead: float = 5.0        # model load/offload etc. per step
    weight_sync_time: float = 1.0      # suspend+broadcast+resume
    alpha: float = 1.0
    mode: str = "async"                # sync_naive | sync_queue | async
    prompt_replication: bool = True
    ppo_epochs: float = 1.0


@dataclasses.dataclass
class PipelineResult:
    step_times: List[float]
    makespan: float
    gen_utilization: float             # busy slot-time / total slot-time
    staleness: List[int]               # per consumed sample: version gap
    throughput: float                  # samples / s

    @property
    def mean_step_time(self) -> float:
        return float(np.mean(self.step_times))


def _train_time(cfg: PipelineConfig, train_gpus: int) -> float:
    return (cfg.rollout_batch_size * cfg.ppo_epochs * cfg.mu_train_per_sample
            / max(train_gpus, 1) + cfg.train_overhead)


def simulate_pipeline(rng: np.random.Generator, cfg: PipelineConfig,
                      num_steps: int,
                      length_sampler: Callable[[np.random.Generator, int], np.ndarray],
                      ) -> PipelineResult:
    """Simulate num_steps of RL post-training end-to-end."""
    n = cfg.rollout_batch_size
    if cfg.mode in ("sync_naive", "sync_queue"):
        k = cfg.gpus * cfg.slots_per_gpu
        t = 0.0
        step_times, busy = [], 0.0
        train_t = _train_time(cfg, cfg.gpus)
        for _ in range(num_steps):
            lens = length_sampler(rng, n) * cfg.per_token_time
            busy += float(np.sum(lens))
            if cfg.mode == "sync_naive":
                # batch rollout, groups co-located (no replication)
                g = cfg.group_size
                groups = [lens[i:i + g] for i in range(0, n, g)] if g > 1 else None
                gen = (simulate_group_queue_completion(groups, k) if g > 1
                       else simulate_static_completion(lens, k))
            else:
                gen = simulate_queue_completion(lens, k)
            step = gen + train_t + cfg.weight_sync_time
            step_times.append(step)
            t += step
        util = busy / (k * t) if t else 0.0
        return PipelineResult(step_times, t, util,
                              staleness=[0] * (n * num_steps),
                              throughput=n * num_steps / t)

    # ---------------- async: event-driven producer/consumer -----------------
    assert cfg.train_gpus and cfg.infer_gpus, "async needs an explicit split"
    k = cfg.infer_gpus * cfg.slots_per_gpu
    capacity = int((1 + cfg.alpha) * n)
    train_t = _train_time(cfg, cfg.train_gpus)

    # state
    slot_free = [0.0] * k                  # next-free time per slot (heap)
    heapq.heapify(slot_free)
    completions: List[tuple[float, int]] = []  # (finish_time, version_started)
    buffer: List[tuple[float, int]] = []   # completed (finish_time, v_started)
    inflight = 0
    initiated = 0
    version = 0
    t = 0.0
    busy = 0.0
    step_times: List[float] = []
    staleness: List[int] = []

    def can_start() -> bool:
        # per-sample freshness gate (matches SampleBuffer._admissible):
        # the i-th initiated sample is consumed at version floor(i/N)
        return initiated < (version + cfg.alpha + 1) * n

    def start_one(now: float):
        nonlocal inflight, busy, initiated
        dur = float(length_sampler(rng, 1)[0]) * cfg.per_token_time
        t0 = max(heapq.heappop(slot_free), now)
        t1 = t0 + dur
        heapq.heappush(slot_free, t1)
        heapq.heappush(completions, (t1, version))
        inflight += 1
        initiated += 1
        busy += dur

    # fill the pipeline
    while can_start():
        start_one(0.0)

    for _ in range(num_steps):
        step_start = t
        # wait for n completed samples
        while len(buffer) < n:
            if not completions:
                raise RuntimeError("starved: no in-flight generation")
            ft, v = heapq.heappop(completions)
            t = max(t, ft)
            inflight -= 1
            buffer.append((ft, v))
            while can_start():
                start_one(t)
        # consume oldest-version-first
        buffer.sort(key=lambda x: x[1])
        batch, buffer[:] = buffer[:n], buffer[n:]
        # train + weight sync
        t += train_t + cfg.weight_sync_time
        version += 1
        staleness.extend(version - 1 - v for _, v in batch)
        # ABORT-continue: re-tag in-flight work older than alpha behind;
        # recomputation continues under the new policy (no time penalty,
        # freshness restored) — matches LLMProxy ABORT->reclaim semantics.
        floor_v = version - int(math.floor(cfg.alpha))
        retag = [(ft, max(v, floor_v)) for ft, v in completions]
        completions[:] = retag
        heapq.heapify(completions)
        while can_start():
            start_one(t)
        step_times.append(t - step_start)

    # busy counts launched work; clamp for the in-flight tail at makespan
    util = min(1.0, busy / (k * t)) if t else 0.0
    return PipelineResult(step_times, t, util, staleness,
                          throughput=n * num_steps / t)


# ---------------------------------------------------------------------------
# Agentic: env-level async + redundant environment rollout (Fig 9, 10, 11)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AgenticConfig:
    rollout_batch_size: int           # trajectories needed per step
    num_env_groups: int
    group_size: int
    k_slots: int
    turns: int = 5
    gen_time_sampler: Optional[Callable] = None   # (rng)->seconds per turn
    env_latency_mu: float = 10.0
    env_latency_sigma: float = 5.0
    env_async: bool = True            # release slot during env interaction
    p_fail_stop: float = 0.0          # trajectory never completes
    fail_slow_factor: float = 1.0     # latency multiplier for fail-slow envs
    p_fail_slow: float = 0.0


def simulate_agentic_step(rng: np.random.Generator, cfg: AgenticConfig) -> float:
    """One rollout step: collect rollout_batch_size trajectories from
    num_env_groups x group_size concurrent envs (redundant if product >
    batch).  Returns step completion time."""
    total = cfg.num_env_groups * cfg.group_size
    need = cfg.rollout_batch_size

    def gen_time():
        if cfg.gen_time_sampler is not None:
            return float(cfg.gen_time_sampler(rng))
        return float(rng.lognormal(mean=1.0, sigma=0.6))

    def env_latency():
        lat = max(0.05, rng.normal(cfg.env_latency_mu, cfg.env_latency_sigma))
        if cfg.p_fail_slow and rng.random() < cfg.p_fail_slow:
            lat *= cfg.fail_slow_factor
        return float(lat)

    # trajectory state machines scheduled over k generation slots
    slot_free = [0.0] * cfg.k_slots
    heapq.heapify(slot_free)
    finish_times: List[float] = []

    if not cfg.env_async:
        # batch-synchronized rollout: every turn is a barrier — generation for
        # all live trajectories runs as one batch through the slots, then the
        # whole batch waits for the SLOWEST environment interaction before the
        # next turn may start.  (This is the paper's baseline; the speedup of
        # env-level async therefore grows with latency VARIANCE, Fig 9.)
        alive = []
        for _i in range(total):
            hung = bool(cfg.p_fail_stop and rng.random() < cfg.p_fail_stop)
            alive.append(not hung)
        n_alive = sum(alive)
        if n_alive < need:
            raise RuntimeError("too many fail-stop envs to collect the batch")
        t = 0.0
        for turn in range(cfg.turns):
            gens = [gen_time() for _ in range(n_alive)]
            t += simulate_queue_completion(gens, cfg.k_slots)
            lats = sorted(env_latency() for _ in range(n_alive))
            if turn < cfg.turns - 1:
                # barrier on the slowest env still needed: with redundant
                # envs (n_alive > need) the batch can abandon the stragglers
                # beyond the need-th fastest.
                t += lats[min(need, n_alive) - 1]
        return t

    # env-level async: event-driven; during env latency the slot is free
    events: List[tuple[float, int, int]] = []  # (ready_time, traj_id, turn)
    for i in range(total):
        if cfg.p_fail_stop and rng.random() < cfg.p_fail_stop:
            continue  # never produces
        heapq.heappush(events, (0.0, i, 0))
    done: List[float] = []
    while events and len(done) < need:
        ready, traj, turn = heapq.heappop(events)
        t0 = max(heapq.heappop(slot_free), ready)
        t1 = t0 + gen_time()
        heapq.heappush(slot_free, t1)
        if turn + 1 >= cfg.turns:
            done.append(t1)
        else:
            heapq.heappush(events, (t1 + env_latency(), traj, turn + 1))
    if len(done) < need:
        raise RuntimeError("too many fail-stop envs to collect the batch")
    done.sort()
    return done[need - 1]


# ---------------------------------------------------------------------------
# length distributions (calibrated to the paper's setup)
# ---------------------------------------------------------------------------

def lognormal_lengths(mean_tokens: float, sigma: float = 1.0,
                      max_tokens: int = 32_768):
    """Long-tail response lengths: lognormal clipped at max context.

    Paper: Qwen3-8B-Base ~2k mean, Think ~11k mean, 32k max; tails exceed
    the median by >20x."""
    mu = math.log(mean_tokens) - sigma ** 2 / 2.0

    def sample(rng: np.random.Generator, n: int) -> np.ndarray:
        return np.minimum(rng.lognormal(mu, sigma, size=n), max_tokens)

    return sample


def gaussian_latency(mu: float, sigma: float):
    def sample(rng: np.random.Generator) -> float:
        return max(0.05, float(rng.normal(mu, sigma)))

    return sample
