"""Propositions 1 & 2 vs the discrete-event simulator (property-based), on
the port's copies (``repro_torch.core.simulator`` and ``.theory``): the
twin of ``tests/test_theory_sim.py``."""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro_torch.core import simulator as S
from repro_torch.core import theory as T


@given(n=st.integers(1, 200), k=st.integers(1, 64), seed=st.integers(0, 999))
@settings(max_examples=50, deadline=None)
def test_prop1_queue_completion_bound(n, k, seed):
    rng = np.random.default_rng(seed)
    durs = rng.lognormal(0.0, 1.2, size=n)
    t = S.simulate_queue_completion(durs, k)
    bound = T.prop1_completion_bound(n, k, float(durs.mean()), float(durs.max()))
    assert t <= bound + 1e-9


@given(n=st.integers(2, 100), k=st.integers(1, 32), seed=st.integers(0, 999))
@settings(max_examples=50, deadline=None)
def test_queue_within_graham_bound_of_static(n, k, seed):
    """Greedy list scheduling is NOT pointwise <= a lucky static partition
    (hypothesis found the counterexample), but Graham's bound guarantees
    queue <= (2 - 1/k) * OPT <= (2 - 1/k) * static."""
    rng = np.random.default_rng(seed)
    durs = rng.lognormal(0.0, 1.5, size=n)
    q = S.simulate_queue_completion(durs, k)
    s = S.simulate_static_completion(durs, k)
    assert q <= (2.0 - 1.0 / k) * s + 1e-9


def test_queue_beats_static_on_average():
    rng = np.random.default_rng(0)
    wins = 0
    for _ in range(200):
        durs = rng.lognormal(0.0, 1.5, size=64)
        q = S.simulate_queue_completion(durs, 8)
        s = S.simulate_static_completion(durs, 8)
        wins += q <= s + 1e-9
    assert wins >= 175  # queue scheduling dominates under long tails


@given(seed=st.integers(0, 200), alpha=st.sampled_from([0.0, 1.0, 2.0, 4.0]))
@settings(max_examples=25, deadline=None)
def test_async_pipeline_staleness_bounded(seed, alpha):
    cfg = S.PipelineConfig(rollout_batch_size=16, gpus=8, train_gpus=4,
                           infer_gpus=4, slots_per_gpu=4, per_token_time=0.001,
                           mu_train_per_sample=0.01, train_overhead=0.5,
                           alpha=alpha, mode="async")
    res = S.simulate_pipeline(np.random.default_rng(seed), cfg, 10,
                              S.lognormal_lengths(500, 1.0))
    assert max(res.staleness) <= alpha
    assert min(res.staleness) >= 0


@given(seed=st.integers(0, 100))
@settings(max_examples=15, deadline=None)
def test_async_beats_sync_naive_under_long_tail(seed):
    """Theory: async >= sync throughput whenever tails are heavy (Prop 2)."""
    base = dict(rollout_batch_size=64, group_size=8, gpus=16, slots_per_gpu=8,
                per_token_time=0.001, mu_train_per_sample=0.05,
                train_overhead=2.0)
    sampler = S.lognormal_lengths(2000, 1.2)
    naive = S.simulate_pipeline(np.random.default_rng(seed),
                                S.PipelineConfig(**base, mode="sync_naive"), 8,
                                sampler)
    asy = S.simulate_pipeline(np.random.default_rng(seed),
                              S.PipelineConfig(**base, mode="async",
                                               train_gpus=8, infer_gpus=8,
                                               alpha=2), 8, sampler)
    assert asy.throughput > naive.throughput


def test_prop2_optimal_beta_balances_pipelines():
    n, k, mu_g, l_g, mu_t, e, alpha = 256, 64, 5.0, 100.0, 1.0, 1.0, 2.0
    beta = T.prop2_optimal_beta(n, k, mu_g, l_g, mu_t, e, alpha)
    assert 0.0 < beta < 1.0
    gen = n / ((1 - beta) * k) * mu_g + l_g / ((alpha + 1) * (1 - beta))
    train = e * n / (beta * k) * mu_t
    np.testing.assert_allclose(gen, train, rtol=1e-9)
    # eq (11): the balanced bound
    bound = T.prop2_async_bound(n, k, mu_g, l_g, mu_t, e, alpha, beta)
    np.testing.assert_allclose(
        bound, T.prop2_async_bound_at_optimum(n, k, mu_g, l_g, mu_t, e, alpha),
        rtol=1e-6)


@given(alpha=st.floats(0.5, 16.0))
@settings(max_examples=20, deadline=None)
def test_prop2_async_tighter_than_sync(alpha):
    """Eq 11 <= eq 8 strictly for alpha > 0."""
    n, k, mu_g, l_g, mu_t, e = 256, 64, 5.0, 100.0, 1.0, 1.0
    sync = T.prop2_sync_bound(n, k, mu_g, l_g, mu_t, e)
    asyb = T.prop2_async_bound_at_optimum(n, k, mu_g, l_g, mu_t, e, alpha)
    assert asyb < sync


def test_prop1_max_speedup_formula():
    assert T.prop1_max_speedup(mu_gen=10.0, l_gen=90.0) == pytest.approx(10.0)


def test_env_async_speedup_grows_with_variance():
    """Fig 9 left: higher sigma -> bigger env-level-async speedup."""
    speedups = []
    for sigma in (1.0, 10.0):
        cfg = S.AgenticConfig(rollout_batch_size=128, num_env_groups=16,
                              group_size=8, k_slots=32, turns=5,
                              env_latency_mu=10.0, env_latency_sigma=sigma,
                              env_async=False)
        t_sync = S.simulate_agentic_step(np.random.default_rng(0), cfg)
        cfg_async = S.AgenticConfig(**{**cfg.__dict__, "env_async": True})
        t_async = S.simulate_agentic_step(np.random.default_rng(0), cfg_async)
        speedups.append(t_sync / t_async)
    assert speedups[1] > speedups[0] >= 1.0


def test_redundant_env_rollout_tolerates_fail_stop():
    cfg = S.AgenticConfig(rollout_batch_size=64, num_env_groups=10,
                          group_size=8, k_slots=32, turns=3,
                          env_latency_mu=5.0, env_latency_sigma=2.0,
                          env_async=True, p_fail_stop=0.1)
    t = S.simulate_agentic_step(np.random.default_rng(0), cfg)
    assert np.isfinite(t)
    # without redundancy the same failure rate cannot fill the batch
    cfg_exact = S.AgenticConfig(**{**cfg.__dict__, "num_env_groups": 8,
                                   "p_fail_stop": 0.4})
    with pytest.raises(RuntimeError):
        S.simulate_agentic_step(np.random.default_rng(1), cfg_exact)


def test_filtered_rollout_queue_faster_than_batch():
    kw = dict(batch_groups=8, group_size=8, k_slots=64,
              length_sampler=S.lognormal_lengths(1000, 1.0),
              per_token_time=0.001, p_filter=0.4)
    b = S.simulate_filtered_rollout(np.random.default_rng(0), mode="batch", **kw)
    q = S.simulate_filtered_rollout(np.random.default_rng(0), mode="queue",
                                    extra_prompts=16, **kw)
    assert q.gen_time < b.gen_time
