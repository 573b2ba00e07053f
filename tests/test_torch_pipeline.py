"""The port's asynchronous pipeline (``repro_torch.launch.pipeline``) on the
CPU at tiny sizes: engine selection, one synchronous step in lockstep with
the JAX pipeline, the asynchronous two-replica fleet with overlapped weight
sync, a failover driven in lockstep, the agentic pipeline, the recurrent
families' trainer, and the ``launch/train.py`` command line."""
import dataclasses
import json
import os
import subprocess
import sys
from collections import Counter
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from conftest import tiny
from repro.launch import pipeline as jpipeline
from repro_torch.algos import LossConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.faults import FaultyProxy
from repro_torch.core.llm_proxy import LLMProxy
from repro_torch.core.rollout_client import RolloutClient
from repro_torch.core.router import ProxyRouter
from repro_torch.core.types import RolloutTask, next_uid
from repro_torch.envs import GridTargetEnv
from repro_torch.launch.pipeline import (PipelineSettings, build_agentic_pipeline,
                                         build_rlvr_pipeline, make_rollout_engine)
from repro_torch.models import ModelConfig, get_api, rglru, rwkv6, transformer
from repro_torch.rollout import DecodeEngine, PagedDecodeEngine
from repro_torch.train import HostTrainer, OptConfig, TrainerConfig
from repro_torch.train.optimizer import init_opt_state, tree_map

torch.set_num_threads(1)
pytestmark = pytest.mark.timeout(240)

ROOT = Path(__file__).resolve().parent.parent
JAX_MODEL = tiny("qwen3-4b", vocab_size=32, dtype="float32")
SMALL = dict(rollout_batch_size=4, num_return_sequences_in_group=2, num_slots=4,
             max_new_tokens=4, max_seq_len=32, page_size=8, prefill_chunk=8)


def _port(cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(cfg))


MODEL = _port(JAX_MODEL)


def _reward(sample) -> float:
    """Differs within a greedy group (whose responses are equal), so that
    the GRPO advantages, and the loss, are not zero."""
    return float(sample.replica_idx) + 0.1 * float(np.sum(sample.response_tokens) % 5)


def _record(pipe) -> list:
    """Wrap the controller's train function to keep every batch it gets."""
    batches, train = [], pipe.controller.train_fn

    def recorded(samples):
        batches.append(list(samples))
        return train(samples)
    pipe.controller.train_fn = recorded
    return batches


# ------------------------------------------------------------ engine choice
def test_engine_selection():
    api = get_api(MODEL, device="cpu")
    params = api.init(0)
    assert isinstance(make_rollout_engine(api, params, PipelineSettings()),
                      PagedDecodeEngine)
    eng = make_rollout_engine(api, params, PipelineSettings(rollout_engine="slot"))
    assert isinstance(eng, DecodeEngine) and eng.attn_impl == "kernel"
    with pytest.raises(ValueError, match="rollout_engine"):
        make_rollout_engine(api, params, PipelineSettings(rollout_engine="bogus"))
    with pytest.raises(ValueError, match="kernel \\| ref"):
        make_rollout_engine(api, params, PipelineSettings(attn_impl="kernel_interpret"))
    with pytest.raises(ValueError, match="kv_quant"):
        make_rollout_engine(api, params,
                            PipelineSettings(rollout_engine="slot", kv_quant="int8"))
    with pytest.raises(ValueError, match="kernel \\| ref"):
        build_rlvr_pipeline(MODEL, PipelineSettings(attn_impl="kernel_interpret"),
                            device="cpu")


@pytest.mark.parametrize("arch", ["rwkv6-3b", "recurrentgemma-9b"])
def test_auto_picks_the_slot_engine_for_recurrent_families(arch):
    api = get_api(_port(tiny(arch, vocab_size=32, sliding_window=32)), device="cpu")
    assert api.init_paged_cache is None
    eng = make_rollout_engine(api, api.init(0), PipelineSettings(attn_impl="ref"))
    assert isinstance(eng, DecodeEngine) and eng.attn_impl == "ref"


# ------------------------------------------------- lockstep with the JAX one
def test_sync_step_matches_the_jax_pipeline():
    """alpha = 0, one replica, greedy: the same first batch (prompts,
    responses, rewards; behaviour logprobs at 1e-5) and the same loss (1e-5
    relative) as the JAX pipeline from the same weights.

    Greedy replicas of a prompt are identical samples, and GRPO's advantages
    sum to zero over a group, so the policy-gradient term of the first step
    is zero in both: both trainers get the same frozen reference policy and
    a KL weight, whose term is not."""
    kw = dict(SMALL, async_generation_ratio=0, kl_beta=0.1)
    jpipe = jpipeline.build_rlvr_pipeline(JAX_MODEL, jpipeline.PipelineSettings(**kw),
                                          reward_fn=_reward)
    tpipe = build_rlvr_pipeline(MODEL, PipelineSettings(**kw), reward_fn=_reward,
                                device="cpu")

    def to_port(tree):
        return params_from_jax(jax.tree_util.tree_map(np.asarray, tree), "cpu")
    tp = to_port(jpipe.trainer.state["params"])
    tpipe.trainer.state = {"params": tp, "opt": init_opt_state(tp)}
    jpipe.trainer.ref_params = jpipe.trainer.api.init(jax.random.PRNGKey(7))
    tpipe.trainer.ref_params = to_port(jpipe.trainer.ref_params)
    for e in tpipe.engines:
        e.update_weights(tp)
    for pipe in (jpipe, tpipe):
        pipe.engine.temperature = 0.0
    jbatches, tbatches = _record(jpipe), _record(tpipe)
    jstats, tstats = jpipe.run(1, timeout=120), tpipe.run(1, timeout=120)

    def keyed(batch):
        return sorted(((tuple(np.asarray(s.prompt_tokens).tolist()),
                        tuple(np.asarray(s.response_tokens).tolist()), s.reward),
                       np.asarray(s.logprobs, np.float64)) for s in batch)
    jb, tb = keyed(jbatches[0]), keyed(tbatches[0])
    assert len(tb) == 4 and [k for k, _ in jb] == [k for k, _ in tb]
    for (_, jl), (_, tl) in zip(jb, tb):
        np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-5)
    assert jstats[0].loss > 1e-4
    assert tstats[0].loss == pytest.approx(jstats[0].loss, rel=1e-5)
    # the sync handed the engine the trainer's tree itself
    assert tpipe.buffer.version == 1
    assert tpipe.engine.params is tpipe.trainer.get_weights()
    assert tpipe.trainer.get_weights() is not tp
    tpipe.engine.audit_pages()


# ------------------------------------------------ async, two replicas
def test_async_two_replicas_overlapped_sync():
    s = PipelineSettings(**SMALL, async_generation_ratio=1, num_rollout_replicas=2,
                         weight_sync="overlapped")
    pipe = build_rlvr_pipeline(MODEL, s, device="cpu")
    assert pipe.router is not None and len(pipe.engines) == 2
    assert all(e.num_slots == 2 for e in pipe.engines)
    stats = pipe.run(2, timeout=120)
    assert [st.step for st in stats] == [0, 1]
    assert max(st.staleness_max for st in stats) <= 1
    assert pipe.buffer.version == 2             # one advance per step
    assert pipe.buffer.total_consumed == 2 * s.rollout_batch_size
    assert pipe.trainer.steps_done == 2
    for e in pipe.engines:
        assert e.params is pipe.trainer.get_weights()
        e.audit_pages()
    assert pipe.router.replicas_alive == 2
    assert all(len(st.active_per_replica) == 2 for st in stats)


# ------------------------------------------------ failover, in lockstep
def _task(budget, prompt) -> RolloutTask:
    return RolloutTask(task_id=next_uid(), prompt_id=0, replica_idx=0,
                       prompt_tokens=np.asarray(prompt, np.int32),
                       max_new_tokens=budget)


def test_failover_in_lockstep_resolves_every_handle_once():
    """Replica 1 dies at its third step (not on a clock): every handle
    resolves exactly once, with the tokens of an uninterrupted greedy run."""
    s = PipelineSettings(**dict(SMALL, num_slots=2, max_new_tokens=12))
    api = get_api(MODEL, device="cpu")
    params = api.init(0)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(3, 30, n).astype(np.int32) for n in (5, 7, 4, 9)]

    def engine():
        e = make_rollout_engine(api, params, s)
        e.temperature, e.eos_id = 0.0, -1
        return e

    def pump(proxies, router=None):
        for _ in range(2000):
            live = [p for i, p in enumerate(proxies)
                    if router is None or router.replica_state(i) != "dead"]
            stepped = [p.step_once() for p in live]
            if router is not None:
                router.probe_health()
            if not any(stepped) and all(p.num_active == 0 and p.num_pending == 0
                                        for p in live):
                return
        raise AssertionError("fleet did not quiesce")

    ref_proxy = LLMProxy(engine())
    ref_client = RolloutClient(ref_proxy, version_fn=lambda: 0)
    ref_handles = [ref_client.submit(_task(12, p)) for p in prompts]
    pump([ref_proxy])
    ref = [list(h.result(0).tokens) for h in ref_handles]

    proxies = [FaultyProxy(LLMProxy(engine(), name=f"replica_{i}"),
                           kill_after_steps=3 if i == 1 else None) for i in range(2)]
    router = ProxyRouter(proxies)
    client = RolloutClient(router, version_fn=lambda: 0)
    handles = [client.submit(_task(12, p)) for p in prompts]
    fired = Counter()
    for h in handles:
        h.add_done_callback(lambda res, h=h: fired.update([id(h)]))
    pump(proxies, router)
    out = [list(h.result(0).tokens) for h in handles]
    assert out == ref
    assert fired == Counter({id(h): 1 for h in handles})
    assert proxies[1].kills == 1 and router.replica_state(1) == "dead"
    assert router.failovers >= 1 and router.replicas_alive == 1
    router.fleet_audit()
    proxies[0].engine.audit_pages()


# ------------------------------------------------------------------ agentic
@pytest.mark.parametrize("replicas", [1, 2])
def test_agentic_pipeline_one_step(replicas):
    s = PipelineSettings(**dict(SMALL, max_new_tokens=3), async_generation_ratio=1,
                         num_rollout_replicas=replicas)
    # the grid's observation tokens run up to 134
    pipe = build_agentic_pipeline(
        _port(tiny("qwen3-4b", vocab_size=256, dtype="float32")), s,
        make_env=lambda i: GridTargetEnv(i, max_steps=2),
        num_env_groups=2, group_size=2, max_env_steps=2, device="cpu")
    stats = pipe.run(1, timeout=60)
    assert len(stats) == 1 and pipe.buffer.total_consumed == 4
    assert pipe.trainer.steps_done == 1 and len(pipe.engines) == replicas
    assert (pipe.router is None) == (replicas == 1)
    assert not any(m.is_alive() for m in pipe.pool.managers)
    for e in pipe.engines:
        assert e.params is pipe.trainer.get_weights()
        e.audit_pages()


# ------------------------------------------------- recurrent families train
@pytest.mark.parametrize("arch", ["rwkv6-3b", "recurrentgemma-9b"])
def test_recurrent_pipeline_trains_one_step(arch, monkeypatch):
    cfg = _port(tiny(arch, vocab_size=32, sliding_window=32, dtype="float32"))
    pipe = build_rlvr_pipeline(cfg, PipelineSettings(**SMALL, async_generation_ratio=1,
                                                     pg_variant="decoupled_ppo"),
                               device="cpu")
    assert isinstance(pipe.engine, DecodeEngine)
    assert pipe.settings.attn_impl == "kernel"
    batches = _record(pipe)
    stats = pipe.run(1, timeout=120)
    assert len(stats) == 1 and np.isfinite(stats[0].loss)
    assert pipe.engine.params is pipe.trainer.get_weights()

    # the scan kernels have no backward: a differentiated forward on the
    # kernel route raises
    api, trainer = pipe.trainer.api, pipe.trainer
    live = tree_map(lambda t: t.detach().requires_grad_(True), trainer.get_weights())
    tokens = torch.from_numpy(trainer.build_batch(batches[0])["tokens"])
    with pytest.raises(RuntimeError, match="no backward"):
        api.apply(live, {"tokens": tokens}, attn_impl="kernel", scan_impl="kernel")

    # so the choice is per op: the train step runs the plain scans under
    # autograd, the proximal logprob pass (no gradient) the scan kernel's
    # wrapper
    module, name = (rwkv6, "rwkv6_scan") if cfg.family == "ssm" else (rglru, "rglru_scan")
    wrapper, calls = getattr(module, name), []

    def counted(*args):
        calls.append(torch.is_grad_enabled() and any(a.requires_grad for a in args))
        return wrapper(*args)
    monkeypatch.setattr(module, name, counted)
    trainer.train_on_samples(batches[0])
    n_scans = sum(kind != "attn" for kind, _ in transformer.layer_kinds(cfg)) \
        if cfg.family == "hybrid" else cfg.num_layers
    assert len(calls) == n_scans and not any(calls)


# ---------------------------------------------------------------------- CLI
def test_train_cli_on_the_cpu(tmp_path):
    out = tmp_path / "stats.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--preset", "demo", "--steps", "1", "--rollout-replicas", "2",
         "--out", str(out)],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=180)
    assert run.returncode == 0, run.stderr
    stats = json.loads(out.read_text())
    assert len(stats) == 1 and stats[0]["step"] == 0
    assert stats[0]["replicas_alive"] == 2
    assert "fleet: replicas=2" in run.stdout
