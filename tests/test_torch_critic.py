"""The port's critic (``repro_torch.train.critic``: PPO with GAE and a value
head) against the JAX package's, from one carried-across state
(``convert.state_from_jax``): one critic step for a dense, an MoE and an
RWKV-6 config, two ``HostTrainer(adv_estimator="gae")`` calls, the
reference's value-loss-falls test as a twin, and one synchronous
``build_rlvr_pipeline`` step with ``adv_estimator="gae"``.

Tolerance: 1e-5 relative / 1e-6 absolute on every number, AdamW eps 1e-3
(``test_torch_trainer.py`` says why)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny
from repro import algos as jalgos
from repro.core.types import Sample as JSample
from repro.launch import pipeline as jpipeline
from repro.models import get_api as jget_api
from repro.train import critic as jcritic
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch import algos
from repro_torch.convert import params_to_numpy, state_from_jax
from repro_torch.core.types import Sample
from repro_torch.launch.pipeline import PipelineSettings, build_rlvr_pipeline
from repro_torch.models import ModelConfig, get_api
from repro_torch.train import (HostTrainer, OptConfig, TrainerConfig,
                               make_critic_train_state, make_critic_train_step)
from repro_torch.train.optimizer import tree_map

torch.set_num_threads(1)
pytestmark = pytest.mark.timeout(240)

TOL = dict(rtol=1e-5, atol=1e-6)
OPT = dict(learning_rate=1e-2, warmup_steps=2, weight_decay=0.1, eps=1e-3)


def _port(cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(cfg))


def _jax_state(japi, seed, perturb=False):
    """The JAX critic state; ``perturb`` moves every param leaf (the
    reference initialises RWKV-6's mixes to zero)."""
    state = jcritic.make_critic_train_state(japi, jax.random.PRNGKey(seed))
    if perturb:
        rng = np.random.default_rng(7)
        params = jax.tree_util.tree_map(
            lambda a: a + 0.05 * rng.normal(size=a.shape).astype(a.dtype),
            state["params"])
        state = dict(state, params=params, opt=jopt.init_opt_state(params))
    return state


def _to_port(jstate):
    return state_from_jax(jax.tree_util.tree_map(np.asarray, jstate), "cpu")


def _close_tree(want, got, what):
    jl = jax.tree_util.tree_leaves_with_path(want)
    gl = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(jl) == len(gl), what
    for path, w in jl:
        np.testing.assert_allclose(np.asarray(w, np.float32), gl[path],
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}", **TOL)


def _value_numpy(tree):
    return tree_map(lambda t: t.detach().numpy(), tree)


def _close_state(jstate, tstate):
    _close_tree(jstate["params"], params_to_numpy(tstate["params"]), "params")
    _close_tree(jstate["value"], _value_numpy(tstate["value"]), "value")
    for key in ("master", "m", "v"):
        _close_tree(jstate["opt"][key], params_to_numpy(tstate["opt"][key]), key)
        _close_tree(jstate["vopt"][key], _value_numpy(tstate["vopt"][key]), "v" + key)
    assert tstate["opt"]["step"] == int(jstate["opt"]["step"])
    assert tstate["vopt"]["step"] == int(jstate["vopt"]["step"])


def _batch(japi, jparams, seed, b=4, s=16):
    """Rewards of both signs, ragged response spans, behaviour logprobs
    near the policy's (so that PPO's clip is in play)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, japi.cfg.vocab_size, (b, s)).astype(np.int32)
    mask = np.zeros((b, s), np.float32)
    for i in range(b):
        lo = int(rng.integers(3, 8))
        mask[i, lo:lo + int(rng.integers(2, s - lo + 1))] = 1.0
    lp = np.asarray(jtrainer.make_logprob_fn(japi, moe_mode="dense")(
        jparams, {"tokens": jnp.asarray(tokens)}))

    def noisy(scale):
        return ((lp + rng.normal(scale=scale, size=lp.shape)) * mask).astype(np.float32)
    rewards = rng.normal(size=(b,)).astype(np.float32)
    return {"tokens": tokens, "mask": mask, "advantages": np.zeros_like(mask),
            "rewards": rewards, "old_logprobs": noisy(0.2),
            "prox_logprobs": noisy(0.1), "ref_logprobs": noisy(0.1),
            "is_positive": (rewards > 0).astype(np.float32)}


@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen3-moe-235b-a22b", "rwkv6-3b"])
def test_critic_step_matches(arch):
    cfg = tiny(arch, dtype="float32", vocab_size=32)
    japi = jget_api(cfg)
    jstate = _jax_state(japi, 0, perturb=cfg.family == "ssm")
    tstate = _to_port(jstate)
    moe_mode = "dense" if cfg.is_moe else "ep"
    jloss = jalgos.LossConfig(pg_variant="ppo", kl_beta=0.05)
    batch = _batch(japi, jstate["params"], 1)
    jstep = jax.jit(jcritic.make_critic_train_step(japi, jloss, jopt.OptConfig(**OPT),
                                                   moe_mode=moe_mode))
    jnew, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})

    tapi = get_api(_port(cfg), device="cpu")
    tstep = make_critic_train_step(tapi, algos.LossConfig(**dataclasses.asdict(jloss)),
                                   OptConfig(**OPT), moe_mode=moe_mode)
    tnew, tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})

    assert set(jm) == set(tm) >= {"loss", "value_loss", "explained_value", "grad_norm"}
    for k in jm:
        np.testing.assert_allclose(np.asarray(jm[k]), float(tm[k]), err_msg=k, **TOL)
    assert float(tm["value_loss"]) > 1e-3
    _close_state(jnew, tnew)
    # the value loss reached the trunk: the head and the params both moved
    assert not torch.equal(tnew["value"]["w"], tstate["value"]["w"])


# ---------------------------------------------------------------------------
# HostTrainer
# ---------------------------------------------------------------------------

def _samples(vocab, seed, groups=2, group_size=4):
    rng = np.random.default_rng(seed)
    out = []
    for g in range(groups):
        prompt = rng.integers(0, vocab, int(rng.integers(3, 9))).astype(np.int32)
        for j in range(group_size):
            r = rng.integers(0, vocab, int(rng.integers(2, 8))).astype(np.int32)
            out.append(dict(sample_id=len(out), prompt_id=g, replica_idx=j,
                            prompt_tokens=prompt, response_tokens=r,
                            logprobs=(-rng.random(len(r)) * 3).astype(np.float32),
                            reward=float(rng.integers(0, 2)), group_id=g))
    rng.shuffle(out)
    return out


def test_host_trainer_gae_matches_twice():
    cfg = tiny("qwen3-4b", dtype="float32", vocab_size=32)
    japi = jget_api(cfg)
    tcfg = dict(max_seq_len=16, group_size=4, minibatches=2, adv_estimator="gae")
    loss = dict(pg_variant="decoupled_ppo")
    jt = jtrainer.HostTrainer(japi, jax.random.PRNGKey(1), jalgos.LossConfig(**loss),
                              jopt.OptConfig(**OPT), jtrainer.TrainerConfig(**tcfg))
    tt = HostTrainer(get_api(_port(cfg), device="cpu"), 1, algos.LossConfig(**loss),
                     OptConfig(**OPT), TrainerConfig(**tcfg))
    assert set(tt.state) == set(jt.state) == {"params", "value", "opt", "vopt"}
    tt.state = _to_port(jt.state)
    for call in range(2):
        raw = _samples(cfg.vocab_size, 10 + call)
        wm = jt.train_on_samples([JSample(**s) for s in raw])
        gm = tt.train_on_samples([Sample(**s) for s in raw])
        assert set(wm) == set(gm)
        for k in wm:
            np.testing.assert_allclose(wm[k], gm[k], err_msg=f"call {call} {k}", **TOL)
    _close_state(jt.state, tt.state)
    assert tt.steps_done == 2 and tt.state["opt"]["step"] == tt.state["vopt"]["step"] == 4
    assert tt.get_weights() is tt.state["params"]


def test_critic_ppo_train_step():
    """The twin of ``tests/test_algos.py::test_critic_ppo_train_step``:
    finite losses, and the value head learns the terminal rewards."""
    cfg = _port(tiny("qwen3-4b"))
    api = get_api(cfg, device="cpu")
    state = make_critic_train_state(api, 0)
    assert state["value"]["w"].shape == (cfg.d_model, 1)
    assert state["value"]["w"].dtype == state["value"]["b"].dtype == torch.float32
    step = make_critic_train_step(api, algos.LossConfig(pg_variant="ppo"),
                                  OptConfig(learning_rate=1e-2, warmup_steps=1))
    b, s = 4, 16
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, dtype=torch.int32)
    mask = torch.zeros(b, s)
    mask[:, s // 2:] = 1.0
    lp = -torch.randn(b, s, generator=gen).abs()
    rewards = torch.tensor([1.0, 0.0, 1.0, 0.0])
    batch = dict(tokens=tokens, mask=mask, rewards=rewards, advantages=mask * 0.0,
                 old_logprobs=lp, prox_logprobs=lp, ref_logprobs=lp, is_positive=rewards)
    vlosses = []
    for _ in range(8):
        state, metrics = step(state, batch)
        assert torch.isfinite(metrics["loss"])
        vlosses.append(float(metrics["value_loss"]))
    assert vlosses[-1] < vlosses[0]  # critic fits the terminal rewards


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

def _reward(sample) -> float:
    return float(sample.replica_idx) + 0.1 * float(np.sum(sample.response_tokens) % 5)


def _record(pipe) -> list:
    batches, train = [], pipe.controller.train_fn

    def recorded(samples):
        batches.append(list(samples))
        return train(samples)
    pipe.controller.train_fn = recorded
    return batches


def test_gae_pipeline_step_matches_the_jax_pipeline():
    """alpha = 0, one replica, greedy, ``adv_estimator="gae"``: the same
    first batch and the same loss (1e-5 relative) as the JAX pipeline from
    one critic state; the engine then holds the trainer's new tree."""
    jcfg = tiny("qwen3-4b", vocab_size=32, dtype="float32")
    kw = dict(rollout_batch_size=4, num_return_sequences_in_group=2, num_slots=4,
              max_new_tokens=4, max_seq_len=32, page_size=8, prefill_chunk=8,
              async_generation_ratio=0, adv_estimator="gae")
    jpipe = jpipeline.build_rlvr_pipeline(jcfg, jpipeline.PipelineSettings(**kw),
                                          reward_fn=_reward)
    tpipe = build_rlvr_pipeline(_port(jcfg), PipelineSettings(**kw), reward_fn=_reward,
                                device="cpu")
    assert set(tpipe.trainer.state) == {"params", "value", "opt", "vopt"}
    tpipe.trainer.state = _to_port(jpipe.trainer.state)
    for e in tpipe.engines:
        e.update_weights(tpipe.trainer.get_weights())
    for pipe in (jpipe, tpipe):
        pipe.engine.temperature = 0.0
    jbatches, tbatches = _record(jpipe), _record(tpipe)
    jstats, tstats = jpipe.run(1, timeout=120), tpipe.run(1, timeout=120)

    def keyed(batch):
        return sorted((tuple(np.asarray(s.prompt_tokens).tolist()),
                       tuple(np.asarray(s.response_tokens).tolist()), s.reward)
                      for s in batch)
    assert len(tbatches[0]) == 4 and keyed(jbatches[0]) == keyed(tbatches[0])
    assert abs(jstats[0].loss) > 1e-4
    assert tstats[0].loss == pytest.approx(jstats[0].loss, rel=1e-5)
    assert tpipe.buffer.version == 1
    assert tpipe.engine.params is tpipe.trainer.get_weights()
    assert tpipe.trainer.state["vopt"]["step"] == 1
    tpipe.engine.audit_pages()
