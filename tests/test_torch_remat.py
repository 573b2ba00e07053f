"""Layer remat in the port's train step (``make_train_step(remat=)``, the
reference's default True; ``api.apply(..., remat=)`` runs every block under
``torch.utils.checkpoint``).

* In the port, ``remat=True`` and ``remat=False`` give the same loss and
  gradients (1e-6) for every family: dense, MoE (with its aux losses),
  RWKV-6, the hybrid pattern, the VLM and the enc-dec's encoder and
  decoder.
* One train step with remat matches the JAX step with ``remat=True`` for
  dense, MoE, RWKV-6 and hybrid, at the trainer parity tests' tolerances
  (1e-5 relative / 1e-6 absolute; AdamW ``eps`` 1e-3 as there).
* ``HostTrainer`` builds its step without remat, as the reference's does.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny
from repro import algos as jalgos
from repro.models import get_api as jget_api
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch import algos
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.models import get_api
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import remat_block
from repro_torch.train import OptConfig, make_train_step
from repro_torch.train import trainer as ttrainer
from repro_torch.train.optimizer import init_opt_state, tree_leaves

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
REMAT_TOL = dict(rtol=1e-6, atol=1e-6)
OPT = dict(learning_rate=1e-2, warmup_steps=2, weight_decay=0.1, eps=1e-3)
ARCHS = ["qwen3-4b", "qwen3-moe-235b-a22b", "rwkv6-3b", "recurrentgemma-9b",
         "paligemma-3b", "seamless-m4t-medium"]


def _cfg(arch):
    return tiny(arch, dtype="float32")


def _perturbed_params(jcfg, seed=0):
    """The reference's init with every float leaf moved by noise (its zero
    mixes and RG-LRU gates would leave paths untested)."""
    jp = jget_api(jcfg).init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 1)

    def move(x):
        x = np.asarray(x)
        if not np.issubdtype(x.dtype, np.floating):
            return x
        return (x + 0.05 * rng.standard_normal(x.shape)).astype(x.dtype)

    return jax.tree_util.tree_map(move, jp)


def _batch(cfg, seed, b=4, s=16):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    mask = np.zeros((b, s), np.float32)
    for i in range(b):
        lo = int(rng.integers(3, 8))
        mask[i, lo:lo + int(rng.integers(2, s - lo + 1))] = 1.0
    noise = lambda scale: (rng.normal(scale=scale, size=(b, s)) * mask).astype(np.float32)  # noqa: E731
    rewards = rng.normal(size=(b,)).astype(np.float32)
    batch = {
        "tokens": tokens, "mask": mask,
        "advantages": (rewards[:, None] * mask).astype(np.float32),
        "old_logprobs": noise(0.2) - 4.0 * mask, "prox_logprobs": noise(0.1) - 4.0 * mask,
        "ref_logprobs": noise(0.1) - 4.0 * mask,
        "is_positive": (rewards > 0).astype(np.float32),
    }
    if cfg.family == "vlm":
        batch["patches"] = rng.normal(size=(b, cfg.num_image_tokens, cfg.d_model)
                                      ).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.normal(size=(b, cfg.encoder_frames, cfg.d_model)
                                     ).astype(np.float32)
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_loss_and_gradients(arch):
    jcfg = _cfg(arch)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    api = get_api(cfg, device="cpu")
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, _perturbed_params(jcfg)),
                             "cpu")
    batch = _torch_batch(_batch(cfg, 3))
    loss_cfg = algos.LossConfig(kl_beta=0.05)
    moe_mode = "dense" if cfg.is_moe else "ep"
    out = {}
    for remat in (False, True):
        fn = ttrainer.make_loss_and_grad(api, loss_cfg, moe_mode=moe_mode, remat=remat)
        out[remat] = fn(params, batch)
    (l0, m0, g0), (l1, m1, g1) = out[False], out[True]
    np.testing.assert_allclose(float(l1), float(l0), **REMAT_TOL)
    for k in m0:
        np.testing.assert_allclose(float(m1[k]), float(m0[k]), err_msg=k, **REMAT_TOL)
    if cfg.is_moe:
        assert float(m0["load_balance_loss"]) > 0          # the aux losses pass through
    for a, b in zip(tree_leaves(g0), tree_leaves(g1), strict=True):
        np.testing.assert_allclose(b.numpy(), a.numpy(), **REMAT_TOL)
    # the step itself, remat on by default as in the reference
    state = {"params": params, "opt": init_opt_state(params)}
    new, metrics = make_train_step(api, loss_cfg, OptConfig(**OPT), moe_mode=moe_mode)(
        state, batch)
    np.testing.assert_allclose(float(metrics["loss"]), float(l0), **REMAT_TOL)


def test_remat_block_recomputes_the_forward_in_the_backward():
    calls = []

    def block(x, w):
        calls.append(1)
        return torch.tanh(x @ w)

    x = torch.randn(3, 4, requires_grad=True)
    w = torch.randn(4, 4, requires_grad=True)
    assert remat_block(block, False) is block
    y = remat_block(block, True)(x, w)
    assert len(calls) == 1
    y.sum().backward()
    assert len(calls) == 2                      # the forward again, in the backward
    gx, gw = x.grad.clone(), w.grad.clone()
    x.grad = w.grad = None
    block(x, w).sum().backward()
    torch.testing.assert_close(x.grad, gx, rtol=0, atol=0)
    torch.testing.assert_close(w.grad, gw, rtol=0, atol=0)


@pytest.mark.parametrize("arch", ARCHS[:4])
def test_remat_train_step_matches_the_reference(arch):
    jcfg = _cfg(arch)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    moe_mode = "dense" if cfg.is_moe else "ep"
    jp = _perturbed_params(jcfg)
    japi = jget_api(jcfg)
    jloss = jalgos.LossConfig(kl_beta=0.05)
    jstep = jax.jit(jtrainer.make_train_step(japi, jloss, jopt.OptConfig(**OPT), remat=True,
                                             moe_mode=moe_mode))
    batch = _batch(cfg, 5)
    jstate, jm = jstep({"params": jax.tree_util.tree_map(jnp.asarray, jp),
                        "opt": jopt.init_opt_state(jp)},
                       {k: jnp.asarray(v) for k, v in batch.items()})
    tapi = get_api(cfg, device="cpu")
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    tstep = make_train_step(tapi, algos.LossConfig(**dataclasses.asdict(jloss)),
                            OptConfig(**OPT), remat=True, moe_mode=moe_mode)
    tstate, tm = tstep({"params": tp, "opt": init_opt_state(tp)}, _torch_batch(batch))
    assert set(jm) == set(tm)
    for k in jm:
        np.testing.assert_allclose(np.asarray(jm[k]), float(tm[k]), err_msg=k, **TOL)
    got = dict(jax.tree_util.tree_leaves_with_path(params_to_numpy(tstate["params"], cfg)))
    want = jax.tree_util.tree_leaves_with_path(jstate["params"])
    assert len(want) == len(got)
    for path, w in want:
        np.testing.assert_allclose(np.asarray(w, np.float32), got[path],
                                   err_msg=jax.tree_util.keystr(path), **TOL)


def test_host_trainer_builds_its_steps_without_remat(monkeypatch):
    """The reference's HostTrainer passes ``remat=False`` (and its critic
    defaults to it): so do the port's."""
    from repro_torch.train import HostTrainer, TrainerConfig
    from repro_torch.train import critic as tcritic

    seen = []
    real_step, real_critic = ttrainer.make_train_step, tcritic.make_critic_train_step
    monkeypatch.setattr(ttrainer, "make_train_step",
                        lambda *a, **kw: seen.append(("grpo", kw.get("remat")))
                        or real_step(*a, **kw))
    monkeypatch.setattr(tcritic, "make_critic_train_step",
                        lambda *a, **kw: seen.append(("gae", kw.get("remat", False)))
                        or real_critic(*a, **kw))
    cfg = ModelConfig(**dataclasses.asdict(_cfg("qwen3-4b")))
    api = get_api(cfg, device="cpu")
    for est in ("grpo", "gae"):
        HostTrainer(api, 0, algos.LossConfig(), OptConfig(), TrainerConfig(adv_estimator=est))
    assert seen == [("grpo", False), ("gae", False)]
