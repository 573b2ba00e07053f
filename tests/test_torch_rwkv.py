"""The port's RWKV-6 family against the JAX package on the same inputs and
the same weights (carried across by ``params_from_jax``): one block, the
full model's prefill, decode and apply, with their states; one train step
through the plain scan, and the scan kernel's refusal to be differentiated.

Tolerance: fp32 1e-5 (the two frameworks reduce in different orders; the
recurrence carries a state, so errors accumulate over steps).  On the CPU
``attn_impl="kernel"`` runs the scan kernel's plain version, so both
values of the switch are held to the reference."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny
from repro import algos as jalgos
from repro.models import get_api as jget_api
from repro.models import rwkv6 as jrwkv6
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch import algos
from repro_torch.convert import params_from_jax, params_to_numpy, slot_cache_from_jax
from repro_torch.kernels import rwkv6_scan as scan_mod
from repro_torch.models import get_api, rwkv6, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.train import OptConfig, make_train_step
from repro_torch.train.optimizer import init_opt_state, tree_leaves, tree_map

# tiny shapes: one torch thread, so the suite's parallel workers keep their
# cores (torch's pool would otherwise spin on all of them)
torch.set_num_threads(1)

TOL = 1e-5


@pytest.fixture(scope="module")
def models():
    cfg = tiny("rwkv6-3b", dtype="float32")
    japi = jget_api(cfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    # the reference initialises the mixes to zero: perturb every leaf so the
    # token shift, the LoRAs and the group norm all see non-trivial values
    rng = np.random.default_rng(7)
    jparams = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.normal(size=a.shape).astype(a.dtype), jparams)
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    tcfg = ModelConfig(**dataclasses.asdict(cfg))
    return cfg, (japi, jparams), (get_api(tcfg, device="cpu"),
                                  params_from_jax(np_params, "cpu"))


def _close(j, t, tol=TOL):
    np.testing.assert_allclose(np.asarray(j, np.float32), t.float().numpy(),
                               rtol=tol, atol=tol)


def _state_close(jstate, tstate):
    for name in ("wkv", "tm_prev", "cm_prev"):
        _close(getattr(jstate, name), getattr(tstate, name))


def test_params_carry_the_nested_mix_dicts(models):
    _, (_, jparams), (_, tparams) = models
    assert len(tparams["blocks"]) == 2
    lp = tparams["blocks"][1]
    assert set(lp) == {"ln1", "ln2", "time_mix", "channel_mix"}
    assert lp["time_mix"]["mix_b"].shape == (5, 32, 64)
    np.testing.assert_array_equal(
        lp["time_mix"]["u"].numpy(),
        np.asarray(jparams["blocks"]["time_mix"]["u"][1]))


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        return {path: shape for k, v in tree.items()
                for path, shape in _shapes(v, f"{prefix}/{k}").items()}
    return {prefix: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}


def test_init_matches_the_reference_tree_shapes(models):
    _, (_, jparams), (tapi, _) = models
    jlayer = jax.tree_util.tree_map(lambda a: a[0], jparams["blocks"])
    assert _shapes(tapi.init(0)["blocks"][0]) == _shapes(jlayer)


@pytest.mark.parametrize("t", [7, 1])
@pytest.mark.parametrize("attn_impl", ["kernel", "ref"])
def test_block_matches_jax(models, t, attn_impl):
    cfg, (_, jparams), (_, tparams) = models
    rng = np.random.default_rng(t)
    b, h, hd, d = 2, cfg.num_rwkv_heads, cfg.rwkv_head_size, cfg.d_model
    x = rng.normal(size=(b, t, d)).astype(np.float32)
    state = (rng.normal(size=(b, h, hd, hd)).astype(np.float32) * 0.3,
             rng.normal(size=(b, d)).astype(np.float32),
             rng.normal(size=(b, d)).astype(np.float32))
    jlayer = jax.tree_util.tree_map(lambda a: a[1], jparams["blocks"])
    jx, jst = jrwkv6.block(jlayer, cfg, jnp.asarray(x),
                           jrwkv6.RWKVState(*(jnp.asarray(a) for a in state)))
    tst = rwkv6.RWKVState(*(torch.from_numpy(a) for a in state))
    tx, tnew = rwkv6.block(tparams["blocks"][1], cfg, torch.from_numpy(x), tst,
                           attn_impl=attn_impl)
    _close(jx, tx)
    _state_close(jst, tnew)
    # the block is functional: the state it was given is untouched
    np.testing.assert_array_equal(tst.wkv.numpy(), state[0])


def test_head_groupnorm_uses_the_population_variance(models):
    rng = np.random.default_rng(1)
    y = rng.normal(size=(2, 3, 2, 32)).astype(np.float32)
    p = {"ln_scale": rng.normal(size=(2, 32)).astype(np.float32),
         "ln_bias": rng.normal(size=(2, 32)).astype(np.float32)}
    want = jrwkv6._head_groupnorm({k: jnp.asarray(v) for k, v in p.items()},
                                  jnp.asarray(y))
    got = rwkv6._head_groupnorm({k: torch.from_numpy(v) for k, v in p.items()},
                                torch.from_numpy(y))
    _close(want, got)


@pytest.mark.parametrize("attn_impl", ["kernel", "ref"])
def test_prefill_decode_and_apply_match_jax(models, attn_impl):
    cfg, (japi, jparams), (tapi, tparams) = models
    rng = np.random.default_rng(2)
    b, s = 2, 9
    tokens = rng.integers(3, cfg.vocab_size, (b, s)).astype(np.int32)
    valid = np.ones((b, s), bool)          # exact length, as the engine feeds
    jcache = japi.init_cache(b, 32)
    jlog, jcache = japi.prefill(jparams, {"tokens": jnp.asarray(tokens),
                                          "valid": jnp.asarray(valid)}, jcache)
    tcache = tapi.init_cache(b, 32)
    tlog, tcache = tapi.prefill(tparams, {"tokens": torch.from_numpy(tokens),
                                          "valid": torch.from_numpy(valid)},
                                tcache, attn_impl=attn_impl)
    _close(jlog, tlog)
    _state_close(jcache, tcache)
    for step in range(3):
        tok = rng.integers(3, cfg.vocab_size, (b,)).astype(np.int32)
        pos = np.full((b,), s + step, np.int32)
        jlog, jcache = japi.decode_step(jparams, jnp.asarray(tok),
                                        jnp.asarray(pos), jcache)
        tlog, tcache = tapi.decode_step(tparams, torch.from_numpy(tok),
                                        torch.from_numpy(pos), tcache,
                                        attn_impl=attn_impl)
        assert tlog.shape == (b, cfg.vocab_size) and tlog.dtype == torch.float32
        _close(jlog, tlog)
        _state_close(jcache, tcache)
    jfull, _ = japi.apply(jparams, {"tokens": jnp.asarray(tokens)})
    tfull, _ = tapi.apply(tparams, {"tokens": torch.from_numpy(tokens)},
                          attn_impl=attn_impl)
    _close(jfull, tfull)


def test_decode_continues_a_state_carried_across(models):
    """A JAX state carried across by ``slot_cache_from_jax`` decodes on in
    the port exactly as it does in the reference."""
    cfg, (japi, jparams), (tapi, tparams) = models
    rng = np.random.default_rng(4)
    tokens = rng.integers(3, cfg.vocab_size, (3, 5)).astype(np.int32)
    _, jcache = japi.prefill(jparams, {"tokens": jnp.asarray(tokens)},
                             japi.init_cache(3, 16))
    tcache = slot_cache_from_jax(jax.tree_util.tree_map(np.asarray, jcache), "cpu")
    tok = rng.integers(3, cfg.vocab_size, (3,)).astype(np.int32)
    pos = np.full((3,), 5, np.int32)
    jlog, jcache = japi.decode_step(jparams, jnp.asarray(tok), jnp.asarray(pos), jcache)
    tlog, tcache = tapi.decode_step(tparams, torch.from_numpy(tok),
                                    torch.from_numpy(pos), tcache)
    _close(jlog, tlog)
    _state_close(jcache, tcache)


def test_kernel_switch_reaches_the_scan_wrapper(models, monkeypatch):
    """``attn_impl="kernel"`` goes through the ``rwkv6_scan`` wrapper once
    per layer and forward; ``"ref"`` never does."""
    cfg, _, (tapi, tparams) = models
    calls = []
    real = scan_mod.rwkv6_scan

    def counted(*a):
        calls.append(a[0].shape)
        return real(*a)

    monkeypatch.setattr(rwkv6, "rwkv6_scan", counted)
    tokens = torch.arange(3, 9, dtype=torch.int32)[None]
    cache = tapi.init_cache(1, 16)
    tapi.prefill(tparams, {"tokens": tokens}, cache, attn_impl="kernel")
    tapi.decode_step(tparams, tokens[:, 0], torch.tensor([6]), cache,
                     attn_impl="kernel")
    assert calls == [(1, 6, 2, 32)] * cfg.num_layers + [(1, 1, 2, 32)] * cfg.num_layers
    tapi.decode_step(tparams, tokens[:, 0], torch.tensor([7]), cache,
                     attn_impl="ref")
    assert len(calls) == 2 * cfg.num_layers
    with pytest.raises(ValueError, match="attn_impl"):
        transformer.lm_decode_step(tparams, cfg, tokens[:, 0], torch.tensor([8]),
                                   cache, attn_impl="pallas")


# ---------------------------------------------------------------------------
# training: the plain scan is differentiable, the kernel refuses a gradient
# ---------------------------------------------------------------------------

# As in tests/test_torch_trainer.py: AdamW eps 1e-3 keeps the reduction-order
# noise of near-zero gradients out of the compared params.
OPT = dict(learning_rate=1e-2, warmup_steps=2, weight_decay=0.1, eps=1e-3)
TRAIN_TOL = dict(rtol=1e-5, atol=1e-6)


def _train_batch(japi, jparams, b=2, s=10):
    rng = np.random.default_rng(5)
    tokens = rng.integers(3, japi.cfg.vocab_size, (b, s)).astype(np.int32)
    mask = np.zeros((b, s), np.float32)
    mask[:, 4:] = 1.0
    lp = np.asarray(jtrainer.make_logprob_fn(japi)(jparams, {"tokens": jnp.asarray(tokens)}))
    noisy = lambda scale: ((lp + rng.normal(scale=scale, size=lp.shape))  # noqa: E731
                           * mask).astype(np.float32)
    rewards = rng.normal(size=(b,)).astype(np.float32)
    return {"tokens": tokens, "mask": mask,
            "advantages": (rewards[:, None] * mask).astype(np.float32),
            "rewards": rewards, "old_logprobs": noisy(0.2),
            "prox_logprobs": noisy(0.1), "ref_logprobs": noisy(0.1),
            "is_positive": (rewards > 0).astype(np.float32)}


def test_train_step_through_the_plain_scan_matches_jax(models):
    """``attn_impl="ref"`` trains RWKV-6: one step's metrics and new params
    equal the reference's (tolerance 1e-5 relative / 1e-6 absolute)."""
    cfg, (japi, jparams), (tapi, tparams) = models
    jloss = jalgos.LossConfig(kl_beta=0.05)
    jstep = jax.jit(jtrainer.make_train_step(japi, jloss, jopt.OptConfig(**OPT),
                                             remat=False))
    batch = _train_batch(japi, jparams)
    jstate, jm = jstep({"params": jparams, "opt": jopt.init_opt_state(jparams)},
                       {k: jnp.asarray(v) for k, v in batch.items()})
    tstep = make_train_step(tapi, algos.LossConfig(**dataclasses.asdict(jloss)),
                            OptConfig(**OPT), attn_impl="ref")
    tstate, tm = tstep({"params": tparams, "opt": init_opt_state(tparams)},
                       {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in jm:
        np.testing.assert_allclose(np.asarray(jm[k]), float(tm[k]), err_msg=k, **TRAIN_TOL)
    got = dict(jax.tree_util.tree_leaves_with_path(params_to_numpy(tstate["params"])))
    want = jax.tree_util.tree_leaves_with_path(jstate["params"])
    assert len(want) == len(got)
    for path, w in want:
        np.testing.assert_allclose(np.asarray(w), got[path],
                                   err_msg=jax.tree_util.keystr(path), **TRAIN_TOL)
    # the step moved the decay and bonus leaves, which only the scan reaches
    for leaf in ("u", "w0"):
        assert not torch.equal(tstate["params"]["blocks"][0]["time_mix"][leaf],
                               tparams["blocks"][0]["time_mix"][leaf])


def test_a_train_step_through_the_scan_kernel_raises(models):
    """The WKV kernel has no backward: a differentiated forward through it
    (``scan_impl="kernel"``) raises on every device instead of returning
    gradients that skip the scan (the CPU plain version would hide it).
    So a train step on ``attn_impl="kernel"`` (the trainer's default) runs
    the plain scan under autograd: the same step as ``attn_impl="ref"``."""
    cfg, (japi, jparams), (tapi, tparams) = models
    batch = _train_batch(japi, jparams)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    live = tree_map(lambda t: t.detach().requires_grad_(True), tparams)
    with pytest.raises(RuntimeError, match="scan_impl='ref'"):
        tapi.apply(live, tbatch, scan_impl="kernel")
    states, metrics = [], []
    for impl in ("kernel", "ref"):
        step = make_train_step(tapi, algos.LossConfig(), OptConfig(**OPT), attn_impl=impl)
        state, m = step({"params": tparams, "opt": init_opt_state(tparams)}, tbatch)
        states.append(tree_leaves(state["params"]))
        metrics.append({k: float(v) for k, v in m.items()})
    assert metrics[0] == metrics[1]
    assert all(torch.equal(a, b) for a, b in zip(*states))
    # without a gradient the kernel path runs as before
    with torch.no_grad():
        tapi.apply(tparams, {"tokens": torch.from_numpy(batch["tokens"])})
    r = torch.zeros(1, 2, cfg.num_rwkv_heads, cfg.rwkv_head_size, requires_grad=True)
    u = torch.zeros(cfg.num_rwkv_heads, cfg.rwkv_head_size)
    state = torch.zeros(1, cfg.num_rwkv_heads, cfg.rwkv_head_size, cfg.rwkv_head_size)
    with pytest.raises(RuntimeError, match="no backward"):
        scan_mod.rwkv6_scan(r, r.detach(), r.detach(), r.detach(), u, state)
