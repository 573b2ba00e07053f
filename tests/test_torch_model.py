"""The port's dense model against the JAX package on the same inputs and
the same weights (carried across by ``params_from_jax``).

Tolerances: fp32 1e-5 (the two frameworks reduce in different orders);
bf16 2e-2 (one bf16 rounding of the output, placed differently)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny
from repro.models import attention as jattention
from repro.models import ffn as jffn
from repro.models import get_api as jget_api
from repro.models import module as jmodule
from repro_torch.convert import params_from_jax
from repro_torch.models import attention, ffn, get_api, module
from repro_torch.models.config import ModelConfig

# tiny shapes: one torch thread, so the suite's parallel workers keep their
# cores (torch's pool would otherwise spin on all of them)
torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _pair(a, dtype):
    """The same numpy array as a JAX array and a torch tensor of one dtype."""
    jdt, tdt, _ = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(np.array(a)).to(tdt)


def _close(j, t, dtype):
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(np.asarray(j, np.float32),
                               t.float().numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_and_rmsnorm_head(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    scale = rng.normal(size=(64,)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    _close(jmodule.rmsnorm({"scale": jnp.asarray(scale)}, jx, 1e-6),
           module.rmsnorm({"scale": torch.from_numpy(scale)}, tx, 1e-6), dtype)
    xh = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    sh = rng.normal(size=(16,)).astype(np.float32)
    jx, tx = _pair(xh, dtype)
    _close(jmodule.rmsnorm_head(jnp.asarray(sh), jx),
           module.rmsnorm_head(torch.from_numpy(sh), tx), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope(dtype, theta):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 4, 16)).astype(np.float32)
    positions = rng.integers(0, 3000, size=(2, 7)).astype(np.int32)
    jx, tx = _pair(x, dtype)
    _close(jmodule.apply_rope(jx, jnp.asarray(positions), theta),
           module.apply_rope(tx, torch.from_numpy(positions), theta), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("activation", ["swiglu", "geglu"])
def test_mlp(dtype, activation):
    cfg = tiny("qwen3-4b", dtype=dtype, mlp_activation=activation)
    rng = np.random.default_rng(2)
    p = {k: rng.normal(size=s).astype(np.float32) * 0.1
         for k, s in (("wi_gate", (64, 128)), ("wi_up", (64, 128)),
                      ("wo", (128, 64)))}
    x = rng.normal(size=(2, 3, 64)).astype(np.float32)
    jp = {k: _pair(v, dtype)[0] for k, v in p.items()}
    tp = {k: _pair(v, dtype)[1] for k, v in p.items()}
    _close(jffn.mlp(jp, cfg, _pair(x, dtype)[0]),
           ffn.mlp(tp, ModelConfig(**dataclasses.asdict(cfg)), _pair(x, dtype)[1]),
           dtype)


def _attend_inputs(seed, b, sq, skv, nkv, g, hd):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq, nkv, g, hd)).astype(np.float32)
    k = rng.normal(size=(b, skv, nkv, hd)).astype(np.float32)
    v = rng.normal(size=(b, skv, nkv, hd)).astype(np.float32)
    kv_pos = np.tile(np.arange(skv, dtype=np.int32), (b, 1))
    q_pos = rng.integers(0, skv, size=(b, sq)).astype(np.int32)
    q_pos[0, 0] = -1                                   # a fully masked row
    kv_valid = rng.random((b, skv)) > 0.2
    return q, k, v, q_pos, kv_pos, kv_valid


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("path,skv", [("direct", 40), ("blockwise", 2100)])
@pytest.mark.parametrize("window,softcap", [(None, None), (16, 30.0)])
def test_attend(dtype, path, skv, window, softcap):
    assert (skv > jattention._DIRECT_PATH_MAX_SEQ) == (path == "blockwise")
    q, k, v, q_pos, kv_pos, kv_valid = _attend_inputs(3, 2, 5, skv, 2, 2, 8)
    jq, tq = _pair(q, dtype)
    jk, tk = _pair(k, dtype)
    jv, tv = _pair(v, dtype)
    want = jattention.attend(jq, jk, jv, jnp.asarray(q_pos), jnp.asarray(kv_pos),
                             jnp.asarray(kv_valid), window=window, softcap=softcap)
    got = attention.attend(tq, tk, tv, torch.from_numpy(q_pos),
                           torch.from_numpy(kv_pos), torch.from_numpy(kv_valid),
                           window=window, softcap=softcap)
    assert got.dtype == DTYPES[dtype][1] and got.shape == want.shape
    _close(want, got, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("return_features", [False, True])
def test_lm_apply_logits_match_with_converted_weights(dtype, return_features):
    cfg = tiny("qwen3-4b", dtype=dtype)
    japi = jget_api(cfg)
    jp = japi.init(jax.random.PRNGKey(0))
    tapi = get_api(ModelConfig(**dataclasses.asdict(cfg)), device="cpu")
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    assert tp["embed"].dtype == DTYPES[dtype][1]
    assert tp["blocks"][0]["attn"]["q_norm"].dtype == torch.float32
    assert len(tp["blocks"]) == cfg.num_layers
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 13)).astype(np.int32)
    want, _ = japi.apply(jp, {"tokens": jnp.asarray(toks)},
                         return_features=return_features)
    got, aux = tapi.apply(tp, {"tokens": torch.from_numpy(toks)},
                          return_features=return_features)
    assert got.dtype == (DTYPES[dtype][1] if return_features else torch.float32)
    assert set(aux) == {"load_balance_loss", "router_z_loss"}
    _close(want, got, dtype)


def test_init_lm_is_seeded_and_shaped():
    cfg = ModelConfig(**dataclasses.asdict(tiny("qwen3-4b")))
    api = get_api(cfg, device="cpu")
    a, b, c = api.init(0), api.init(0), api.init(1)
    assert torch.equal(a["blocks"][1]["mlp"]["wo"], b["blocks"][1]["mlp"]["wo"])
    assert not torch.equal(a["embed"], c["embed"])
    assert a["embed"].dtype == torch.bfloat16
    assert a["lm_head"].shape == (cfg.d_model, cfg.vocab_size)
    assert a["blocks"][0]["attn"]["wk"].shape == (cfg.d_model, cfg.kv_dim)
    assert float(a["embed"].float().abs().max()) <= 2.0
    n = module.count_params(a)
    jn = jmodule.count_params(jget_api(tiny("qwen3-4b")).init(jax.random.PRNGKey(0)))
    assert n == jn
