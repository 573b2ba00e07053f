"""The port's flash attention against the JAX package: the plain forward
against the Pallas kernel (interpret mode) and its oracle, the backward
against ``jax.vjp`` of the oracle, and the model's ``attn_impl`` switch.

On the CPU the wrappers (and ``FlashAttention``) run the plain versions;
the CUDA kernels themselves are held to them by the ``cuda``-marked tests
in test_torch_kernels.py and by ``chip_smoke.py``.  Tolerances, fp32:
forward 2e-5 (as tests/test_kernels.py: reduction order), backward 1e-5
(the same einsums in another order)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro.models import attention as jattention
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.models import attention, get_api
from repro_torch.models.config import ModelConfig

# tiny shapes: one torch thread, so the suite's parallel workers keep their
# cores (torch's pool would otherwise spin on all of them)
torch.set_num_threads(1)

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
BWD_TOL = dict(rtol=1e-5, atol=1e-5)


def _qkv(seed, b, h, kv, s, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, s, d)).astype(np.float32),
            rng.normal(size=(b, kv, s, d)).astype(np.float32),
            rng.normal(size=(b, kv, s, d)).astype(np.float32))


# (h, kv, head_dim): G = 1, 2, 4 at head_dim 64 (ids: h-kv), a group of 16
# and H2O-Danube-3's head_dim 120; G x D past 512 (the fp32 kernel's old
# limit): 16 x 64 and 8 x 128
@pytest.mark.parametrize("h,kv,d", [pytest.param(4, 4, 64, id="4-4"),
                                    pytest.param(4, 2, 64, id="4-2"),
                                    pytest.param(8, 2, 64, id="8-2"),
                                    pytest.param(16, 1, 64, id="16-1"),
                                    pytest.param(8, 2, 120, id="8-2-d120"),
                                    pytest.param(8, 1, 128, id="8-1-d128")])
@pytest.mark.parametrize("window,softcap", [(None, None), (48, None),
                                            (None, 5.0), (40, 5.0)])
def test_flash_ref_matches_pallas_interpret(h, kv, d, window, softcap):
    q, k, v = _qkv(0, 1, h, kv, 128, d)
    want = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=True, window=window, softcap=softcap,
                               block_q=64, block_k=64, interpret=True)
    got = fa.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True,
                             window=window, softcap=softcap)
    np.testing.assert_allclose(np.asarray(want), got.detach().numpy(), **FWD_TOL)


@pytest.mark.parametrize("s", [1, 37, 100])
@pytest.mark.parametrize("causal,window,softcap", [(True, None, None),
                                                   (True, 16, 30.0),
                                                   (False, None, None),
                                                   (False, 9, None)])
def test_flash_ref_matches_jax_oracle_at_ragged_lengths(s, causal, window, softcap):
    q, k, v = _qkv(1, 2, 8, 2, s, 32)
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    causal=causal, window=window, softcap=softcap)
    got, lse = ref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                       causal=causal, window=window,
                                       softcap=softcap, return_lse=True)
    np.testing.assert_allclose(np.asarray(want), got.numpy(), **FWD_TOL)
    assert lse.shape == (2, 8, s) and lse.dtype == torch.float32


# (h, kv, head_dim): head_dim 16 (ids: h-kv), a group of 16 and head_dim
# 120; G x D past 512: 8 x 128 and 16 x 64 (the window and softcap cases)
@pytest.mark.parametrize("h,kv,d", [pytest.param(4, 4, 16, id="4-4"),
                                    pytest.param(4, 2, 16, id="4-2"),
                                    pytest.param(8, 2, 16, id="8-2"),
                                    pytest.param(16, 1, 16, id="16-1"),
                                    pytest.param(4, 2, 120, id="4-2-d120"),
                                    pytest.param(8, 1, 128, id="8-1-d128"),
                                    pytest.param(16, 1, 64, id="16-1-d64")])
@pytest.mark.parametrize("s,window,softcap", [(24, None, None), (37, 10, None),
                                              (33, None, 4.0), (19, 7, 4.0)])
def test_flash_backward_matches_jax_vjp(h, kv, d, s, window, softcap):
    q, k, v = _qkv(2, 2, h, kv, s, d)
    do = np.random.default_rng(3).normal(size=q.shape).astype(np.float32)

    @jax.jit
    def vjp(a, b_, c, g):
        out, pull = jax.vjp(lambda x, y, z: jref.flash_attention_ref(
            x, y, z, causal=True, window=window, softcap=softcap), a, b_, c)
        return out, pull(g)

    out, want = vjp(*map(jnp.asarray, (q, k, v, do)))

    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = fa.flash_attention_fwd(tq, tk, tv, window=window, softcap=softcap)
    np.testing.assert_allclose(np.asarray(out), o.numpy(), **FWD_TOL)
    plain = ref.flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo, window=window,
                                        softcap=softcap)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    fa.FlashAttention.apply(*leaves, True, window, softcap).backward(tdo)
    for w, p, a in zip(want, plain, leaves):
        np.testing.assert_allclose(np.asarray(w), p.numpy(), **BWD_TOL)
        np.testing.assert_allclose(np.asarray(w), a.grad.numpy(), **BWD_TOL)


# ---------------------------------------------------------------------------
# causal=False (the Seamless encoder's attention; the card's wgmma route)
# ---------------------------------------------------------------------------

# (h, kv, head_dim): G = 1 and 4 at head_dim 64 and 120; G x D past 512:
# 8 x 128 and 16 x 64
_NONCAUSAL_HEADS = [pytest.param(4, 4, 64, id="g1-d64"), pytest.param(8, 2, 64, id="g4-d64"),
                    pytest.param(4, 4, 120, id="g1-d120"), pytest.param(4, 1, 120, id="g4-d120"),
                    pytest.param(8, 1, 128, id="g8-d128"), pytest.param(16, 1, 64, id="g16-d64")]


@pytest.mark.parametrize("h,kv,d", _NONCAUSAL_HEADS)
@pytest.mark.parametrize("s,block", [(128, 64), (100, 50)])   # S a multiple of 64, and ragged
@pytest.mark.parametrize("window,softcap", [(None, None), (24, None), (24, 5.0)])
def test_noncausal_flash_matches_pallas_interpret(h, kv, d, s, block, window, softcap):
    q, k, v = _qkv(6, 1, h, kv, s, d)
    want = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=False, window=window, softcap=softcap,
                               block_q=block, block_k=block, interpret=True)
    got, lse = fa.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)), causal=False,
                                      window=window, softcap=softcap)
    np.testing.assert_allclose(np.asarray(want), got.numpy(), **FWD_TOL)
    assert lse.shape == (1, h, s) and bool(torch.isfinite(lse).all())


# (h, kv, head_dim): G = 1 and 4 at head_dim 16 and 120; G x D past 512:
# 8 x 128 and 16 x 64
@pytest.mark.parametrize("h,kv,d", [pytest.param(4, 4, 16, id="g1-d16"),
                                    pytest.param(8, 2, 16, id="g4-d16"),
                                    pytest.param(4, 1, 120, id="g4-d120"),
                                    pytest.param(8, 1, 128, id="g8-d128"),
                                    pytest.param(16, 1, 64, id="g16-d64")])
@pytest.mark.parametrize("s,window,softcap", [(24, None, None), (37, 10, None),
                                              (33, None, 4.0), (19, 7, 4.0)])
def test_noncausal_flash_backward_matches_jax_vjp(h, kv, d, s, window, softcap):
    q, k, v = _qkv(7, 2, h, kv, s, d)
    do = np.random.default_rng(8).normal(size=q.shape).astype(np.float32)

    @jax.jit
    def vjp(a, b_, c, g):
        out, pull = jax.vjp(lambda x, y, z: jref.flash_attention_ref(
            x, y, z, causal=False, window=window, softcap=softcap), a, b_, c)
        return out, pull(g)

    out, want = vjp(*map(jnp.asarray, (q, k, v, do)))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    opts = dict(causal=False, window=window, softcap=softcap)
    o, lse = fa.flash_attention_fwd(tq, tk, tv, **opts)
    np.testing.assert_allclose(np.asarray(out), o.numpy(), **FWD_TOL)
    plain = fa.flash_attention_bwd(tq, tk, tv, o, lse, tdo, **opts)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    fa.FlashAttention.apply(*leaves, False, window, softcap).backward(tdo)
    for w, p, a in zip(want, plain, leaves):
        np.testing.assert_allclose(np.asarray(w), p.numpy(), **BWD_TOL)
        np.testing.assert_allclose(np.asarray(w), a.grad.numpy(), **BWD_TOL)


@pytest.mark.parametrize("dtype,causal,d,want", [
    (torch.bfloat16, False, 64, "wgmma"),      # Seamless' encoder
    (torch.bfloat16, False, 32, "wgmma"),      # instance 64
    (torch.bfloat16, False, 120, "wgmma"),     # instance 128
    (torch.bfloat16, False, 128, "wgmma"),
    (torch.bfloat16, False, 136, "mma_sync"),  # instance 256: no wgmma instance
    (torch.bfloat16, False, 256, "mma_sync"),
    (torch.bfloat16, True, 64, "mma_sync"),    # every causal call
    (torch.bfloat16, True, 128, "mma_sync"),
    (torch.float32, False, 64, "fp32"),        # fp32 whatever the mask
    (torch.float32, True, 120, "fp32"),
])
def test_route_is_picked_from_dtype_causal_and_instance(dtype, causal, d, want):
    assert fa.route(dtype, causal, d) == want
    # the code the C entry points dispatch on
    assert fa._ROUTES[want] == {"fp32": 0, "mma_sync": 1, "wgmma": 2}[want]


def test_route_ignores_everything_but_dtype_causal_and_instance():
    """Head dims of one instance share a route; shapes, windows and softcaps
    never enter the choice (``route`` takes nothing else)."""
    for d in range(8, 65, 8):
        assert fa.route(torch.bfloat16, False, d) == "wgmma"
    for d in range(72, 129, 8):
        assert fa.instance(d) == 128 and fa.route(torch.bfloat16, False, d) == "wgmma"
    assert {fa.route(torch.bfloat16, True, d) for d in range(8, 257, 8)} == {"mma_sync"}


@pytest.mark.parametrize("shape,dtype,kw,exc", [
    ((2, 4, 2, 8, 44), torch.float32, {}, ValueError),            # head_dim % 8
    ((2, 4, 2, 8, 64), torch.float16, {}, TypeError),             # dtype
    ((2, 4, 3, 8, 64), torch.float32, {}, ValueError),            # H % KV
    ((2, 4, 2, 8, 64), torch.float32, {"window": 0}, ValueError),
    ((2, 4, 2, 8, 64), torch.float32, {"softcap": -1.0}, ValueError),
    ((2, 4, 2, 8, 264), torch.bfloat16, {}, ValueError),          # head_dim > 256
])
def test_kernel_checks_refuse_what_the_kernel_does_not_take(shape, dtype, kw, exc):
    b, h, kv, s, d = shape
    q = torch.zeros(b, h, s, d, dtype=dtype)
    k = torch.zeros(b, kv, s, d, dtype=dtype)
    opts = dict(causal=True, window=None, softcap=None) | kw
    with pytest.raises(exc):
        fa._check(q, k, k.clone(), **opts)


@pytest.mark.parametrize("shape,dtype", [
    ((1, 32, 2, 8, 128), torch.bfloat16),    # G x D = 2,048 (Qwen3-MoE's 16 x 128)
    ((1, 8, 1, 8, 256), torch.bfloat16),     # PaliGemma's 8 x 256
    ((1, 48, 8, 8, 128), torch.bfloat16),    # DBRX's 6 x 128
    ((1, 32, 8, 8, 120), torch.bfloat16),    # H2O-Danube-3: head_dim 120
    ((1, 32, 8, 8, 120), torch.float32),     # fp32: 4 x 128 (the instance)
    ((1, 4, 2, 8, 8), torch.float32),        # the smallest head_dim
    ((2, 16, 2, 8, 128), torch.float32),     # fp32: 8 x 128
    ((2, 8, 1, 8, 120), torch.float32),      # fp32: 8 x 128 (the instance)
    ((1, 8, 1, 8, 256), torch.float32),      # PaliGemma-3B's 8 x 256
    ((1, 16, 1, 8, 256), torch.float32),     # RecurrentGemma-9B's 16 x 256
    ((1, 64, 4, 8, 128), torch.float32),     # Qwen3-MoE-235B-A22B's 16 x 128
    ((1, 48, 8, 8, 128), torch.float32),     # DBRX-132B's 6 x 128
])
def test_kernel_checks_take_any_group_and_head_dims_of_8s(shape, dtype):
    """Both dtypes run one query head per block: no group limit.  head_dim
    is any multiple of 8 up to 256 (the kernel's instance is the next of
    64, 128, 256)."""
    b, h, kv, s, d = shape
    q = torch.zeros(b, h, s, d, dtype=dtype)
    k = torch.zeros(b, kv, s, d, dtype=dtype)
    fa._check(q, k, k.clone(), True, None, None)


def test_kernel_checks_take_strided_views_and_refuse_a_strided_head_dim():
    x = torch.zeros(2, 8, 4, 64)              # (B, S, H, D) contiguous
    q = x.transpose(1, 2)                     # (B, H, S, D) view
    kv = torch.zeros(2, 8, 2, 64).transpose(1, 2)
    fa._check(q, kv, kv, True, None, None)
    with pytest.raises(ValueError, match="contiguous"):
        fa._check(torch.zeros(2, 4, 64, 8).transpose(2, 3), kv, kv, True, None, None)


def test_wrapper_refuses_devices_other_than_cpu_and_cuda():
    q = torch.zeros(1, 4, 8, 64, device="meta")
    k = torch.zeros(1, 2, 8, 64, device="meta")
    with pytest.raises(ValueError, match="device"):
        fa.flash_attention_fwd(q, k, k)


# ---------------------------------------------------------------------------
# the model's switch
# ---------------------------------------------------------------------------

def _cfg(**kw):
    return ModelConfig(**dataclasses.asdict(tiny("qwen3-4b", dtype="float32", **kw)))


@pytest.mark.parametrize("kw", [{}, {"sliding_window": 5},
                                {"attn_logit_softcap": 3.0}])
def test_self_attention_kernel_equals_ref_on_cpu(kw):
    cfg = _cfg(**kw)
    api = get_api(cfg, device="cpu")
    p = api.init(0)["blocks"][0]["attn"]
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(2, 11, cfg.d_model)).astype(np.float32))
    pos = torch.arange(11, dtype=torch.int32)[None].expand(2, 11)
    launches = fa.flash_attention.launches_fwd
    got = attention.self_attention(p, cfg, x, pos, attn_impl="kernel")
    want = attention.self_attention(p, cfg, x, pos, attn_impl="ref")
    assert fa.flash_attention.launches_fwd == launches   # plain path on the CPU
    torch.testing.assert_close(got, want, **FWD_TOL)
    # and the ref path is the JAX package's self_attention
    jp = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), p)
    jwant = jattention.self_attention(jp, tiny("qwen3-4b", dtype="float32", **kw),
                                      jnp.asarray(x.numpy()), jnp.asarray(pos.numpy()))
    np.testing.assert_allclose(np.asarray(jwant), got.numpy(), **FWD_TOL)


def test_attn_impl_refuses_unknown_names_and_explicit_positions():
    cfg = _cfg()
    api = get_api(cfg, device="cpu")
    params = api.init(0)
    toks = torch.zeros(1, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="attn_impl"):
        api.apply(params, {"tokens": toks}, attn_impl="sdpa")
    from repro_torch.models.transformer import lm_apply
    pos = torch.arange(4, dtype=torch.int32)[None]
    with pytest.raises(ValueError, match="positions"):
        lm_apply(params, cfg, toks, positions=pos)
    lm_apply(params, cfg, toks, positions=pos, attn_impl="ref")


def test_apply_is_differentiable_through_the_kernel_path():
    cfg = _cfg()
    api = get_api(cfg, device="cpu")
    params = api.init(0)
    wq = params["blocks"][0]["attn"]["wq"].requires_grad_(True)
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, 64, (2, 9)))
    grads = {}
    for impl in ("kernel", "ref"):
        logits, _ = api.apply(params, {"tokens": toks}, attn_impl=impl)
        (g,) = torch.autograd.grad(logits.square().mean(), wq)
        grads[impl] = g
    torch.testing.assert_close(grads["kernel"], grads["ref"], **BWD_TOL)
