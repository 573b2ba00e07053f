"""The chunked scan routes' passes in plain torch
(``ref.rwkv6_scan_chunked_ref``, ``ref.rglru_scan_chunked_ref``: what
``csrc/rwkv6_scan.cu`` and ``csrc/rglru_scan.cu`` compute on their chunked
routes, step for step) against two references of the JAX package on the
same inputs: its plain oracles (``repro.kernels.ref``) and its Pallas
kernels in interpret mode (``block_t`` dividing T).  Chunk lengths that do
and do not divide T, one step and longer than T; strong decays (w down to
1e-4, and w = 0); a state carried across two calls; bf16 inputs.  Then the
routes' plans, which read static shapes only.

Tolerance: fp32 2e-5 (rtol and atol), as the kernels' tests: the chunked
passes sum in another order than the serial recurrence."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.rglru_scan import rglru_scan as jax_rglru_scan
from repro.kernels.rwkv6_scan import rwkv6_scan as jax_rwkv6_scan
from repro_torch.kernels import ref
from repro_torch.kernels import rglru_scan as lru
from repro_torch.kernels import rwkv6_scan as wkv

# tiny shapes: one torch thread, so the suite's parallel workers keep their
# cores (torch's pool would otherwise spin on all of them)
torch.set_num_threads(1)

TOL = 2e-5


def _close(want, got):
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), rtol=TOL, atol=TOL)


def _decays(rng, shape, kind):
    """w for the WKV scan (a for the RG-LRU scan): ``mild`` U(0.3, 1);
    ``strong`` log-uniform down to 1e-4 (-log w up to 9.2 a step, beyond
    RWKV-6's ~7); ``model`` exp(-exp(x)), RWKV-6's own form; ``edges``
    strong with some w exactly 0 and some exactly 1."""
    if kind == "mild":
        return rng.uniform(0.3, 1.0, size=shape)
    if kind == "model":
        return np.exp(-np.exp(rng.normal(-0.5, 1.2, size=shape)))
    w = 10.0 ** (-4.0 * rng.uniform(size=shape))
    if kind == "edges":
        pick = rng.uniform(size=shape)
        w = np.where(pick < 0.1, 0.0, np.where(pick > 0.9, 1.0, w))
    return w


# (seed, B, T, H, D, decays, Pallas block_t)
WKV_CASES = {"strong": (0, 1, 48, 2, 32, "strong", 16),
             "model": (1, 2, 40, 3, 32, "model", 8),
             "mild": (2, 1, 30, 2, 32, "mild", 10),
             "edges": (3, 1, 36, 1, 32, "edges", 12)}


@functools.lru_cache(maxsize=None)
def _wkv_case(name):
    """(fp32 numpy inputs, the oracle's (y, state), the Pallas kernel's)."""
    seed, b, t, h, d, kind, block_t = WKV_CASES[name]
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, t, h, d)) for _ in range(3))
    w = _decays(rng, (b, t, h, d), kind)
    u = rng.normal(size=(h, d)) * 0.5
    s0 = rng.normal(size=(b, h, d, d)) * 0.3
    arrays = tuple(x.astype(np.float32) for x in (r, k, v, w, u, s0))
    jx = [jnp.asarray(x) for x in arrays]
    oracle = jref.rwkv6_scan_ref(*jx)
    pallas = jax_rwkv6_scan(*jx, block_t=block_t, interpret=True)
    return arrays, oracle, pallas


@pytest.mark.parametrize("chunk", [1, 7, 16, 64])
@pytest.mark.parametrize("case", sorted(WKV_CASES))
def test_chunked_wkv_passes_match_the_oracle_and_the_pallas_kernel(case, chunk):
    arrays, oracle, pallas = _wkv_case(case)
    y, state = ref.rwkv6_scan_chunked_ref(*(torch.from_numpy(x) for x in arrays), chunk)
    assert y.dtype == state.dtype == torch.float32 and y.shape == arrays[0].shape
    for jy, jstate in (oracle, pallas):
        _close(jy, y)
        _close(jstate, state)


@pytest.mark.parametrize("chunk", [4, 16, 32])
def test_chunked_wkv_state_carries_across_calls(chunk):
    """Two chunked calls, the second from the first's state, equal one
    serial pass over the whole sequence."""
    arrays, oracle, _ = _wkv_case("strong")
    r, k, v, w, u, s0 = (torch.from_numpy(x) for x in arrays)
    y1, s1 = ref.rwkv6_scan_chunked_ref(r[:, :19], k[:, :19], v[:, :19], w[:, :19], u, s0, chunk)
    y2, s2 = ref.rwkv6_scan_chunked_ref(r[:, 19:], k[:, 19:], v[:, 19:], w[:, 19:], u, s1, chunk)
    _close(oracle[0], torch.cat([y1, y2], dim=1))
    _close(oracle[1], s2)


@pytest.mark.parametrize("chunk", [7, 16])
def test_chunked_wkv_passes_a_nan_decay_on_like_the_oracle(chunk):
    """A NaN in w makes NaN the same outputs as in the serial recurrence
    (every later step of its head, and its state row); the log2 floor does
    not turn it into a decay."""
    arrays, _, _ = _wkv_case("strong")
    arrays = tuple(x.copy() for x in arrays)
    arrays[3][0, 21, 1, 5] = np.nan
    y, state = ref.rwkv6_scan_chunked_ref(*(torch.from_numpy(x) for x in arrays), chunk)
    jy, jstate = jref.rwkv6_scan_ref(*(jnp.asarray(x) for x in arrays))
    for want, got in ((jy, y), (jstate, state)):
        want = np.asarray(want)
        np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
        _close(np.nan_to_num(want), got.nan_to_num())
    assert np.isnan(np.asarray(jy)).any()


def test_chunked_wkv_takes_mixed_dtypes_like_the_model():
    """bf16 r/k/v and fp32 w, as the model hands them over: widened to fp32,
    as the oracle widens them."""
    arrays, _, _ = _wkv_case("model")
    bf = [torch.from_numpy(x).to(torch.bfloat16) for x in arrays[:3]]
    rest = [torch.from_numpy(x) for x in arrays[3:]]
    y, state = ref.rwkv6_scan_chunked_ref(*bf, *rest, 16)
    jy, jstate = jref.rwkv6_scan_ref(*(jnp.asarray(x.float().numpy()) for x in bf),
                                     *(jnp.asarray(x) for x in arrays[3:]))
    _close(jy, y)
    _close(jstate, state)


# (seed, B, T, W, decays, Pallas block_t, block_w)
LRU_CASES = {"strong": (4, 2, 48, 64, "strong", 16, 32),
             "mild": (5, 1, 40, 32, "mild", 8, 32),
             "edges": (6, 3, 24, 32, "edges", 8, 32)}


@functools.lru_cache(maxsize=None)
def _lru_case(name):
    seed, b, t, w, kind, block_t, block_w = LRU_CASES[name]
    rng = np.random.default_rng(seed)
    a = _decays(rng, (b, t, w), kind)
    bb = rng.normal(size=(b, t, w)) * 0.5
    h0 = rng.normal(size=(b, w))
    arrays = tuple(x.astype(np.float32) for x in (a, bb, h0))
    jx = [jnp.asarray(x) for x in arrays]
    return (arrays, jref.rglru_scan_ref(*jx),
            jax_rglru_scan(*jx, block_t=block_t, block_w=block_w, interpret=True))


@pytest.mark.parametrize("chunk", [1, 5, 16, 64])
@pytest.mark.parametrize("case", sorted(LRU_CASES))
def test_chunked_rglru_passes_match_the_oracle_and_the_pallas_kernel(case, chunk):
    arrays, oracle, pallas = _lru_case(case)
    hs, h_last = ref.rglru_scan_chunked_ref(*(torch.from_numpy(x) for x in arrays), chunk)
    assert hs.dtype == h_last.dtype == torch.float32 and hs.shape == arrays[0].shape
    for jhs, jlast in (oracle, pallas):
        _close(jhs, hs)
        _close(jlast, h_last)


@pytest.mark.parametrize("chunk", [3, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunked_rglru_state_carries_across_calls(chunk, dtype):
    """Two chunked calls equal one serial pass; bf16 a/b widen exactly."""
    arrays, _, _ = _lru_case("strong")
    a, bb = (torch.from_numpy(x).to(dtype) for x in arrays[:2])
    h0 = torch.from_numpy(arrays[2])
    want_hs, want_last = jref.rglru_scan_ref(
        *(jnp.asarray(x.float().numpy()) for x in (a, bb)), jnp.asarray(arrays[2]))
    hs1, h_mid = ref.rglru_scan_chunked_ref(a[:, :21], bb[:, :21], h0, chunk)
    hs2, h_end = ref.rglru_scan_chunked_ref(a[:, 21:], bb[:, 21:], h_mid, chunk)
    _close(want_hs, torch.cat([hs1, hs2], dim=1))
    _close(want_last, h_end)


# ---------------------------------------------------------------------------
# the plans: static shapes in, (route, chunk) out
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,t,h,d,route", [
    (16, 1, 40, 64, "step"),          # RWKV-6 3B decode
    (1, 512, 40, 64, "chunked"),      # its one-sequence prefill
    (1, 64, 40, 64, "chunked"),       # the shortest serve prompt
    (1, 2048, 40, 64, "chunked"),
    (1, 300, 16, 128, "chunked"),
    (3, 300, 8, 32, "chunked"),
    (1, wkv.CHUNKED_MIN_T - 1, 40, 64, "step"),
    (4, 512, 40, 64, "chunked"),
    (6, 512, 40, 64, "step"),         # batch x heads alone fill the card
    (16, 512, 40, 64, "step"),
])
def test_wkv_plan_routes_from_static_shapes(b, t, h, d, route):
    got, chunk = wkv.plan(b, t, h, d)
    assert got == route
    assert chunk == (wkv.CHUNK if route == "chunked" else 0)


@pytest.mark.parametrize("b,t,w,route", [
    (16, 1, 4096, "direct"),           # RecurrentGemma-9B decode
    (1, 512, 4096, "chunked"),         # its one-sequence prefill
    (1, 2048, 4096, "chunked"),
    (3, 300, 96, "chunked"),
    (1, lru.CHUNKED_MIN_T - 1, 4096, "direct"),
    (3, 512, 4096, "chunked"),
    (6, 512, 4096, "direct"),          # batch x width alone fill the card
    (16, 512, 4096, "direct"),
])
def test_rglru_plan_routes_from_static_shapes(b, t, w, route):
    got, chunk = lru.plan(b, t, w)
    assert got == route
    if route == "chunked":
        assert lru.MIN_CHUNK <= chunk <= t and -(-t // chunk) <= lru.CHUNKS
    else:
        assert chunk == 0
