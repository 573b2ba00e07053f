"""The port's decode kernels' plain versions against the JAX package's
Pallas kernels (interpret mode) and their plain oracles, on the same
inputs: paged decode attention, dense-cache decode attention, the RWKV-6
WKV scan and the RG-LRU scan.

On the CPU the wrapper runs the plain version; the CUDA kernel itself is
held to the plain version by the ``cuda``-marked tests (on the card) and by
``chip_smoke.py``.  Tolerances follow tests/test_kernels.py: fp32 2e-5
(reduction order), bf16 2e-2 (bf16 inputs and output)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as jax_decode_attention
from repro.kernels.rglru_scan import rglru_scan as jax_rglru_scan
from repro.kernels.rwkv6_scan import rwkv6_scan as jax_rwkv6_scan
from repro.kernels.paged_decode_attention import (
    paged_decode_attention as jax_paged_decode_attention)
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import paged_decode_attention as pda
from repro_torch.kernels import rglru_scan as lru
from repro_torch.kernels import rwkv6_scan as wkv
from repro_torch.kernels import ref

# tiny shapes: one torch thread, so the suite's parallel workers keep their
# cores (torch's pool would otherwise spin on all of them)
torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(seed, b, h, kv, d, page_size, pages_per_seq, *, masked_row=False):
    """Random pool, ragged block tables with -1 tails, lengths (numpy)."""
    rng = np.random.default_rng(seed)
    n = 1 + b * pages_per_seq
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    kp = rng.normal(size=(n, page_size, kv, d)).astype(np.float32)
    vp = rng.normal(size=(n, page_size, kv, d)).astype(np.float32)
    bt = np.full((b, pages_per_seq), -1, np.int32)
    perm = rng.permutation(np.arange(1, n)).astype(np.int32)
    lengths, i = [], 0
    for bi in range(b):
        used = int(rng.integers(1, pages_per_seq + 1))
        bt[bi, :used] = perm[i:i + used]
        i += used
        lengths.append(int(rng.integers(1, used * page_size + 1)))
    lengths = np.asarray(lengths, np.int32)
    if masked_row:
        bt[0] = -1
    return q, kp, vp, bt, lengths


def _both(arrays, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    q, kp, vp, bt, lengths = arrays
    jx = (jnp.asarray(q, jdt), jnp.asarray(kp, jdt), jnp.asarray(vp, jdt),
          jnp.asarray(bt), jnp.asarray(lengths))
    tx = (torch.from_numpy(q).to(tdt), torch.from_numpy(kp).to(tdt),
          torch.from_numpy(vp).to(tdt), torch.from_numpy(bt),
          torch.from_numpy(lengths))
    return jx, tx


def _close(a, b, dtype):
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(np.asarray(a, np.float32), b.float().numpy(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("b,h,kv,d,page_size,pages_per_seq", [
    (2, 8, 2, 64, 16, 4),    # GQA
    (3, 4, 4, 64, 32, 2),    # MHA
    (1, 8, 1, 128, 16, 6),   # MQA
    (2, 32, 8, 120, 16, 3),  # H2O-Danube-3's heads, head_dim 120
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_attention_sweep(b, h, kv, d, page_size, pages_per_seq,
                                      dtype):
    jx, tx = _both(_inputs(0, b, h, kv, d, page_size, pages_per_seq), dtype)
    got = pda.paged_decode_attention(*tx)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (b, h, d)
    _close(jax_paged_decode_attention(*jx, interpret=True), got, dtype)
    _close(jref.paged_decode_attention_ref(*jx), got, dtype)


@pytest.mark.parametrize("softcap,masked_row", [(30.0, False), (None, True),
                                                (30.0, True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_attention_softcap_and_masked_rows(softcap, masked_row,
                                                        dtype):
    arrays = _inputs(1, 3, 8, 2, 64, 16, 3, masked_row=masked_row)
    jx, tx = _both(arrays, dtype)
    got = pda.paged_decode_attention(*tx, softcap=softcap)
    _close(jax_paged_decode_attention(*jx, softcap=softcap, interpret=True),
           got, dtype)
    _close(jref.paged_decode_attention_ref(*jx, softcap=softcap), got, dtype)
    if masked_row:
        # -1e30 fill: a fully masked row averages V over its (clamped) pages
        vp = arrays[2]
        want = vp[0].astype(np.float32).mean(axis=0)          # page 0 only
        got0 = got[0].float().numpy().reshape(2, 4, 64)
        tol = DTYPES[dtype][2]
        np.testing.assert_allclose(got0, np.broadcast_to(want[:, None], got0.shape),
                                   rtol=tol, atol=tol)


def test_paged_ref_dequantizes_int8_pages_like_the_jax_oracle():
    _int8_ref_against_the_oracle(_inputs(2, 2, 8, 2, 64, 16, 4))


def test_paged_ref_dequantizes_int8_pages_at_head_dim_120():
    """H2O-Danube-3's head_dim: int8 rows of 120 bytes, 8-byte aligned."""
    _int8_ref_against_the_oracle(_inputs(5, 2, 32, 8, 120, 16, 3))


def _int8_ref_against_the_oracle(arrays):
    q, kp, vp, bt, lengths = arrays
    rng = np.random.default_rng(3)
    kc = rng.integers(-127, 128, kp.shape).astype(np.int8)
    vc = rng.integers(-127, 128, vp.shape).astype(np.int8)
    ks = rng.random(kp.shape[:3]).astype(np.float32) * 0.02
    vs = rng.random(vp.shape[:3]).astype(np.float32) * 0.02
    want = jref.paged_decode_attention_ref(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(bt),
        jnp.asarray(lengths), k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
    got = ref.paged_decode_attention_ref(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(bt), torch.from_numpy(lengths),
        k_scales=torch.from_numpy(ks), v_scales=torch.from_numpy(vs))
    _close(want, got, "float32")


@pytest.mark.parametrize("dtype,h,kv,d,page_size,exc", [
    (torch.float16, 8, 2, 64, 16, TypeError),       # dtype
    (torch.float32, 8, 2, 44, 16, ValueError),      # head_dim % 8
    (torch.float32, 8 * 33, 8, 64, 16, ValueError), # group > 32
    (torch.float32, 8, 2, 64, 1024, ValueError),    # tiles beyond shared memory
    (torch.float32, 8, 2, 264, 16, ValueError),     # head_dim > 256
])
def test_kernel_checks_refuse_what_the_kernel_does_not_take(dtype, h, kv, d,
                                                            page_size, exc):
    q = torch.zeros(2, h, d, dtype=dtype)
    kp = torch.zeros(5, page_size, kv, d, dtype=dtype)
    bt = torch.zeros(2, 2, dtype=torch.int32)
    with pytest.raises(exc):
        pda._check(q, kp, kp.clone(), bt, torch.ones(2, dtype=torch.int32))


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 120), (torch.float32, 120),
                                     (torch.int8, 120), (torch.bfloat16, 8),
                                     (torch.int8, 248)])
def test_kernel_checks_take_head_dims_of_8s(dtype, d):
    """Any multiple of 8 up to 256; an int8 pool's rows need 8-byte
    alignment (a row of 120 codes is 120 bytes), fp/bf16 pools' 16-byte."""
    int8 = dtype == torch.int8
    q = torch.zeros(2, 32, d, dtype=torch.bfloat16 if int8 else dtype)
    kp = torch.zeros(5, 16, 8, d, dtype=dtype)
    scales = (dict(k_scales=torch.zeros(5, 16, 8), v_scales=torch.zeros(5, 16, 8))
              if int8 else {})
    pda._check(q, kp, kp.clone(), torch.zeros(2, 2, dtype=torch.int32),
               torch.ones(2, dtype=torch.int32), **scales)


def test_wrapper_refuses_devices_other_than_cpu_and_cuda():
    q = torch.zeros(1, 4, 64, device="meta")
    kp = torch.zeros(3, 16, 2, 64, device="meta")
    bt = torch.zeros(1, 2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        pda.paged_decode_attention(q, kp, kp, bt, torch.ones(1, device="meta"))


# ---------------------------------------------------------------------------
# dense-cache decode attention (the slot engine's decode step)
# ---------------------------------------------------------------------------

def _dense_inputs(seed, b, h, kv, s, d, lengths):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, d)).astype(np.float32),
            rng.normal(size=(b, s, kv, d)).astype(np.float32),
            rng.normal(size=(b, s, kv, d)).astype(np.float32),
            np.asarray(lengths, np.int32))


@pytest.mark.parametrize("h,kv,window", [(8, 2, None), (8, 8, 100), (8, 1, 200)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_the_pallas_kernel(h, kv, window, dtype):
    """S a multiple of the TPU kernel's tile (128), as tests/test_kernels.py
    runs it."""
    q, k, v, lengths = _dense_inputs(0, 4, h, kv, 256, 64, [1, 77, 200, 256])
    jdt, tdt, _ = DTYPES[dtype]
    got = da.decode_attention(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                              torch.from_numpy(lengths), window=window)
    assert got.dtype == tdt and got.shape == q.shape
    _close(jax_decode_attention(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                                jnp.asarray(lengths), window=window, block_k=128,
                                interpret=True), got, dtype)


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("window", [None, 48])
def test_decode_attention_ref_matches_the_oracle_at_ragged_s(g, window):
    """Ragged S, lengths 0 (no valid key: V averaged over all S), 1, S and
    above S (counts as S, the window still measured from the length)."""
    s = 77
    q, k, v, lengths = _dense_inputs(1, 5, 2 * g, 2, s, 32, [0, 1, 30, s, s + 20])
    got = ref.decode_attention_ref(*(torch.from_numpy(x) for x in (q, k, v, lengths)),
                                   window=window)
    want = jref.decode_attention_ref(*(jnp.asarray(x) for x in (q, k, v, lengths)),
                                     window=window)
    _close(want, got, "float32")
    wrapped = da.decode_attention(*(torch.from_numpy(x) for x in (q, k, v, lengths)),
                                  window=window)
    torch.testing.assert_close(wrapped, got, rtol=0, atol=0)
    # length 0: the -1e30 fill averages V uniformly over every slot
    uniform = v[0].mean(axis=0)                               # (KV, D)
    np.testing.assert_allclose(got[0].numpy().reshape(2, g, 32),
                               np.broadcast_to(uniform[:, None], (2, g, 32)),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("h,kv,window", [(32, 8, None), (32, 8, 40)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_at_head_dim_120(h, kv, window, dtype):
    """H2O-Danube-3's heads (32 over 8, head_dim 120) against the Pallas
    kernel and the oracle, lengths 0, 1, S and above S."""
    s = 128
    q, k, v, lengths = _dense_inputs(11, 4, h, kv, s, 120, [0, 1, s, s + 9])
    jdt, tdt, _ = DTYPES[dtype]
    got = da.decode_attention(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                              torch.from_numpy(lengths), window=window)
    assert got.shape == (4, h, 120)
    jx = [jnp.asarray(x, jdt) for x in (q, k, v)]
    _close(jax_decode_attention(*jx, jnp.asarray(lengths), window=window, block_k=128,
                                interpret=True), got, dtype)
    _close(jref.decode_attention_ref(*jx, jnp.asarray(lengths), window=window), got,
           dtype)


@pytest.mark.parametrize("kw,exc", [
    (dict(dtype=torch.float16), TypeError),
    (dict(d=44), ValueError),                       # head_dim % 8
    (dict(h=8 * 33, kv=8), ValueError),             # group > 32
    (dict(window=0), ValueError),
    (dict(lengths=3), ValueError),                  # lengths not (B,)
    (dict(d=264), ValueError),                      # head_dim > 256
])
def test_decode_kernel_checks_refuse_what_the_kernel_does_not_take(kw, exc):
    a = dict(dtype=torch.float32, h=8, kv=2, d=64, window=None, lengths=2)
    a.update(kw)
    q = torch.zeros(2, a["h"], a["d"], dtype=a["dtype"])
    k = torch.zeros(2, 16, a["kv"], a["d"], dtype=a["dtype"])
    with pytest.raises(exc):
        da._check(q, k, k.clone(), torch.ones(a["lengths"], dtype=torch.int32),
                  a["window"])


# ---------------------------------------------------------------------------
# RWKV-6 WKV scan
# ---------------------------------------------------------------------------

def _wkv_inputs(seed, b, t, h, d):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, t, h, d)).astype(np.float32) for _ in range(3))
    w = rng.uniform(0.3, 1.0, size=(b, t, h, d)).astype(np.float32)
    u = rng.normal(size=(h, d)).astype(np.float32) * 0.5
    state = rng.normal(size=(b, h, d, d)).astype(np.float32) * 0.3
    return r, k, v, w, u, state


def test_rwkv6_scan_matches_the_pallas_kernel_and_the_oracle():
    arrays = _wkv_inputs(0, 2, 64, 3, 32)
    tx = [torch.from_numpy(x) for x in arrays]
    y, state = wkv.rwkv6_scan(*tx)
    assert y.dtype == state.dtype == torch.float32 and y.shape == (2, 64, 3, 32)
    jx = [jnp.asarray(x) for x in arrays]
    for jy, jstate in (jax_rwkv6_scan(*jx, block_t=32, interpret=True),
                       jref.rwkv6_scan_ref(*jx)):
        _close(jy, y, "float32")
        _close(jstate, state, "float32")
    # the state carried across a split of T continues the recurrence
    r, k, v, w, u, s0 = tx
    y1, s1 = wkv.rwkv6_scan(r[:, :23], k[:, :23], v[:, :23], w[:, :23], u, s0)
    y2, s2 = wkv.rwkv6_scan(r[:, 23:], k[:, 23:], v[:, 23:], w[:, 23:], u, s1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(s2, state, rtol=2e-5, atol=2e-5)


def test_rwkv6_scan_takes_mixed_dtypes_like_the_model():
    """The model hands over bf16 r/k/v and fp32 w: each is widened to fp32,
    as the oracle widens them."""
    r, k, v, w, u, s0 = _wkv_inputs(1, 2, 5, 2, 32)
    bf = [torch.from_numpy(x).to(torch.bfloat16) for x in (r, k, v)]
    y, state = wkv.rwkv6_scan(*bf, torch.from_numpy(w), torch.from_numpy(u),
                              torch.from_numpy(s0))
    jy, jstate = jref.rwkv6_scan_ref(*(jnp.asarray(x.float().numpy()) for x in bf),
                                     jnp.asarray(w), jnp.asarray(u), jnp.asarray(s0))
    _close(jy, y, "float32")
    _close(jstate, state, "float32")


@pytest.mark.parametrize("kw,exc", [
    (dict(d=48), ValueError),                       # head_dim
    (dict(state_dtype=torch.bfloat16), TypeError),
    (dict(t=0), ValueError),
    (dict(w_dtype=torch.float16), TypeError),
])
def test_scan_kernel_checks_refuse_what_the_kernel_does_not_take(kw, exc):
    a = dict(d=32, t=3, state_dtype=torch.float32, w_dtype=torch.float32)
    a.update(kw)
    x = torch.zeros(2, a["t"], 2, a["d"])
    with pytest.raises(exc):
        wkv._check(x, x, x, x.to(a["w_dtype"]), torch.zeros(2, a["d"]),
                   torch.zeros(2, 2, a["d"], a["d"], dtype=a["state_dtype"]))


# ---------------------------------------------------------------------------
# RG-LRU scan
# ---------------------------------------------------------------------------

def _lru_inputs(seed, b, t, w):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.01, 0.99, size=(b, t, w)).astype(np.float32)
    bb = (rng.normal(size=(b, t, w)) * 0.5).astype(np.float32)
    h0 = (rng.normal(size=(b, w)) * 0.5).astype(np.float32)
    return a, bb, h0


def test_rglru_scan_matches_the_pallas_kernel_and_the_oracle():
    arrays = _lru_inputs(0, 2, 64, 64)
    hs, h_last = lru.rglru_scan(*(torch.from_numpy(x) for x in arrays))
    jx = [jnp.asarray(x) for x in arrays]
    for jhs, jlast in (jax_rglru_scan(*jx, block_t=32, block_w=32, interpret=True),
                       jref.rglru_scan_ref(*jx)):
        _close(jhs, hs, "float32")
        _close(jlast, h_last, "float32")


@pytest.mark.parametrize("kw,exc", [
    (dict(a_dtype=torch.float16), TypeError),
    (dict(h0_dtype=torch.bfloat16), TypeError),
    (dict(t=0), ValueError),
    (dict(b_shape=(2, 3, 8)), ValueError),           # b unlike a
    (dict(h0_shape=(2, 8)), ValueError),             # h0 not (B, W)
    (dict(a_ndim=2), ValueError),
    (dict(strided_w=True), ValueError),               # width axis not contiguous
])
def test_rglru_kernel_checks_refuse_what_the_kernel_does_not_take(kw, exc):
    a = dict(a_dtype=torch.float32, h0_dtype=torch.float32, t=3, b_shape=None,
             h0_shape=(2, 16), a_ndim=3, strided_w=False)
    a.update(kw)
    x = torch.zeros(2, a["t"], 32)[..., ::2] if a["strided_w"] else torch.zeros(2, a["t"], 16)
    av = x.to(a["a_dtype"]) if a["a_ndim"] == 3 else x[:, 0].to(a["a_dtype"])
    bv = torch.zeros(a["b_shape"]) if a["b_shape"] else x
    with pytest.raises(exc):
        lru._check(av, bv, torch.zeros(a["h0_shape"], dtype=a["h0_dtype"]))


def test_rglru_scan_refuses_inputs_that_need_a_gradient():
    """No backward kernel (nor had the TPU's): the wrapper raises under
    autograd on every device, the CPU's plain version included."""
    a, bb, h0 = (torch.from_numpy(x) for x in _lru_inputs(1, 1, 4, 8))
    with pytest.raises(RuntimeError, match="no backward"):
        lru.rglru_scan(a.requires_grad_(), bb, h0)
    with torch.no_grad():
        lru.rglru_scan(a, bb, h0)


def test_new_wrappers_refuse_devices_other_than_cpu_and_cuda():
    q = torch.zeros(1, 4, 64, device="meta")
    k = torch.zeros(1, 16, 2, 64, device="meta")
    with pytest.raises(ValueError, match="device"):
        da.decode_attention(q, k, k, torch.ones(1, device="meta"))
    x = torch.zeros(1, 2, 2, 32, device="meta")
    with pytest.raises(ValueError, match="device"):
        wkv.rwkv6_scan(x, x, x, x, torch.zeros(2, 32, device="meta"),
                       torch.zeros(1, 2, 32, 32, device="meta"))
    a = torch.zeros(1, 2, 32, device="meta")
    with pytest.raises(ValueError, match="device"):
        lru.rglru_scan(a, a, torch.zeros(1, 32, device="meta"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kv,d,page_size,pages_per_seq", [
    (16, 32, 8, 128, 16, 64),   # the serving slice's shape
    (3, 12, 3, 64, 8, 5),       # odd
    (2, 8, 1, 128, 16, 6),      # MQA
    (4, 32, 8, 120, 16, 8),     # head_dim 120 (H2O-Danube-3)
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_version(cuda_device, b, h, kv, d,
                                           page_size, pages_per_seq, dtype):
    _, tx = _both(_inputs(4, b, h, kv, d, page_size, pages_per_seq,
                          masked_row=True), dtype)
    tx = [t.to(cuda_device) for t in tx]
    before = pda.paged_decode_attention.launches
    got = pda.paged_decode_attention(*tx, softcap=30.0)
    torch.cuda.synchronize()
    assert pda.paged_decode_attention.launches == before + 1
    want = ref.paged_decode_attention_ref(*tx, softcap=30.0)
    tol = DTYPES[dtype][2]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("h,kv", [(32, 8), (48, 8), (64, 4)])   # G = 4, 6, 16
@pytest.mark.parametrize("d", [64, 120, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_int8_pool_matches_plain_version(cuda_device, h, kv, d, dtype):
    """int8 pools with scales, as the port's ``quantize_kv`` makes them, at
    Qwen3-4B's, DBRX-132B's and Qwen3-MoE-235B-A22B's groups: bf16 q on the
    tensor cores, fp32 q on the CUDA cores; a fully masked row, a -1 entry
    inside a live range, -1 tails, a softcap; at head_dim 120 a row is 120
    bytes, 8-byte aligned."""
    from repro_torch.models.paged import quantize_kv

    _, tx = _both(_inputs(12, 4, h, kv, d, 16, 8, masked_row=True), dtype)
    q, kp, vp, bt, lengths = [t.to(cuda_device) for t in tx]
    bt[1, 0] = -1
    (kc, ks), (vc, vs) = quantize_kv(kp.float()), quantize_kv(vp.float())
    mma = pda.plan(bt.shape[1], 16, 4 * kv, da.sm_count(cuda_device), h // kv, q.dtype,
                   torch.int8, d)[3]
    assert mma == (dtype == "bfloat16")
    before = (pda.paged_decode_attention.launches, pda.paged_decode_attention.launches_int8)
    got = pda.paged_decode_attention(q, kc, vc, bt, lengths, k_scales=ks, v_scales=vs,
                                     softcap=30.0)
    torch.cuda.synchronize()
    assert (pda.paged_decode_attention.launches,
            pda.paged_decode_attention.launches_int8) == (before[0] + 1, before[1] + 1)
    want = ref.paged_decode_attention_ref(q, kc, vc, bt, lengths, k_scales=ks,
                                          v_scales=vs, softcap=30.0)
    tol = DTYPES[dtype][2]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_cuda_int8_pool_tensor_core_instances_run_hmma(cuda_device):
    """The paged kernel's int8-pool instances for bf16 q at head_dim 64,
    128 and 256 (16- and 8-byte copies) compute with mma.sync: HMMA in each
    one's SASS, counted by ``chip_smoke._sass_hmma``."""
    import importlib.util
    import re
    from pathlib import Path

    from repro_torch.kernels import build

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    build.library("paged_decode_attention")
    hmma = {m.groups(): n["hmma"]
            for fn, n in smoke._sass_hmma("paged_decode_attention").items()
            for m in [re.search(smoke.PAGED_INT8_MMA, fn)] if m}
    assert sorted(hmma) == sorted((str(d), str(vb)) for d in (64, 128, 256)
                                  for vb in (8, 16)), hmma
    assert all(hmma.values()), hmma


def _flash_against_plain(device, b, h, kv, s, d, window, softcap, dtype, causal=True):
    from repro_torch.kernels import flash_attention as fa

    tdt, tol = DTYPES[dtype][1], DTYPES[dtype][2]
    rng = np.random.default_rng(5)
    # q/k/v as the trainer has them: (B, S, heads, D) seen as (B, heads, S, D)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(b, s, n, d)).astype(np.float32))
                   .to(device, tdt).transpose(1, 2) for n in (h, kv, kv, h))
    opts = dict(causal=causal, window=window, softcap=softcap)
    before = (fa.flash_attention.launches_fwd, fa.flash_attention.launches_bwd)
    o, lse = fa.flash_attention_fwd(q, k, v, **opts)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do, **opts)
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches_fwd, fa.flash_attention.launches_bwd) == (
        before[0] + 1, before[1] + 1)
    assert o.stride() == q.stride()
    want_o, want_lse = ref.flash_attention_ref(q, k, v, return_lse=True, **opts)
    torch.testing.assert_close(o.float(), want_o.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, want_lse, rtol=tol, atol=tol)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **opts)
    for got, w in zip(grads, want):
        scale = w.float().abs().max().item()   # gradients: tolerance x max |grad|
        torch.testing.assert_close(got.float(), w.float(), rtol=tol,
                                   atol=tol * scale)
    return q, k, v, o, lse, do, grads


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kv,s,d,window,softcap", [
    (2, 16, 8, 512, 128, None, None),   # the trainer's shape (Qwen3-1.7B), fewer rows
    (1, 8, 2, 300, 64, 128, 30.0),      # odd: ragged S, G = 4, window, softcap
    (1, 2, 1, 77, 256, None, None),     # head_dim 256
    (2, 32, 8, 300, 120, 128, 30.0),    # head_dim 120 (H2O-Danube-3), window, softcap
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_kernels_match_plain_versions(cuda_device, b, h, kv, s, d,
                                                 window, softcap, dtype):
    _flash_against_plain(cuda_device, b, h, kv, s, d, window, softcap, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kv,s,d,window,softcap", [
    (2, 16, 16, 1024, 64, None, None),   # Seamless' encoder, cut to B=2
    (2, 16, 4, 300, 64, None, None),     # odd: ragged S, G = 4 (the dK/dV blocks split heads)
    (2, 8, 2, 256, 128, None, None),     # head_dim 128
    (2, 8, 2, 300, 120, 128, 30.0),      # head_dim 120, window and softcap
    (1, 4, 1, 77, 32, None, 5.0),        # head_dim 32, one KV head, a ragged single tile
    (1, 8, 1, 300, 256, None, None),     # head_dim 256 (the dK/dV pair kernel), ragged S
])
def test_cuda_noncausal_bf16_flash_matches_plain_and_repeats_bitwise(cuda_device, b, h, kv, s,
                                                                     d, window, softcap):
    """The wgmma route (bf16, causal=False) against the plain versions; its
    backward, free of atomics, gives the same bits when run again."""
    from repro_torch.kernels import flash_attention as fa

    assert fa.route(torch.bfloat16, False, d) == "wgmma"
    q, k, v, o, lse, do, grads = _flash_against_plain(cuda_device, b, h, kv, s, d, window,
                                                      softcap, "bfloat16", causal=False)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=False, window=window,
                                   softcap=softcap)
    torch.cuda.synchronize()
    for x, y in zip(grads, again):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kv,s,d,window,softcap", [
    (2, 16, 8, 512, 128, None, None),    # the trainer's shape (Qwen3-1.7B), fewer rows
    (1, 4, 4, 37, 64, None, None),       # S < 64: one ragged tile, G = 1
    (1, 2, 1, 65, 128, None, None),      # S = 65: a second tile of one key
    (2, 16, 4, 300, 64, 128, 30.0),      # ragged S, G = 4, window, softcap
    (1, 48, 8, 300, 128, None, None),    # DBRX's group of 6
    (1, 64, 4, 200, 128, None, 30.0),    # Qwen3-MoE's group of 16, a softcap
    (2, 8, 1, 300, 256, None, None),     # PaliGemma's 8 x 256, ragged S
    (1, 8, 1, 512, 256, None, 30.0),     # 8 x 256 with a softcap (the pair's hand-over)
    (1, 16, 1, 2100, 256, 2048, None),   # RecurrentGemma-9B's 16 x 256 and its window
    (2, 32, 8, 300, 120, 128, 30.0),     # head_dim 120 (H2O-Danube-3), window, softcap
    (1, 8, 2, 130, 32, None, None),      # head_dim 32
])
def test_cuda_causal_bf16_flash_matches_plain_and_repeats_bitwise(cuda_device, b, h, kv, s, d,
                                                                  window, softcap):
    """The wgmma route under causality (the trainer's attention) against the
    plain versions: ragged S, G = 1 / 4 / 6 / 8 / 16, head_dim 32 to 256,
    windows and softcaps; its backward, free of atomics (dK/dV's parts sum
    their partials in a fixed order), gives the same bits when run again."""
    from repro_torch.kernels import flash_attention as fa

    assert fa.route(torch.bfloat16, True, d) == "wgmma"
    q, k, v, o, lse, do, grads = _flash_against_plain(cuda_device, b, h, kv, s, d, window,
                                                      softcap, "bfloat16", causal=True)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True, window=window,
                                   softcap=softcap)
    torch.cuda.synchronize()
    for x, y in zip(grads, again):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_cuda_bf16_flash_kernels_run_wgmma_only(cuda_device):
    """Every bf16 flash kernel (forward, dQ, dK/dV at the three head_dim
    instances, causal and not) computes its products with wgmma (HGMMA in
    its SASS) and none with mma.sync (HMMA)."""
    import re
    import shutil
    import subprocess

    from repro_torch.kernels import build

    build.library("flash_attention")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(build._target(build.sources()["flash_attention"]))],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1) if "_wgmma_kernel" in m.group(1) else None
            if fn:
                counts[fn] = [0, 0]
        elif fn and "HGMMA" in line:
            counts[fn][0] += 1
        elif fn and "HMMA" in line:
            counts[fn][1] += 1
    assert len(counts) == 18, counts       # 3 kernels x 3 head_dim instances x causal or not
    assert all(hg and not hm for hg, hm in counts.values()), counts


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kv,s,d", [
    (1, 32, 2, 512, 128),   # G x D = 2,048 (Qwen3-MoE's group)
    (1, 8, 1, 512, 256),    # PaliGemma's group, G x D = 2,048
    (1, 48, 8, 200, 128),   # DBRX's group of 6
])
def test_cuda_bf16_flash_takes_groups_beyond_the_fp32_limit(cuda_device, b, h, kv, s, d):
    """The tensor-core route holds one query head per block: no G x D limit."""
    _flash_against_plain(cuda_device, b, h, kv, s, d, None, None, "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kv,s,d,window,softcap", [
    (1, 8, 1, 300, 256, None, None),     # PaliGemma-3B's group, 8 x 256, ragged S
    (1, 16, 1, 2100, 256, 2048, None),   # RecurrentGemma-9B's 16 x 256 and its window
    (1, 64, 4, 200, 128, None, 30.0),    # Qwen3-MoE-235B-A22B's 16 x 128, a softcap
    (1, 48, 8, 300, 128, None, None),    # DBRX-132B's 6 x 128
    (2, 32, 2, 300, 120, 128, 30.0),     # a group of 16 at head_dim 120, window, softcap
])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_fp32_flash_takes_every_group_and_repeats_bitwise(cuda_device, b, h, kv, s, d,
                                                               window, softcap, causal):
    """The fp32 route (3xTF32, one query head per block) at the groups the
    old route refused, within 2e-5 of the plain versions; its backward,
    free of atomics, gives the same bits when run again."""
    from repro_torch.kernels import flash_attention as fa

    assert fa.route(torch.float32, causal, d) == "fp32"
    q, k, v, o, lse, do, grads = _flash_against_plain(cuda_device, b, h, kv, s, d, window,
                                                      softcap, "float32", causal=causal)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, window=window,
                                   softcap=softcap)
    torch.cuda.synchronize()
    for x, y in zip(grads, again):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_cuda_fp32_flash_kernels_run_tf32_mmas(cuda_device):
    """Every fp32 forward, dQ and dK/dV kernel instance computes its products
    with TF32 tensor-core MMAs (HMMA ... TF32 in its SASS)."""
    import re
    import shutil
    import subprocess

    from repro_torch.kernels import build

    build.library("flash_attention")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(build._target(build.sources()["flash_attention"]))],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    kernel = re.compile(r"flash_(fwd|bwd_dq|bwd_dkv)_f32(_pair)?_kernel")
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1) if kernel.search(m.group(1)) else None
            if fn:
                counts[fn] = 0
        elif fn and "HMMA" in line and "TF32" in line:
            counts[fn] += 1
    assert len(counts) == 9, counts        # 3 kernels x 3 head_dim instances
    assert all(counts.values()), counts


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kv,s,d,window", [
    (16, 32, 8, 1024, 128, None),   # the slot engine's serve shape (Qwen3-4B)
    (3, 8, 2, 300, 64, 128),        # odd: ragged S, G = 4, a window
    (2, 8, 8, 77, 256, None),       # MHA, head_dim 256
    (4, 32, 8, 300, 120, 128),      # head_dim 120 (H2O-Danube-3), a window
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_decode_kernel_matches_plain_version(cuda_device, b, h, kv, s, d,
                                                  window, dtype):
    q, k, v, _ = _dense_inputs(6, b, h, kv, s, d, [0] * b)
    lengths = np.random.default_rng(7).integers(0, s + 40, b).astype(np.int32)
    n = min(b, 3)
    lengths[:n] = [0, 1, s][:n]             # no valid key, one, all of S
    tdt, tol = DTYPES[dtype][1], DTYPES[dtype][2]
    tx = [torch.from_numpy(x).to(cuda_device, tdt) for x in (q, k, v)]
    lens = torch.from_numpy(lengths).to(cuda_device)
    before = da.decode_attention.launches
    got = da.decode_attention(*tx, lens, window=window)
    torch.cuda.synchronize()
    assert da.decode_attention.launches == before + 1
    want = ref.decode_attention_ref(*tx, lens, window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def _split_lengths(b, keys, chunk, splits, window=None):
    """0, 1, chunk - 1, chunk, chunk + 1, the last key, past it (with a
    window: past S by more than the window), then rows ending in each split
    count."""
    fixed = [0, 1, chunk - 1, chunk, chunk + 1, keys, keys + (window or 0) + 37]
    rest = b - len(fixed)
    return fixed + [(1 + i * (splits - 1) // max(rest - 1, 1)) * chunk - i % 3
                    for i in range(rest)]


@pytest.mark.cuda
@pytest.mark.parametrize("h,kv,d,window", [
    (32, 8, 128, None),      # Qwen3-4B's heads
    (16, 1, 256, 2048),      # RecurrentGemma-9B's: one KV head, a window past S
    (16, 1, 256, "chunk"),   # a window across a chunk boundary
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_split_decode_kernel_at_chunk_boundaries(cuda_device, h, kv, d, window,
                                                      dtype):
    """The split dense kernel (both routes) at the slice shapes, lengths on
    and around its chunk boundaries and empty splits."""
    b, s = 16, 1024
    tdt, tol = DTYPES[dtype][1], DTYPES[dtype][2]
    splits, chunk, _ = da.plan(s, b * kv, da.sm_count(cuda_device), h // kv, tdt, d)
    window = chunk + 5 if window == "chunk" else window
    q, k, v, _ = _dense_inputs(31, b, h, kv, s, d, [0] * b)
    tx = [torch.from_numpy(x).to(cuda_device, tdt) for x in (q, k, v)]
    lens = torch.tensor(_split_lengths(b, s, chunk, splits, window), dtype=torch.int32,
                        device=cuda_device)
    got = da.decode_attention(*tx, lens, window=window)
    torch.cuda.synchronize()
    want = ref.decode_attention_ref(*tx, lens, window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,pool,softcap", [("bfloat16", "bfloat16", None),
                                                  ("float32", "float32", 30.0),
                                                  ("bfloat16", "int8", None),
                                                  ("bfloat16", "int8", 30.0),
                                                  ("float32", "int8", 30.0)])
def test_cuda_split_paged_kernel_at_chunk_boundaries(cuda_device, q_dtype, pool, softcap):
    """The split paged kernel (both routes) at the serving shape: a row of
    -1 entries with a length, a length-0 row with every entry assigned, a -1
    entry inside a live range, an all -1 chunk between live ones, lengths
    on and around the chunk boundaries and past P * page."""
    from repro_torch.models.paged import quantize_kv

    b, h, kv, d, page, p_seq = 16, 32, 8, 128, 16, 64
    tdt, tol = DTYPES[q_dtype][1], DTYPES[q_dtype][2]
    pool_dtype = torch.int8 if pool == "int8" else DTYPES[pool][1]
    splits, chunk, _, _ = pda.plan(p_seq, page, b * kv, da.sm_count(cuda_device), h // kv,
                                   tdt, pool_dtype, d)
    lengths = _split_lengths(b, p_seq * page, chunk * page, splits)
    lengths[0], lengths[1] = 5 * page + 3, 0
    q, kp, vp, bt, _ = _inputs(32, b, h, kv, d, page, p_seq)
    bt = np.random.default_rng(33).permutation(np.arange(1, kp.shape[0]))[:b * p_seq]
    bt = bt.reshape(b, p_seq).astype(np.int32)
    for i, length in enumerate(lengths):
        if i != 1:
            bt[i, -(-length // page):] = -1
    bt[0] = -1
    bt[2, 0] = -1
    middle = next(i for i, n in enumerate(lengths) if 2 * chunk * page < n <= p_seq * page)
    bt[middle, chunk:2 * chunk] = -1
    tq = torch.from_numpy(q).to(cuda_device, tdt)
    kp, vp = (torch.from_numpy(x).to(cuda_device) for x in (kp, vp))
    scales = {}
    if pool == "int8":
        (kp, ks), (vp, vs) = quantize_kv(kp), quantize_kv(vp)
        scales = {"k_scales": ks, "v_scales": vs}
    else:
        kp, vp = kp.to(pool_dtype), vp.to(pool_dtype)
    tables = torch.from_numpy(bt).to(cuda_device)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
    got = pda.paged_decode_attention(tq, kp, vp, tables, lens, softcap=softcap, **scales)
    torch.cuda.synchronize()
    want = ref.paged_decode_attention_ref(tq, kp, vp, tables, lens, softcap=softcap,
                                          **scales)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_cuda_split_wrappers_never_wait_for_the_device(cuda_device):
    """The splits come from static shapes: neither wrapper reads lengths or
    tables on the host (a sync raises under the "error" debug mode), and
    each launch leaves the combine's counters at zero."""
    q, k, v, lengths = _dense_inputs(34, 4, 16, 1, 512, 256, [0, 1, 300, 600])
    dense = [torch.from_numpy(x).to(cuda_device, torch.bfloat16) for x in (q, k, v)]
    dense.append(torch.from_numpy(lengths).to(cuda_device))
    _, paged = _both(_inputs(35, 4, 32, 8, 128, 16, 64, masked_row=True), "bfloat16")
    paged = [t.to(cuda_device) for t in paged]
    da.decode_attention(*dense, window=100)         # built and warm
    pda.paged_decode_attention(*paged)
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        da.decode_attention(*dense, window=100)
        pda.paged_decode_attention(*paged)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()
    device = paged[0].device                          # the wrappers' key: cuda:N
    counters, _ = da.split_scratch(device, torch.cuda.current_stream(device).cuda_stream,
                                   4 * 8, 0)
    assert int(counters.abs().sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,d", [(1, 512, 40, 64), (16, 1, 40, 64), (2, 300, 3, 32),
                                     (1, 17, 2, 128)])
@pytest.mark.parametrize("rkv_dtype", ["float32", "bfloat16"])
def test_cuda_scan_kernel_matches_plain_version(cuda_device, b, t, h, d, rkv_dtype):
    r, k, v, w, u, s0 = _wkv_inputs(8, b, t, h, d)
    tdt = DTYPES[rkv_dtype][1]
    rkv = [torch.from_numpy(x).to(cuda_device, tdt) for x in (r, k, v)]
    rest = [torch.from_numpy(x).to(cuda_device) for x in (w, u, s0)]
    before = wkv.rwkv6_scan.launches
    y, state = wkv.rwkv6_scan(*rkv, *rest)
    torch.cuda.synchronize()
    assert wkv.rwkv6_scan.launches == before + 1
    want_y, want_state = ref.rwkv6_scan_ref(*rkv, *rest)
    # fp32 arithmetic on both sides (bf16 inputs are widened exactly)
    torch.testing.assert_close(y, want_y, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(state, want_state, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
def test_cuda_scan_kernel_refuses_inputs_that_need_a_gradient(cuda_device):
    """The scan kernel has no backward: under autograd the wrapper raises
    before it launches, on the card as on the CPU."""
    r, k, v, w, u, s0 = (torch.from_numpy(x).to(cuda_device)
                         for x in _wkv_inputs(9, 1, 4, 2, 64))
    before = wkv.rwkv6_scan.launches
    with pytest.raises(RuntimeError, match="no backward"):
        wkv.rwkv6_scan(r, k, v, w.requires_grad_(), u, s0)
    assert wkv.rwkv6_scan.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,w", [(1, 512, 4096), (16, 1, 4096), (3, 300, 96)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_rglru_kernel_matches_plain_version(cuda_device, b, t, w, dtype):
    a, bb, h0 = _lru_inputs(10, b, t, w)
    tdt = DTYPES[dtype][1]
    ta, tb = (torch.from_numpy(x).to(cuda_device, tdt) for x in (a, bb))
    th0 = torch.from_numpy(h0).to(cuda_device)
    before = lru.rglru_scan.launches
    hs, h_last = lru.rglru_scan(ta, tb, th0)
    torch.cuda.synchronize()
    assert lru.rglru_scan.launches == before + 1
    want_hs, want_last = ref.rglru_scan_ref(ta, tb, th0)
    # fp32 arithmetic on both sides (bf16 inputs are widened exactly)
    torch.testing.assert_close(hs, want_hs, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(h_last, want_last, rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# the chunked scan routes (prefill), on the card
# ---------------------------------------------------------------------------

def _strong_decays(seed, shape):
    """w log-uniform in [1e-4, 1]: -log w up to 9.2 a step."""
    return (10.0 ** (-4.0 * np.random.default_rng(seed).uniform(size=shape))).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,d", [(1, 512, 40, 64), (1, 2, 4, 64), (1, 31, 4, 64),
                                     (1, 33, 4, 64), (3, 300, 8, 32), (16, 65, 40, 64),
                                     (1, 300, 8, 128), (1, 2048, 4, 64)])
@pytest.mark.parametrize("strong", [False, True])
def test_cuda_chunked_wkv_matches_plain_version(cuda_device, b, t, h, d, strong):
    """The chunked route (L = 16), bf16 r/k/v with fp32 w (the model's
    dtypes); strong decays reach w = 1e-4."""
    r, k, v, w, u, s0 = _wkv_inputs(11, b, t, h, d)
    if strong:
        w = _strong_decays(12, w.shape)
    rkv = [torch.from_numpy(x).to(cuda_device, torch.bfloat16) for x in (r, k, v)]
    rest = [torch.from_numpy(x).to(cuda_device) for x in (w, u, s0)]
    want_y, want_state = ref.rwkv6_scan_ref(*rkv, *rest)
    y, state = wkv.run(*rkv, *rest, "chunked")
    torch.cuda.synchronize()
    # fp32 arithmetic on both sides, in another order
    torch.testing.assert_close(y, want_y, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(state, want_state, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
def test_cuda_chunked_wkv_continues_and_reads_strided_views(cuda_device):
    """Two chunked calls equal one, and r/k/v/w may be views with time and
    head strides of their own."""
    g = np.random.default_rng(13)
    big = [torch.from_numpy(g.normal(size=(2, 600, 4, 128)).astype(np.float32)).to(cuda_device)
           for _ in range(3)]
    wbig = torch.from_numpy(_strong_decays(14, (2, 600, 4, 128))).to(cuda_device)
    r, k, v = (x[:, ::2, :, :64] for x in big)
    w = wbig[:, ::2, :, 64:]
    u = torch.randn(4, 64, device=cuda_device) * 0.5
    s0 = torch.randn(2, 4, 64, 64, device=cuda_device) * 0.3
    want_y, want_state = ref.rwkv6_scan_ref(r, k, v, w, u, s0)
    y1, s1 = wkv.run(r[:, :101], k[:, :101], v[:, :101], w[:, :101], u, s0, "chunked")
    y2, s2 = wkv.run(r[:, 101:], k[:, 101:], v[:, 101:], w[:, 101:], u, s1, "chunked")
    torch.cuda.synchronize()
    torch.testing.assert_close(torch.cat([y1, y2], 1), want_y, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(s2, want_state, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,w", [(1, 512, 4096), (1, 2, 64), (3, 300, 96), (16, 65, 256),
                                   (1, 2048, 1024)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_chunked_rglru_matches_plain_version(cuda_device, b, t, w, dtype):
    """Chunk lengths 1, 16, 33 and longer than T; a in (1e-4, 1)."""
    a, bb, h0 = _lru_inputs(15, b, t, w)
    a = np.clip(_strong_decays(16, a.shape), 1e-4, 0.9999)
    tdt = DTYPES[dtype][1]
    ta, tb = (torch.from_numpy(x).to(cuda_device, tdt) for x in (a, bb))
    th0 = torch.from_numpy(h0).to(cuda_device)
    want_hs, want_last = ref.rglru_scan_ref(ta, tb, th0)
    for chunk in (1, 16, 33, t + 5):
        hs, h_last = lru.run(ta, tb, th0, "chunked", chunk)
        torch.cuda.synchronize()
        torch.testing.assert_close(hs, want_hs, rtol=2e-5, atol=2e-5)
        torch.testing.assert_close(h_last, want_last, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
def test_cuda_scan_wrappers_take_the_planned_route_without_waiting(cuda_device):
    """At a prefill shape both wrappers take the chunked route, count one
    launch per call, and read no device value on the host (a sync raises
    under the "error" debug mode)."""
    r, k, v, w, u, s0 = (torch.from_numpy(x).to(cuda_device)
                         for x in _wkv_inputs(17, 1, 512, 8, 64))
    a, bb, h0 = (torch.from_numpy(x).to(cuda_device) for x in _lru_inputs(18, 1, 512, 1024))
    assert wkv.plan(1, 512, 8, 64)[0] == "chunked" and lru.plan(1, 512, 1024)[0] == "chunked"
    wkv.rwkv6_scan(r, k, v, w, u, s0)                # built and warm
    lru.rglru_scan(a, bb, h0)
    torch.cuda.synchronize()
    counts = (wkv.rwkv6_scan.launches, wkv.rwkv6_scan.launches_chunked,
              lru.rglru_scan.launches, lru.rglru_scan.launches_chunked)
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        wkv.rwkv6_scan(r, k, v, w, u, s0)
        lru.rglru_scan(a, bb, h0)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()
    assert (wkv.rwkv6_scan.launches, wkv.rwkv6_scan.launches_chunked,
            lru.rglru_scan.launches, lru.rglru_scan.launches_chunked) == tuple(
                c + 1 for c in counts)
