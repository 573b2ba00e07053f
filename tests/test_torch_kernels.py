"""The port's paged decode attention against the JAX package's Pallas
kernel (interpret mode) and its plain oracle, on the same inputs.

On the CPU the wrapper runs the plain version; the CUDA kernel itself is
held to the plain version by the ``cuda``-marked test (on the card) and by
``chip_smoke.py``.  Tolerances follow tests/test_kernels.py: fp32 2e-5
(reduction order), bf16 2e-2 (bf16 inputs and output)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.paged_decode_attention import (
    paged_decode_attention as jax_paged_decode_attention)
from repro_torch.kernels import paged_decode_attention as pda
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
    q, kp, vp, bt, lengths = _inputs(2, 2, 8, 2, 64, 16, 4)
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
    (torch.float32, 8, 2, 48, 16, ValueError),      # head_dim
    (torch.float32, 8 * 33, 8, 64, 16, ValueError), # group > 32
    (torch.float32, 8, 2, 64, 1024, ValueError),    # tiles beyond shared memory
])
def test_kernel_checks_refuse_what_the_kernel_does_not_take(dtype, h, kv, d,
                                                            page_size, exc):
    q = torch.zeros(2, h, d, dtype=dtype)
    kp = torch.zeros(5, page_size, kv, d, dtype=dtype)
    bt = torch.zeros(2, 2, dtype=torch.int32)
    with pytest.raises(exc):
        pda._check(q, kp, kp.clone(), bt, torch.ones(2, dtype=torch.int32))


def test_wrapper_refuses_devices_other_than_cpu_and_cuda():
    q = torch.zeros(1, 4, 64, device="meta")
    kp = torch.zeros(3, 16, 2, 64, device="meta")
    bt = torch.zeros(1, 2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        pda.paged_decode_attention(q, kp, kp, bt, torch.ones(1, device="meta"))


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
@pytest.mark.parametrize("b,h,kv,s,d,window,softcap", [
    (2, 16, 8, 512, 128, None, None),   # the trainer's shape (Qwen3-1.7B), fewer rows
    (1, 8, 2, 300, 64, 128, 30.0),      # odd: ragged S, G = 4, window, softcap
    (1, 2, 1, 77, 256, None, None),     # head_dim 256
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_kernels_match_plain_versions(cuda_device, b, h, kv, s, d,
                                                 window, softcap, dtype):
    from repro_torch.kernels import flash_attention as fa

    tdt, tol = DTYPES[dtype][1], DTYPES[dtype][2]
    rng = np.random.default_rng(5)
    # q/k/v as the trainer has them: (B, S, heads, D) seen as (B, heads, S, D)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(b, s, n, d)).astype(np.float32))
                   .to(cuda_device, tdt).transpose(1, 2) for n in (h, kv, kv, h))
    before = (fa.flash_attention.launches_fwd, fa.flash_attention.launches_bwd)
    o, lse = fa.flash_attention_fwd(q, k, v, window=window, softcap=softcap)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches_fwd, fa.flash_attention.launches_bwd) == (
        before[0] + 1, before[1] + 1)
    assert o.stride() == q.stride()
    want_o, want_lse = ref.flash_attention_ref(q, k, v, window=window, softcap=softcap,
                                               return_lse=True)
    torch.testing.assert_close(o.float(), want_o.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, want_lse, rtol=tol, atol=tol)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, window=window,
                                       softcap=softcap)
    for got, w in zip(grads, want):
        scale = w.float().abs().max().item()   # gradients: tolerance x max |grad|
        torch.testing.assert_close(got.float(), w.float(), rtol=tol,
                                   atol=tol * scale)
