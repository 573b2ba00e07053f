"""Flash attention: causal / windowed / softcapped GQA attention over a full
sequence, forward and backward.

Replaces the Pallas TPU kernel ``_flash_kernel`` behind
``repro.kernels.flash_attention.flash_attention`` (forward only there: the
JAX trainer differentiates plain ``attend``).  Here the trainer's attention
runs through ``FlashAttention``, whose backward is a kernel too.  The CUDA
kernels are ``src/repro_torch/csrc/flash_attention.cu``, built for
``sm_90a`` at first use (``kernels/build.py``) and called through
``ctypes``.

What bounds it on an H100: at the trainer's shape the causal forward does
~170 flops per byte of q/k/v/o, below bf16's ridge (~295), so its roofline
bound is the bytes; this first version computes with fp32 FMAs on the CUDA
cores from shared-memory tiles and is bound by those operations.  It skips
every key tile outside the causal/window band and loads each K/V tile once
for the G query heads of a group.  Tensor-core MMAs are later work.

Layout: the public functions keep the JAX function's ``(B, H, S, D)`` /
``(B, KV, S, D)``, and the kernels read every tensor by its (batch, head,
sequence) strides, so transposed views of the projections' ``(B, S, H, D)``
go in without copies and outputs come back in the inputs' layout.  The
head_dim axis must be contiguous and 16-byte aligned.

On a CPU tensor the wrappers run the plain versions (``ref.py``); on a CUDA
tensor they launch the kernels or raise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention_bwd_ref, flash_attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128, 256)
# G * D: 128 threads per query head (at most 1024 a block), D/2 fp32
# accumulators each; the forward's tiles then fit in shared memory
_MAX_GROUP_DIM = 512


def _bind(lib: ctypes.CDLL):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ll_p = ctypes.POINTER(ctypes.c_longlong)
    fwd, bwd = lib.flash_attention_fwd, lib.flash_attention_bwd
    if fwd.argtypes is None:
        fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i, ll_p, i, i, f, f, p]
        fwd.restype = ctypes.c_int
        bwd.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, ll_p,
                        i, i, f, f, p]
        bwd.restype = ctypes.c_int
    return fwd, bwd


def _check(q, k, v, causal, window, softcap):
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("flash_attention: q (B, H, S, D), k/v (B, KV, S, D)")
    b, h, s, d = q.shape
    kv = k.shape[1]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype} not "
                        "supported (float32 or bfloat16, all alike)")
    if k.shape != (b, kv, s, d) or v.shape != k.shape or kv == 0 or h % kv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} with k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if d not in _HEAD_DIMS or (h // kv) * d > _MAX_GROUP_DIM:
        raise ValueError(f"flash_attention: head_dim {d} with group {h // kv} not "
                         f"supported (head_dim in {_HEAD_DIMS}, group * head_dim <= "
                         f"{_MAX_GROUP_DIM})")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} must be >= 1")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"flash_attention: softcap {softcap} must be > 0")
    _check_layout(q, k, v)


def _check_layout(*tensors):
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"flash_attention: tensors on {devices}")
    for t in tensors:
        vec = 16 // t.element_size()
        if (t.stride(3) != 1 or any(st % vec for st in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError("flash_attention: head_dim must be contiguous and "
                             "rows 16-byte aligned")


def _strides(*tensors):
    vals = [st for t in tensors for st in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _flags(causal, window, softcap):
    return (int(bool(causal)), 0 if window is None else int(window),
            0.0 if softcap is None else float(softcap))


def flash_attention_fwd(q, k, v, *, causal=True, window=None, softcap=None):
    """q: (B, H, S, D); k/v: (B, KV, S, D).  Returns (o in q's layout and
    dtype, lse (B, H, S) fp32)."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap, return_lse=True)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: device {q.device} not supported")
    _check(q, k, v, causal, window, softcap)
    b, h, s, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    _check_layout(o)
    fwd, _ = _bind(build.library("flash_attention"))
    c, w, cap = _flags(causal, window, softcap)
    strides = _strides(q, k, v, o)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), _DTYPES[q.dtype], b, h, k.shape[1], s, d, strides,
                 c, w, d ** -0.5, cap, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention forward: CUDA launch failed (cudaError {rc})")
    flash_attention.launches_fwd += 1
    return o, lse


def flash_attention_bwd(q, k, v, o, lse, do, *, causal=True, window=None,
                        softcap=None):
    """Gradients (dq, dk, dv) of ``flash_attention_fwd`` for the output
    gradient ``do``, in the layouts and dtypes of q, k, v."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                       window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: device {q.device} not supported")
    _check(q, k, v, causal, window, softcap)
    if do.shape != q.shape or do.dtype != q.dtype or o.shape != q.shape:
        raise ValueError("flash_attention backward: o and do must match q")
    if do.stride(3) != 1 or any(st % (16 // do.element_size()) for st in do.stride()[:3]) \
            or do.data_ptr() % 16:
        do = do.contiguous()   # an upstream gradient's layout is not the caller's choice
    lse = lse.contiguous()
    b, h, s, d = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    _check_layout(o, do, dq, dk, dv)
    _, bwd = _bind(build.library("flash_attention"))
    c, w, cap = _flags(causal, window, softcap)
    strides = _strides(q, k, v, o, do, dq, dk, dv)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), delta.data_ptr(), _DTYPES[q.dtype], b, h,
                 k.shape[1], s, d, strides, c, w, d ** -0.5, cap, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention backward: CUDA launch failed (cudaError {rc})")
    flash_attention.launches_bwd += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: the forward saves (q, k, v, o, lse),
    the backward recomputes P from lse (kernels on the card, the plain
    versions on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                     softcap=softcap)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, **ctx.opts)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal=True, window=None, softcap=None):
    """q: (B, H, S, D); k/v: (B, KV, S, D).  Returns (B, H, S, D) in q's
    dtype and layout; differentiable with respect to q, k and v."""
    return FlashAttention.apply(q, k, v, causal, window, softcap)


# kernel launches: forwards, and backwards (one per backward call, which
# runs the delta, dK/dV and dQ kernels)
flash_attention.launches_fwd = 0
flash_attention.launches_bwd = 0
