"""Flash attention: causal / windowed / softcapped GQA attention over a full
sequence, forward and backward.

Replaces the Pallas TPU kernel ``_flash_kernel`` behind
``repro.kernels.flash_attention.flash_attention`` (``pallas_call`` at
``src/repro/kernels/flash_attention.py:108``; forward only there: the JAX
trainer differentiates plain ``attend``).  Here the trainer's attention
runs through ``FlashAttention``, whose backward is a kernel too.  The CUDA
kernels are ``src/repro_torch/csrc/flash_attention.cu``, built for
``sm_90a`` at first use (``kernels/build.py``) and called through
``ctypes``.

What bounds it on an H100: at the trainer's shape (B=8, H=16, KV=8, S=512,
D=128, bf16) the causal forward does ~170 flops per byte of q/k/v/o, below
bf16's ridge (~295), so its roofline bound is the bytes; Seamless' encoder
(B=16, H=KV=16, S=1024, D=64, ``causal=False``) does ~500 and is bound by
the operations.  The earlier causal kernels (``mma.sync``) met neither
bound: they were held by latency, copies and products serialised in each
warp.

Routes (``route``), from the dtype alone (no route falls back to another;
a failed build or launch raises):

* ``"wgmma"``, every bfloat16 call, causal or not, at the head_dim
  instances 64, 128 and 256: Hopper's warpgroup MMAs on tiles that TMA
  brings into shared memory (``csrc/flash_attention_sm90.cuh``).  Consumer
  warpgroups of 64 query rows (forward: three at instance 64, two at 128,
  one at 256; dQ: two, one at 256) or 64 keys (dK/dV: two with their own
  keys at 64; from 128 a pair sharing 64 keys, one holding dV and the
  other dK) per block, and a producer warp keeping a ring of 64-row tiles
  in flight (at 256 the dK/dV pair issues its own loads: a ninth warp
  would cap every thread at 168 registers).  Under causality a query block's keys end at its diagonal, only
  the diagonal's tile pays for masks, and the latest query tiles launch
  first; a warpgroup whose band is shorter than its block's passes the
  ring tiles it does not need.  dK/dV cuts each key block's (query head,
  query tile) steps into even parts over the SMs (under causality the
  first key block sees every query tile), and a last kernel sums their
  fp32 partials in a fixed order.
* ``"fp32"``: error-compensated TF32 on the tensor cores (``mma.sync``
  m16n8k8): each fp32 operand split into two TF32 parts, hi and lo, each
  product three MMAs (lo hi + hi lo + hi hi, fp32 accumulate), which leaves
  ~2^-21 of a product, inside the fp32 gates (2e-5).  What bounds it: the
  fp32 CUDA cores peak at 67 TFLOP/s and the TF32 tensor cores at 495, so
  fp32-exact products on them are bound at 495 / 3 = 165, which Seamless'
  encoder shape meets in the operations.  One query head per block (any
  group size), K/V tiles through a ``cp.async`` ring; dK/dV cuts each key
  tile's (query head, query tile) steps into even parts over the grid, and
  a last kernel sums their fp32 partials in a fixed order; from head_dim
  128 the backward runs warp pairs.

The bfloat16 route rounds P (and dS in the backward) to bf16 in registers
as the next product's operand, as the TPU kernel casts P to ``v.dtype``.
Every route skips the key tiles outside the causal/window band, and no
backward uses atomics: each is deterministic, the same bits run to run.
head_dim is any multiple of 8 up to 256 (H2O-Danube-3's 120 among them):
the kernels run their instance at the next of 64, 128, 256 with the true
head_dim as an argument; any group size G is taken (DBRX's 6 x 128,
Qwen3-MoE's 16 x 128, PaliGemma's 8 x 256).

Layout: the public functions keep the JAX function's ``(B, H, S, D)`` /
``(B, KV, S, D)``, and the kernels read every tensor by its (batch, head,
sequence) strides, so transposed views of the projections' ``(B, S, H, D)``
go in without copies and outputs come back in the inputs' layout.  The
head_dim axis must be contiguous and 16-byte aligned.

On a CPU tensor the wrappers run the plain versions (``ref.py``); on a CUDA
tensor they launch the kernels or raise; on a meta tensor inside
``build.abstract_kernels()`` they return the outputs' shapes (products
counted as ``FlopCounterMode`` counts ``scaled_dot_product_attention``'s:
the whole S x S square, the causal half included).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention_bwd_ref, flash_attention_ref

_DTYPES = (torch.float32, torch.bfloat16)
# the C entry points' route codes (csrc/flash_attention.cu: `dispatch`,
# which refuses 1, the bf16 mma.sync kernels the wgmma route replaced)
_ROUTES = {"fp32": 0, "wgmma": 2}
# the kernels' instances: head_dim (a multiple of 8 up to 256) runs the next
# one up, with loads past head_dim zero-filled and stores masked
_HEAD_DIM_INSTANCES = (64, 128, 256)


def instance(head_dim: int) -> int:
    """The kernels' head_dim instance: the next of 64, 128, 256."""
    return next(x for x in _HEAD_DIM_INSTANCES if x >= head_dim)


def route(dtype: torch.dtype, causal: bool, head_dim: int) -> str:
    """The kernels a call runs: ``"wgmma"`` (every bfloat16 call, whatever
    the mask and the head_dim instance) or ``"fp32"``.  ``causal`` and
    ``head_dim`` enter no choice; they stay in the signature so that a
    caller names the whole call."""
    return "fp32" if dtype == torch.float32 else "wgmma"


def _bind(lib: ctypes.CDLL):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ll_p = ctypes.POINTER(ctypes.c_longlong)
    fwd, bwd = lib.flash_attention_fwd, lib.flash_attention_bwd
    ws = lib.flash_attention_bwd_workspace
    if fwd.argtypes is None:
        fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i, ll_p, i, i, f, f, p]
        fwd.restype = ctypes.c_int
        bwd.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, ll_p,
                        i, i, f, f, p]
        bwd.restype = ctypes.c_int
        ws.argtypes = [i, i, i, i, i, i, i, i]
        ws.restype = ctypes.c_longlong
    return fwd, bwd, ws


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
    if d % 8 or not 8 <= d <= 256:
        raise ValueError(f"flash_attention: head_dim {d} not supported (a "
                         "multiple of 8 up to 256)")
    if b * h * s >= 2 ** 31:
        raise ValueError(f"flash_attention: B * H * S = {b * h * s} rows (the kernels "
                         "index rows in 32 bits)")
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
    if build.is_abstract(q):
        return tuple(build.abstract_call("flash_attention_fwd", q, k, v))
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: device {q.device} not supported")
    _check(q, k, v, causal, window, softcap)
    b, h, s, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    _check_layout(o)
    fwd, _, _ = _bind(build.library("flash_attention"))
    c, w, cap = _flags(causal, window, softcap)
    strides = _strides(q, k, v, o)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), _ROUTES[route(q.dtype, causal, d)], b, h, k.shape[1],
                 s, d, strides, c, w, d ** -0.5, cap, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention forward: CUDA launch failed (cudaError {rc})")
    build.count_launch(flash_attention, "launches_fwd")
    return o, lse


def flash_attention_bwd(q, k, v, o, lse, do, *, causal=True, window=None,
                        softcap=None):
    """Gradients (dq, dk, dv) of ``flash_attention_fwd`` for the output
    gradient ``do``, in the layouts and dtypes of q, k, v."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                       window=window, softcap=softcap)
    if build.is_abstract(q):
        return tuple(build.abstract_call("flash_attention_bwd", q, k, v, o, lse, do))
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
    kv = k.shape[1]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _check_layout(o, do, dq, dk, dv)
    _, bwd, workspace_floats = _bind(build.library("flash_attention"))
    c, w, cap = _flags(causal, window, softcap)
    strides = _strides(q, k, v, o, do, dq, dk, dv)
    code = _ROUTES[route(q.dtype, causal, d)]
    with torch.cuda.device(q.device):
        # delta (and lse padded on the wgmma route), and the dK/dV partials
        # where the dK/dV blocks cut a key tile's work into parts
        workspace = torch.empty(workspace_floats(code, b, h, kv, s, d, c, w),
                                dtype=torch.float32, device=q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), workspace.data_ptr(), code, b, h, kv, s, d, strides,
                 c, w, d ** -0.5, cap, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention backward: CUDA launch failed (cudaError {rc})")
    build.count_launch(flash_attention, "launches_bwd")
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
# runs the delta (wgmma: prep), dK/dV and dQ kernels, and the sum of the
# dK/dV partials where their blocks cut a key tile's work into parts)
flash_attention.launches_fwd = 0
flash_attention.launches_bwd = 0


def _square(shapes) -> int:
    """B x H x S x S x D of q (B, H, S, D) and k (B, KV, S, D)."""
    (b, h, s, d), sk = shapes[0], shapes[1][2]
    return b * h * s * sk * d


# forward: Q K^T and P V; backward: Q K^T again, dV, dP, dQ and dK
build.register_abstract(
    "flash_attention_fwd",
    lambda t: [(t[0].shape, t[0].dtype), (t[0].shape[:3], torch.float32)],
    lambda shapes: 4 * _square(shapes),
    parallel=({0: 1, 1: 1, 2: 1}, [1, 1]))
build.register_abstract(
    "flash_attention_bwd",
    lambda t: [(x.shape, x.dtype) for x in t[:3]],
    lambda shapes: 10 * _square(shapes),
    parallel=({i: 1 for i in range(6)}, [1, 1, 1]))
