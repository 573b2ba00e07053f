"""Dense-cache decode attention: one query token per row against the slot
engine's statically shaped KV cache, whose slot index is the position.

Replaces the Pallas TPU kernel ``_decode_kernel`` behind
``repro.kernels.decode_attention.decode_attention``.  The CUDA kernel is
``src/repro_torch/csrc/decode_attention.cu``, built for ``sm_90a`` at first
use (``kernels/build.py``) and called through ``ctypes``.

What bounds it on an H100: about two flops per byte of K/V read, so the
bytes of live K/V.  The kernel reads the cache's ``(B, S, KV, D)`` layer
view in place by strides (the Pallas wrapper transposed it), loads each
K/V tile once for the G query heads of a KV head, and walks only the live
keys ``[max(0, len - window), min(len, S))`` of each row: the TPU kernel's
tiling without its dead tiles.  Lengths above S therefore count as S.

head_dim is any multiple of 8 up to 256 (H2O-Danube-3's 120 among them):
the kernel runs its instance at the next of 32, 64, 128, 256 with the true
head_dim as an argument, the lanes past it idle.

On a CPU tensor the wrapper runs the plain version (``ref.py``); on a CUDA
tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import decode_attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GROUP = 32          # 8 warps x 4 query heads per warp


def _bind(lib: ctypes.CDLL):
    fn = lib.decode_attention
    if fn.argtypes is None:
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, ll, ll, ll, i, f, p]
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, lengths, window):
    b, h, d = q.shape
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode_attention: dtypes q {q.dtype}, k {k.dtype}, "
                        f"v {v.dtype} not supported (one of float32, bfloat16)")
    if k.ndim != 4 or k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"decode_attention: k/v {tuple(k.shape)} / "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)} "
                         "(k, v: (B, S, KV, D))")
    kv = k.shape[2]
    if d % 8 or not 8 <= d <= 256:
        raise ValueError(f"decode_attention: head_dim {d} not supported "
                         "(a multiple of 8 up to 256)")
    if h % kv or h // kv > _MAX_GROUP:
        raise ValueError(f"decode_attention: {h} heads over {kv} KV heads "
                         f"not supported (group <= {_MAX_GROUP})")
    if k.stride() != v.stride() or k.stride(3) != 1:
        raise ValueError("decode_attention: k and v need equal strides and a "
                         "contiguous head_dim")
    vec = 16 // k.element_size()     # elements per 16 bytes
    if (any(s % vec for s in k.stride()[:3])
            or k.data_ptr() % 16 or v.data_ptr() % 16):
        raise ValueError("decode_attention: k/v rows must be 16-byte aligned")
    if lengths.shape != (b,):
        raise ValueError(f"decode_attention: lengths {tuple(lengths.shape)} "
                         f"must be ({b},)")
    if window is not None and window < 1:
        raise ValueError(f"decode_attention: window {window} must be >= 1")
    devices = {t.device for t in (q, k, v, lengths)}
    if len(devices) != 1:
        raise ValueError(f"decode_attention: tensors on {devices}")


def decode_attention(q, k, v, lengths, *, window=None):
    """q: (B, H, D); k/v: (B, S, KV, D); lengths: (B,) int number of valid
    cache entries (positions 0..len-1; above S counts as S); ``window``:
    only positions >= len - window.  Returns (B, H, D) in q's dtype."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, lengths, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: device {q.device} not supported")
    _check(q, k, v, lengths, window)
    b, h, d = q.shape
    q = q.contiguous()
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    fn = _bind(build.library("decode_attention"))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
                out.data_ptr(), _DTYPES[q.dtype], b, h, k.shape[2], d, k.shape[1],
                k.stride(0), k.stride(1), k.stride(2),
                0 if window is None else int(window), d ** -0.5, stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention: CUDA launch failed (cudaError {rc})")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
