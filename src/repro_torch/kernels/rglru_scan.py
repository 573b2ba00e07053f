"""The RG-LRU linear recurrence ``h_t = a_t * h_{t-1} + b_t``, elementwise
over the width, serial over time.

Replaces the Pallas TPU kernel ``_rglru_kernel`` behind
``repro.kernels.rglru_scan.rglru_scan``.  The CUDA kernel is
``src/repro_torch/csrc/rglru_scan.cu``, built for ``sm_90a`` at first use
(``kernels/build.py``) and called through ``ctypes``.

What bounds it on an H100: the bytes of a, b and hs (two loads and one
store per element).  One thread owns one (batch, channel) pair and keeps
its state in a register over the whole sequence, with several steps'
loads in flight; a and b are read in their own dtypes by strides (no fp32
copies, which the Pallas wrapper made), and any T >= 1 is taken (the TPU
kernel needed ``T % block_t == 0``).

On a CPU tensor the wrapper runs the plain version (``ref.py``); on a CUDA
tensor it launches the kernel or raises.  The kernel has no backward (nor
had the TPU's): on either device the wrapper refuses inputs that need a
gradient.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import rglru_scan_ref

_IN_DTYPES = (torch.float32, torch.bfloat16)


def _bind(lib: ctypes.CDLL):
    fn = lib.rglru_scan
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, p, p]
        fn.restype = ctypes.c_int
    return fn


def _check(a, b, h0):
    if a.dim() != 3:
        raise ValueError(f"rglru_scan: a {tuple(a.shape)} must be (B, T, W)")
    bsz, t, w = a.shape
    if b.shape != a.shape:
        raise ValueError(f"rglru_scan: b {tuple(b.shape)} differs from a "
                         f"{tuple(a.shape)}")
    if h0.shape != (bsz, w):
        raise ValueError(f"rglru_scan: h0 {tuple(h0.shape)} must be ({bsz}, {w})")
    for name, x in (("a", a), ("b", b)):
        if x.dtype not in _IN_DTYPES:
            raise TypeError(f"rglru_scan: {name} dtype {x.dtype} not supported "
                            "(float32, bfloat16)")
        if x.stride(2) != 1:
            raise ValueError(f"rglru_scan: {name} needs a contiguous width axis")
    if h0.dtype != torch.float32:
        raise TypeError(f"rglru_scan: h0 dtype {h0.dtype} must be float32")
    if t < 1 or w < 1 or bsz < 1:
        raise ValueError(f"rglru_scan: empty input {tuple(a.shape)}")
    devices = {x.device for x in (a, b, h0)}
    if len(devices) != 1:
        raise ValueError(f"rglru_scan: tensors on {devices}")


def rglru_scan(a, b, h0):
    """a/b: (B, T, W) fp32 or bf16 each; h0: (B, W) fp32.  Returns
    (hs (B, T, W) fp32, h_last (B, W) fp32)."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (a, b, h0)):
        raise RuntimeError("rglru_scan: the RG-LRU kernel has no backward; "
                           "differentiate through attn_impl='ref' (the plain scan)")
    if a.device.type == "cpu":
        return rglru_scan_ref(a, b, h0)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan: device {a.device} not supported")
    _check(a, b, h0)
    bsz, t, w = a.shape
    h0 = h0.contiguous()
    hs = torch.empty((bsz, t, w), dtype=torch.float32, device=a.device)
    h_last = torch.empty((bsz, w), dtype=torch.float32, device=a.device)
    dtypes = int(a.dtype == torch.bfloat16) | (int(b.dtype == torch.bfloat16) << 1)
    strides = (ctypes.c_longlong * 4)(a.stride(0), a.stride(1), b.stride(0), b.stride(1))
    fn = _bind(build.library("rglru_scan"))
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = fn(a.data_ptr(), b.data_ptr(), h0.data_ptr(), hs.data_ptr(),
                h_last.data_ptr(), dtypes, bsz, t, w,
                ctypes.cast(strides, ctypes.c_void_p), stream)
    if rc != 0:
        raise RuntimeError(f"rglru_scan: CUDA launch failed (cudaError {rc})")
    rglru_scan.launches += 1
    return hs, h_last


rglru_scan.launches = 0
