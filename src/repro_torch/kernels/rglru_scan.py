"""The RG-LRU linear recurrence ``h_t = a_t * h_{t-1} + b_t``, elementwise
over the width, serial over time.

Replaces the Pallas TPU kernel ``_rglru_kernel`` behind
``repro.kernels.rglru_scan.rglru_scan``.  The CUDA kernels are in
``src/repro_torch/csrc/rglru_scan.cu``, built for ``sm_90a`` at first use
(``kernels/build.py``) and called through ``ctypes``.

What bounds it on an H100: the bytes of a, b and hs (two loads and one
store per element).  Two routes, picked by ``plan`` from static shapes only
(no host sync):

- ``"direct"`` (decode, short T, or batches wide enough to fill the card):
  one launch; one thread owns one (batch, channel) pair and keeps its state
  in a register over the whole sequence, several steps' loads in flight.
- ``"chunked"`` (prefill): two launches over (batch, chunk of L steps,
  channel): each chunk's (prod a, h from 0), then each chunk's incoming h
  folded from h0 through the chunks before it and the chunk rerun from it
  (``ref.rglru_scan_chunked_ref`` is the same two passes in plain torch).

a and b are read in their own dtypes by strides (no fp32 copies, which the
Pallas wrapper made), and any T >= 1 is taken (the TPU kernel needed
``T % block_t == 0``).  ``rglru_scan.launches`` counts wrapper calls that
launched (one call is one or two kernel launches),
``rglru_scan.launches_chunked`` those that took the chunked route.

On a CPU tensor the wrapper runs the plain version (``ref.py``); on a CUDA
tensor it launches a route or raises.  The kernels have no backward (nor
had the TPU's): on either device the wrapper refuses inputs that need a
gradient.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import rglru_scan_ref

_IN_DTYPES = (torch.float32, torch.bfloat16)
# the shortest T the plan sends to the chunked route, and the batch x width
# from which the direct route's one thread per channel fills the card alone:
# at T=512, W=4096 on an H100 the chunked route wins at B=3 and the direct
# route from B=6 (chip_smoke.py's sweep)
CHUNKED_MIN_T = 64
DIRECT_MIN_THREADS = 24576
# chunks per sequence the plan aims at (L = ceil(T / CHUNKS), at least MIN_CHUNK)
CHUNKS = 32
MIN_CHUNK = 16
KERNELS_PER_CALL = {"direct": 1, "chunked": 2}


def plan(b: int, t: int, w: int):
    """(route, chunk L) for a of shape (b, t, w): from static shapes only,
    so the wrapper never reads a device value."""
    if t < CHUNKED_MIN_T or b * w >= DIRECT_MIN_THREADS:
        return "direct", 0
    return "chunked", max(MIN_CHUNK, -(-t // CHUNKS))


def _bind(lib: ctypes.CDLL, route: str):
    fn = getattr(lib, "rglru_scan_chunked" if route == "chunked" else "rglru_scan")
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([p] * 6 + [i] * 5 if route == "chunked" else [p] * 5 + [i] * 4) + [p, p]
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


def run(a, b, h0, route: str, chunk: int = 0):
    """Launch a route forced by a check on CUDA tensors (``chunk``: any
    L >= 1).  Counts nothing.  Returns (hs, h_last)."""
    _check(a, b, h0)
    return _launch(a, b, h0, route, chunk)


def _launch(a, b, h0, route, chunk):
    if route not in KERNELS_PER_CALL:
        raise ValueError(f"rglru_scan: unknown route {route!r}")
    if route == "chunked" and chunk < 1:
        raise ValueError(f"rglru_scan: chunk {chunk} must be at least 1")
    bsz, t, w = a.shape
    h0 = h0.contiguous()
    hs = torch.empty((bsz, t, w), dtype=torch.float32, device=a.device)
    h_last = torch.empty((bsz, w), dtype=torch.float32, device=a.device)
    dtypes = int(a.dtype == torch.bfloat16) | (int(b.dtype == torch.bfloat16) << 1)
    strides = (ctypes.c_longlong * 4)(a.stride(0), a.stride(1), b.stride(0), b.stride(1))
    args = [a.data_ptr(), b.data_ptr(), h0.data_ptr(), hs.data_ptr(), h_last.data_ptr()]
    ints = [dtypes, bsz, t, w]
    if route == "chunked":
        # each chunk's (prod a, h from 0): (B, chunks, W) twice
        workspace = torch.empty(2 * bsz * -(-t // chunk) * w, dtype=torch.float32,
                                device=a.device)
        args.append(workspace.data_ptr())
        ints.append(chunk)
    fn = _bind(build.library("rglru_scan"), route)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = fn(*args, *ints, ctypes.cast(strides, ctypes.c_void_p), stream)
    if rc != 0:
        raise RuntimeError(f"rglru_scan: CUDA launch failed (cudaError {rc}, "
                           f"route {route})")
    return hs, h_last


def rglru_scan(a, b, h0):
    """a/b: (B, T, W) fp32 or bf16 each; h0: (B, W) fp32.  Returns
    (hs (B, T, W) fp32, h_last (B, W) fp32)."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (a, b, h0)):
        raise RuntimeError("rglru_scan: the RG-LRU kernel has no backward; "
                           "differentiate through the plain scan (scan_impl='ref', "
                           "as make_train_step does)")
    if a.device.type == "cpu":
        return rglru_scan_ref(a, b, h0)
    if build.is_abstract(a):
        return tuple(build.abstract_call("rglru_scan", a, b, h0))
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan: device {a.device} not supported")
    _check(a, b, h0)
    route, chunk = plan(*a.shape)
    out = _launch(a, b, h0, route, chunk)
    build.count_launch(rglru_scan, *(("launches", "launches_chunked")
                                     if route == "chunked" else ("launches",)))
    return out


rglru_scan.launches = 0
rglru_scan.launches_chunked = 0

# abstract (``build.abstract_kernels``): elementwise only, no matmul-class
# products (FlopCounterMode counts none in the plain scan either)
build.register_abstract(
    "rglru_scan",
    lambda t: [(t[0].shape, torch.float32), (t[2].shape, torch.float32)],
    lambda shapes: 0,
    parallel=({0: 2, 1: 2, 2: 1}, [2, 1]))
