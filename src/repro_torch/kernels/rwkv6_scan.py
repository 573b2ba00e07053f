"""The RWKV-6 WKV recurrence: ``y_t = r_t^T (S + u * k_t v_t^T)``,
``S <- w_t * S + k_t v_t^T`` per (batch, head), over any number of steps.

Replaces the Pallas TPU kernel ``_wkv_kernel`` behind
``repro.kernels.rwkv6_scan.rwkv6_scan``.  The CUDA kernels are in
``src/repro_torch/csrc/rwkv6_scan.cu``, built for ``sm_90a`` at first use
(``kernels/build.py``) and called through ``ctypes``.

Two routes, picked by ``plan`` from static shapes only (no host sync):

- ``"step"`` (decode and short prompts): one launch; one thread block per
  (batch, head) keeps its (D, D) state in registers over every step.  At
  decode the bytes of the two fp32 states bound it.
- ``"chunked"`` (prefill): three launches over (batch, head, chunk of L
  steps): each chunk's decayed state from zero and total decay, the carry
  of the states across chunks, then each chunk's outputs.  A one-sequence
  prefill runs H x T / L blocks instead of H (``ref.rwkv6_scan_chunked_ref``
  is the same three passes in plain torch).  It takes w in [0, 1], as the
  model makes it (w = exp(-exp(x))).  L is 16 for every head_dim
  (``CHUNK``).

r/k/v/w are read in their own dtypes by strides (no transposed fp32
copies, which the Pallas wrapper made), and any T is taken (the TPU kernel
needed ``T % block_t == 0``).  ``rwkv6_scan.launches`` counts wrapper calls
that launched (one call is one or three kernel launches),
``rwkv6_scan.launches_chunked`` those that took the chunked route.

On a CPU tensor the wrapper runs the plain version (``ref.py``); on a CUDA
tensor it launches a route or raises.  The kernels have no backward: on
either device the wrapper refuses inputs that need a gradient, so a
trainer cannot take its forward for a differentiable one (``attn_impl=
"ref"`` runs the plain scan, which autograd differentiates).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import rwkv6_scan_ref

_IN_DTYPES = (torch.float32, torch.bfloat16)
_HEAD_DIMS = (32, 64, 128)
# the chunk length L of the chunked route, built for every head_dim
CHUNK = 16
# the shortest T the plan sends to the chunked route, and the batch x heads
# from which the step route's one block per (batch, head) fills the card:
# at T=512, H=40 on an H100 the chunked route wins at B=4 and the step
# route from B=6 (chip_smoke.py's sweep)
CHUNKED_MIN_T = 32
STEP_MIN_HEADS = 240
KERNELS_PER_CALL = {"step": 1, "chunked": 3}


def plan(b: int, t: int, h: int, d: int):
    """(route, chunk L) for r of shape (b, t, h, d): from static shapes
    only, so the wrapper never reads a device value."""
    if t < CHUNKED_MIN_T or b * h >= STEP_MIN_HEADS:
        return "step", 0
    return "chunked", CHUNK


def _bind(lib: ctypes.CDLL, route: str):
    fn = getattr(lib, "rwkv6_scan_chunked" if route == "chunked" else "rwkv6_scan")
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([p] * 9 if route == "chunked" else [p] * 8) + [i] * 5 + [p, p]
        fn.restype = ctypes.c_int
    return fn


def _check(r, k, v, w, u, state):
    b, t, h, d = r.shape
    for name, x in zip("rkvw", (r, k, v, w)):
        if x.shape != (b, t, h, d):
            raise ValueError(f"rwkv6_scan: {name} {tuple(x.shape)} differs from "
                             f"r {tuple(r.shape)}")
        if x.dtype not in _IN_DTYPES:
            raise TypeError(f"rwkv6_scan: {name} dtype {x.dtype} not supported "
                            "(float32, bfloat16)")
        if x.stride(3) != 1:
            raise ValueError(f"rwkv6_scan: {name} needs a contiguous head_dim")
    if t < 1:
        raise ValueError("rwkv6_scan: needs at least one step")
    if d not in _HEAD_DIMS:
        raise ValueError(f"rwkv6_scan: head_dim {d} not supported (one of "
                         f"{_HEAD_DIMS})")
    if u.shape != (h, d) or state.shape != (b, h, d, d):
        raise ValueError(f"rwkv6_scan: u {tuple(u.shape)} / state "
                         f"{tuple(state.shape)} must be ({h}, {d}) / "
                         f"({b}, {h}, {d}, {d})")
    if state.dtype != torch.float32:
        raise TypeError(f"rwkv6_scan: state dtype {state.dtype} must be float32")
    devices = {x.device for x in (r, k, v, w, u, state)}
    if len(devices) != 1:
        raise ValueError(f"rwkv6_scan: tensors on {devices}")


def run(r, k, v, w, u, state, route: str):
    """Launch a route forced by a check on CUDA tensors.  Counts nothing.
    Returns (y, new state)."""
    _check(r, k, v, w, u, state)
    return _launch(r, k, v, w, u, state, route)


def _launch(r, k, v, w, u, state, route):
    b, t, h, d = r.shape
    if route not in KERNELS_PER_CALL:
        raise ValueError(f"rwkv6_scan: unknown route {route!r}")
    u = u.float().contiguous()
    state = state.contiguous()
    y = torch.empty((b, t, h, d), dtype=torch.float32, device=r.device)
    new_state = torch.empty_like(state)
    xs = (r, k, v, w)
    dtypes = sum(1 << n for n, x in enumerate(xs) if x.dtype == torch.bfloat16)
    strides = (ctypes.c_longlong * 12)(*(s for x in xs for s in x.stride()[:3]))
    args = [x.data_ptr() for x in xs] + [u.data_ptr(), state.data_ptr(), y.data_ptr(),
                                         new_state.data_ptr()]
    ints = [dtypes, b, t, h, d]
    if route == "chunked":
        # the chunk states (B, H, chunks, D, D) and decays (B, H, chunks, D)
        workspace = torch.empty(b * h * -(-t // CHUNK) * d * (d + 1), dtype=torch.float32,
                                device=r.device)
        args.append(workspace.data_ptr())
    fn = _bind(build.library("rwkv6_scan"), route)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        rc = fn(*args, *ints, ctypes.cast(strides, ctypes.c_void_p), stream)
    if rc != 0:
        raise RuntimeError(f"rwkv6_scan: CUDA launch failed (cudaError {rc}, "
                           f"route {route})")
    return y, new_state


def rwkv6_scan(r, k, v, w, u, state):
    """r/k/v/w: (B, T, H, D) fp32 or bf16 each; u: (H, D); state: (B, H, D,
    D) fp32.  Returns (y (B, T, H, D) fp32, new state (B, H, D, D) fp32)."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (r, k, v, w, u, state)):
        raise RuntimeError("rwkv6_scan: the WKV kernel has no backward; "
                           "differentiate through the plain scan (scan_impl='ref', "
                           "as make_train_step does)")
    if r.device.type == "cpu":
        return rwkv6_scan_ref(r, k, v, w, u, state)
    if build.is_abstract(r):
        return tuple(build.abstract_call("rwkv6_scan", r, k, v, w, u, state))
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan: device {r.device} not supported")
    _check(r, k, v, w, u, state)
    route, _ = plan(*r.shape)
    out = _launch(r, k, v, w, u, state, route)
    build.count_launch(rwkv6_scan, *(("launches", "launches_chunked")
                                     if route == "chunked" else ("launches",)))
    return out


rwkv6_scan.launches = 0
rwkv6_scan.launches_chunked = 0

# abstract (``build.abstract_kernels``): the products FlopCounterMode counts
# in the plain scan, r_t (S + u k_t v_t^T) at every step: 2 B T H D^2
build.register_abstract(
    "rwkv6_scan",
    lambda t: [(t[0].shape, torch.float32), (t[5].shape, torch.float32)],
    lambda shapes: 2 * shapes[0][0] * shapes[0][1] * shapes[0][2] * shapes[0][3] ** 2)
