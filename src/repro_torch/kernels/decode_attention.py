"""Dense-cache decode attention: one query token per row against the slot
engine's statically shaped KV cache, whose slot index is the position.

Replaces the Pallas TPU kernel ``_decode_kernel`` behind
``repro.kernels.decode_attention.decode_attention``.  The CUDA kernel is
``src/repro_torch/csrc/decode_attention.cu``, built for ``sm_90a`` at first
use (``kernels/build.py``) and called through ``ctypes``.

What bounds it on an H100: about two flops per byte of K/V read, so the
bytes of live K/V at 3.35 TB/s, which only a full card of blocks with loads
in flight reaches.  The kernel reads the cache's ``(B, S, KV, D)`` layer
view in place by strides (the Pallas wrapper transposed it) and walks only
the live keys ``[max(0, len - window), min(len, S))`` of each row (lengths
above S count as S).  Each (row, KV head)'s key axis is split over
``splits`` blocks of ``chunk`` keys (flash-decoding), chosen here from
static shapes only (``plan``): never from ``lengths``, so the wrapper never
waits for the device.  A block past its row's live range exits on the
device; the last block of each (row, KV head) to finish merges the fp32
partials in the same launch, through a per-(row, KV head) counter that it
leaves at zero.  Inside a block, 32-key K/V tiles stay in their storage
type in a ``cp.async`` ring, each lane scores one key, and the G query
heads of a KV head share every tile.

The counters and the partials' workspace are per (device, stream),
allocated once and grown when needed (``split_scratch``): launches on one
stream run in order and share them, launches on different streams get
their own.

head_dim is any multiple of 8 up to 256 (H2O-Danube-3's 120 among them):
the kernel runs its instance at the next of 32, 64, 128, 256 with the true
head_dim as an argument.

On a CPU tensor the wrapper runs the plain version (``ref.py``); on a CUDA
tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import decode_attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GROUP = 32          # 8 warps x 4 query heads per warp
# the kernel's instances: head_dim (a multiple of 8 up to 256) runs the next
# one up
HEAD_DIM_INSTANCES = (32, 64, 128, 256)
TILE = 32                # keys per tile: one per lane
MMA_ROWS = 16            # tensor cores: query heads per tile (zero-padded)
MAX_SPLITS = 64          # the combine holds two splits per lane
# the grid the split aims at, in blocks per SM, by route: the tensor cores
# finish a tile quickly and do best with fewer, longer splits (fewer
# partials to merge); the CUDA cores need more blocks in flight; an int8
# pool on the tensor cores (the paged kernel), whose tiles take longer (K
# widened to bf16 first), in between (measured on an H100, PERF.md)
BLOCKS_PER_SM = {"tensor cores": 4, "tensor cores, int8": 6, "CUDA cores": 8}


def tensor_cores(dtype: torch.dtype, dp: int, group: int) -> bool:
    """Whether the kernels take the tensor-core route: bf16, a head_dim
    instance of 64 or more, and the G query heads within one 16-row tile."""
    return dtype == torch.bfloat16 and dp >= 64 and group <= MMA_ROWS


def split_plan(tiles: int, rows: int, sms: int, min_tiles: int, route: str) -> tuple:
    """(splits, tiles per split) for ``rows`` (row, KV head) pairs whose key
    axis is ``tiles`` tiles: about ``BLOCKS_PER_SM[route]`` blocks per SM
    over the whole grid, at least ``min_tiles`` tiles per split, at most
    ``MAX_SPLITS`` splits; no split is empty: (splits - 1) * per < tiles <=
    splits * per."""
    want = -(-BLOCKS_PER_SM[route] * sms // max(rows, 1))
    splits = max(1, min(want, tiles // max(min_tiles, 1), MAX_SPLITS))
    per = -(-tiles // splits)
    return -(-tiles // per), per


def min_split_tiles(group: int, element_size: int, keys: int) -> int:
    """Tiles of ``keys`` keys a split must hold so that its fp32 partial
    (G x D accumulators) is at most an eighth of the K/V bytes it reads:
    many query heads per KV head (RecurrentGemma's 16) make the partials,
    and the combine that reads them, as large as the work."""
    return max(1, -(-16 * group // (element_size * keys)))


def plan(seq_len: int, rows: int, sms: int, group: int, dtype: torch.dtype,
         head_dim: int) -> tuple:
    """(splits, chunk keys, tensor cores) for a dense cache of ``seq_len``
    slots: the grid's third axis, the keys each of its blocks may walk, and
    the route."""
    mma = tensor_cores(dtype, next(x for x in HEAD_DIM_INSTANCES if x >= head_dim), group)
    splits, per = split_plan(-(-seq_len // TILE), rows, sms,
                             min_split_tiles(group, dtype.itemsize, TILE),
                             "tensor cores" if mma else "CUDA cores")
    return splits, per * TILE, mma


_SMS: dict = {}
_SCRATCH: dict = {}
_SCRATCH_LOCK = threading.Lock()


def sm_count(device: torch.device) -> int:
    """The card's SM count, read once per device."""
    n = _SMS.get(device.index)
    if n is None:
        n = _SMS[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


def split_scratch(device: torch.device, stream: int, rows: int, floats: int) -> tuple:
    """(counters, workspace) for the split kernels on ``stream``: int32
    zeros, one per (row, KV head), which each launch leaves at zero, and
    ``floats`` fp32 for the partials.  Launches run in order on one stream,
    so they share both (the dense and the paged kernel too); another stream
    gets its own.  Allocated once, grown when a call needs more.  Threads
    launching on one stream (rollout replicas) share them too: a buffer one
    thread replaces stays referenced by the other until its launch is
    queued, and the stream runs that launch before any later use of the
    freed memory."""
    key = (device.index, stream)
    with _SCRATCH_LOCK:
        counters, ws = _SCRATCH.get(key, (None, None))
        if counters is None or counters.numel() < rows:
            counters = torch.zeros(rows, dtype=torch.int32, device=device)
        if ws is None or ws.numel() < floats:
            ws = torch.empty(floats, dtype=torch.float32, device=device)
        _SCRATCH[key] = (counters, ws)
    return counters, ws


def _bind(lib: ctypes.CDLL):
    fn = lib.decode_attention
    if fn.argtypes is None:
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i,
                       ll, ll, ll, i, f, p]
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
    if build.is_abstract(q):
        # abstract (``build.abstract_kernels``): products over the whole cache
        return build.abstract_call("decode_attention", q, k, v, lengths)[0]
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: device {q.device} not supported")
    _check(q, k, v, lengths, window)
    b, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    q = q.contiguous()
    if q.data_ptr() % 16:        # the kernel reads q 16 bytes at a time
        q = q.clone()
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    fn = _bind(build.library("decode_attention"))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        splits, chunk, mma = plan(s, b * kv, sm_count(q.device), h // kv, q.dtype, d)
        ws = counters = None
        if splits > 1:
            dp = next(x for x in HEAD_DIM_INSTANCES if x >= d)
            counters, ws = split_scratch(q.device, stream, b * kv,
                                         b * kv * splits * (h // kv) * (dp + 2))
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
                out.data_ptr(), None if ws is None else ws.data_ptr(),
                None if counters is None else counters.data_ptr(),
                _DTYPES[q.dtype], b, h, kv, d, s, splits, chunk, int(mma),
                k.stride(0), k.stride(1), k.stride(2),
                0 if window is None else int(window), d ** -0.5, stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention: CUDA launch failed (cudaError {rc})")
    build.count_launch(decode_attention, "launches")
    return out


decode_attention.launches = 0

# q K^T and P V of every query head over all S cache entries
build.register_abstract(
    "decode_attention",
    lambda t: [(t[0].shape, t[0].dtype)],
    lambda shapes: 4 * shapes[0][0] * shapes[0][1] * shapes[1][1] * shapes[0][2],
    reduced={1: 1, 2: 1}, parallel=({0: 1, 1: 2, 2: 2}, [1]))
