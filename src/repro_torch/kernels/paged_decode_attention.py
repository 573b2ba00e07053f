"""Paged decode attention: one query token per sequence against a paged KV
pool, through per-sequence block tables.

Replaces the Pallas TPU kernel ``_paged_kernel`` behind
``repro.kernels.paged_decode_attention.paged_decode_attention``, both its
variants: fp32/bf16 pools, and int8 pools dequantized in-kernel by
per-(slot, kv-head) fp32 scales (``k_scales``/``v_scales``).  The CUDA
kernel is ``src/repro_torch/csrc/paged_decode_attention.cu``, one template
for both, built for ``sm_90a`` at first use (``kernels/build.py``) and
called through ``ctypes``.

What bounds it on an H100: decode attention does about two flops per byte
of K/V it reads, so it is bound by device-memory bandwidth (3.35 TB/s),
which only a full card of blocks with loads in flight reaches.  The kernel
reads the pool in its native ``(N, page, KV, D)`` layout in place, by
strides (the Pallas wrapper transposed the whole pool on every call), and
walks only the table entries its softmax can weigh: those below
``ceil(min(len, P * page) / page)``, skipping -1 entries (their weight is
exactly 0 once the row has a live key).  Each (sequence, KV head)'s entries
are split over ``splits`` blocks of ``chunk`` entries (flash-decoding),
chosen here from static shapes only (``plan``): never from the tables or
lengths, so the wrapper never waits for the device.  The last block of each
(sequence, KV head) to finish merges the fp32 partials in the same launch.
Inside a block, tiles of whole pages (32 keys at page 16) stay in their
storage type in a ``cp.async`` ring (int8 codes with their scales, so an
int8 pool reads about half the bytes of a bf16 one), and the G query heads
of a KV head share every tile.  bf16 q with up to 16 query heads per KV
head runs on the tensor cores (``mma.sync``), with a bf16 pool or an int8
one: int8 codes are exact in bf16 (K's widened once a tile into shared
memory, V's in registers), and each key's scales fold into S (k) and P
(v).  fp32 q and larger groups run on the CUDA cores, one key per lane.  A row with no live key keeps the reference's uniform average over
all P entries; the splits spread it too.

The combine's counters and the partials' workspace are shared with the
dense kernel: one of each per device and stream (``split_scratch``), the
counters zero between launches.

head_dim is any multiple of 8 up to 256 (H2O-Danube-3's 120 among them):
the kernel runs its instance at the next of 32, 64, 128, 256 with the true
head_dim as an argument.  Pool rows need 16-byte alignment, except int8
rows whose head_dim is not a multiple of 16 (120 bytes): those move 8 bytes
at a time and need 8.

On a CPU tensor the wrapper runs the plain version (``ref.py``); on a CUDA
tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import (HEAD_DIM_INSTANCES, MAX_SPLITS,
                                                  MMA_ROWS, TILE, min_split_tiles,
                                                  sm_count, split_plan,
                                                  split_scratch, tensor_cores)
from repro_torch.kernels.ref import paged_decode_attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_POOL_INT8 = 2
_MAX_GROUP = 32          # 8 warps x 4 query heads per warp
_MAX_SMEM = 232_448      # bytes of shared memory a block may use on Hopper
_STAGES = 2              # tiles in a block's cp.async ring
_K_PAD = 16              # bytes after each K and V row in shared memory
_HEADS_PER_WARP = 4      # CUDA cores: query heads per warp
_MIN_WARPS = 4


def plan(pages_per_seq: int, page_size: int, rows: int, sms: int, group: int,
         q_dtype: torch.dtype, pool_dtype: torch.dtype, head_dim: int) -> tuple:
    """(splits, chunk entries, pages per tile, tensor cores) for block
    tables of ``pages_per_seq`` entries: tiles of whole pages, ``TILE`` keys
    where the page divides it (one page where it is larger); the tensor
    cores take bf16 q with a bf16 or an int8 pool in 32-key tiles; then the
    split of ``split_plan`` over the tiles.  On the tensor cores an int8
    tile is widened to bf16 and costs about what a bf16 tile does, so its
    split's least length is a bf16 split's (half the bytes; measured faster
    at G = 16, PERF.md)."""
    tp = max(1, TILE // page_size)
    dp = next(x for x in HEAD_DIM_INSTANCES if x >= head_dim)
    mma = (pool_dtype in (q_dtype, torch.int8) and tp * page_size == TILE
           and tensor_cores(q_dtype, dp, group))
    int8 = pool_dtype == torch.int8
    route = ("CUDA cores" if not mma else "tensor cores, int8" if int8 else "tensor cores")
    element = 2 if mma else pool_dtype.itemsize
    splits, per = split_plan(-(-pages_per_seq // tp), rows, sms,
                             min_split_tiles(group, element, tp * page_size), route)
    return splits, per * tp, tp, mma


def _smem_bytes(page_size, head_dim, element_size, quantized, group, splits=MAX_SPLITS):
    """Shared memory of one block, as the kernel lays it out (by default for
    the most splits): two ring stages, each a tile's K and V rows (padded),
    for int8 pools the k and v scales, and a live flag per key; q (fp32
    G x Dp, or bf16 16 x (Dp + 8), room for the larger); each warp's
    scores; with splits the combine's weights (G x (splits + 1)); and for an
    int8 pool that may take the tensor cores, the tile's K widened to bf16
    (TILE x (Dp + 8), 16-byte aligned)."""
    tk = max(1, TILE // page_size) * page_size
    dp = next(x for x in HEAD_DIM_INSTANCES if x >= head_dim)
    stage = 2 * tk * (dp * element_size + _K_PAD) + (8 * tk if quantized else 0) + tk
    nwarps = max(-(-group // _HEADS_PER_WARP), _MIN_WARPS)
    widened = (16 + 2 * tk * (dp + 8)
               if quantized and tk == TILE and tensor_cores(torch.bfloat16, dp, group) else 0)
    return (_STAGES * (-(-stage // 16) * 16) + max(4 * group * dp, 2 * MMA_ROWS * (dp + 8))
            + 4 * (nwarps * _HEADS_PER_WARP * tk + (group * (splits + 1) if splits > 1 else 0))
            + widened)


def _bind(lib: ctypes.CDLL):
    fn = lib.paged_decode_attention
    if fn.argtypes is None:
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i,
                       i, i, i, i, ll, ll, ll, ll, ll, ll, f, f, p]
        fn.restype = ctypes.c_int
    return fn


def _check_scales(k_pages, k_scales, v_scales):
    """int8 pools come with both scale tensors, (N, page, KV) fp32 on the
    pool's device; fp pools with neither."""
    if (k_scales is None) != (v_scales is None):
        raise ValueError("paged_decode_attention: give both k_scales and "
                         "v_scales, or neither")
    if k_scales is None:
        return
    if k_pages.dtype != torch.int8:
        raise TypeError("paged_decode_attention: scales go with int8 pools")
    for s in (k_scales, v_scales):
        if s.dtype != torch.float32 or s.shape != k_pages.shape[:3]:
            raise ValueError(f"paged_decode_attention: scales must be fp32 "
                             f"{tuple(k_pages.shape[:3])}, got {s.dtype} "
                             f"{tuple(s.shape)}")
        if s.device != k_pages.device:
            raise ValueError(f"paged_decode_attention: scales on {s.device}, "
                             f"pools on {k_pages.device}")
    if k_scales.stride() != v_scales.stride():
        raise ValueError("paged_decode_attention: k and v scales need equal "
                         "strides")


def _check(q, k_pages, v_pages, block_tables, lengths, k_scales=None,
           v_scales=None):
    b, h, d = q.shape
    n, page_size, kv, dk = k_pages.shape
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged_decode_attention: dtype {q.dtype} not supported "
                        "(float32, bfloat16)")
    _check_scales(k_pages, k_scales, v_scales)
    pool_dtype = torch.int8 if k_scales is not None else q.dtype
    if k_pages.dtype != pool_dtype or v_pages.dtype != pool_dtype:
        raise TypeError("paged_decode_attention: the pools must share q's "
                        "dtype, or be int8 with scales")
    if d % 8 or not 8 <= d <= 256 or dk != d or v_pages.shape != k_pages.shape:
        raise ValueError(f"paged_decode_attention: head_dim {d} with pools "
                         f"{tuple(k_pages.shape)} not supported (head_dim a "
                         "multiple of 8 up to 256, k and v pools of one shape)")
    if h % kv or h // kv > _MAX_GROUP:
        raise ValueError(f"paged_decode_attention: {h} heads over {kv} KV heads "
                         f"not supported (group <= {_MAX_GROUP})")
    if k_pages.stride() != v_pages.stride() or k_pages.stride(3) != 1:
        raise ValueError("paged_decode_attention: k and v pools need equal "
                         "strides and a contiguous head_dim")
    # bytes per vector load: int8 rows of 120 codes are 8-byte aligned only
    align = 8 if k_pages.dtype == torch.int8 and d % 16 else 16
    vec = align // k_pages.element_size()
    if (any(s % vec for s in k_pages.stride()[:3])
            or k_pages.data_ptr() % align or v_pages.data_ptr() % align):
        raise ValueError(f"paged_decode_attention: pool rows must be "
                         f"{align}-byte aligned")
    smem = _smem_bytes(page_size, d, k_pages.element_size(),
                       k_pages.dtype == torch.int8, h // kv)
    if smem > _MAX_SMEM:
        raise ValueError(f"paged_decode_attention: page_size {page_size} needs "
                         f"{smem} bytes of shared memory (max {_MAX_SMEM})")
    devices = {t.device for t in (q, k_pages, v_pages, block_tables, lengths)}
    if len(devices) != 1:
        raise ValueError(f"paged_decode_attention: tensors on {devices}")
    if block_tables.shape[0] != b or lengths.shape != (b,):
        raise ValueError("paged_decode_attention: block_tables (B, P) and "
                         "lengths (B,) must match q's batch")


def paged_decode_attention(q, k_pages, v_pages, block_tables, lengths, *,
                           k_scales=None, v_scales=None, softcap=None):
    """q: (B, H, D); k_pages/v_pages: (N, page_size, KV, D);
    block_tables: (B, P) int physical page ids (-1 = unassigned);
    lengths: (B,) int tokens written so far.  ``k_scales``/``v_scales``
    (both or neither): (N, page_size, KV) fp32 per-(slot, kv-head) scales
    of int8 pools, dequantized in-kernel.  Returns (B, H, D) in q's dtype."""
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pages, v_pages, block_tables,
                                          lengths, k_scales=k_scales,
                                          v_scales=v_scales, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: device {q.device} not supported")
    _check(q, k_pages, v_pages, block_tables, lengths, k_scales, v_scales)
    if softcap is not None and softcap <= 0:
        raise ValueError(f"paged_decode_attention: softcap {softcap} must be > 0")
    b, h, d = q.shape
    page_size, kv = k_pages.shape[1], k_pages.shape[2]
    p = block_tables.shape[1]
    q = q.contiguous()
    if q.data_ptr() % 16:        # the kernel reads q 16 bytes at a time
        q = q.clone()
    tables = block_tables.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    quantized = k_scales is not None
    # scales are per-layer views of the (L, N, page, KV) pool: passed by
    # strides, never copied
    scale_ptrs = ((k_scales.data_ptr(), v_scales.data_ptr()) if quantized
                  else (None, None))
    scale_strides = k_scales.stride() if quantized else (0, 0, 0)
    fn = _bind(build.library("paged_decode_attention"))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        splits, chunk, tp, mma = plan(p, page_size, b * kv, sm_count(q.device), h // kv,
                                      q.dtype, k_pages.dtype, d)
        ws = counters = None
        if splits > 1:
            dp = next(x for x in HEAD_DIM_INSTANCES if x >= d)
            counters, ws = split_scratch(q.device, stream, b * kv,
                                         b * kv * splits * (h // kv) * (dp + 2))
        rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                *scale_ptrs, tables.data_ptr(), lens.data_ptr(), out.data_ptr(),
                None if ws is None else ws.data_ptr(),
                None if counters is None else counters.data_ptr(),
                _DTYPES[q.dtype], _POOL_INT8 if quantized else _DTYPES[q.dtype],
                b, h, kv, d, p, page_size, splits, chunk, tp, int(mma),
                k_pages.stride(0), k_pages.stride(1), k_pages.stride(2),
                *scale_strides,
                d ** -0.5, 0.0 if softcap is None else float(softcap), stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention: CUDA launch failed "
                           f"(cudaError {rc})")
    build.count_launch(paged_decode_attention,
                       *(("launches", "launches_int8") if quantized else ("launches",)))
    return out


# launches of either variant, and of the int8-KV variant alone
paged_decode_attention.launches = 0
paged_decode_attention.launches_int8 = 0
