#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero and prints
no result):

1. ``env``: the card's name and power limit (``nvidia-smi``), torch and CUDA
   versions; TF32 is switched off for matmul and cuDNN.
2. ``build``: ``nvcc`` builds every kernel in ``src/repro_torch/csrc``.
3. ``kernels``: each kernel against its plain-torch version on the card, at
   the shapes the main paths give it, plus edge cases; times of the kernel,
   the plain version, the bound and one PyTorch library call.  The paged
   decode kernel: the serving shape, a softcap case and a small odd shape,
   for fp/bf16 pools and for int8 pools with scales (made by the port's
   ``quantize_kv``; a fully masked row and a length-0 row), and
   H2O-Danube-3's head_dim 120 for both pools.  Flash attention, forward
   (O, lse) and backward (dQ, dK, dV): the trainer's shape (B=8, H=16,
   KV=8, S=512, D=128) in bf16 and fp32, an odd one (S=300, G=4, D=64,
   window 128, softcap 30), G x D = 2,048 (H=32 over KV=2), PaliGemma's
   group (G=8, D=256) and head_dim 120 (window 128, softcap 30) in bf16
   and fp32; every bf16 flash kernel (one route, ``wgmma`` + TMA, causal or
   not) must show HGMMA and no HMMA in its SASS, every bf16 backward gives
   the same bits twice, and the build's registers and spills are printed.  Both kernels
   also at the shapes the pipeline phases give them (``_pipeline_shapes``:
   Qwen3-1.7B's replicas of 8 slots over 4 pages and its 16 x 64 train
   step; the command line's rl_100m with an int8 pool).
4. ``model``: full-width Qwen3-4B in fp32, the same requests through two
   engines sharing one set of weights, ``attn_impl="kernel"`` and ``"ref"``,
   with a full-precision and with an int8 KV pool: greedy tokens must
   match.  Then quantize-on-sync: an engine with ``quant_mode`` int8 / fp8
   must decode exactly the tokens of an unquantized engine given the
   weights quantized and dequantized up front.  ``model_danube``:
   full-width H2O-Danube-3-4B (head_dim 120) cut to 4 layers, fp32 kernel
   against ref through ``PagedDecodeEngine`` (both pools) and the slot
   ``DecodeEngine``, then one bf16 train step through the flash kernels
   (finite loss, one forward and one backward launch per layer).
5. ``serve``: the slice-1 main path — full-width Qwen3-4B in bf16 behind
   ``LLMProxy`` over ``PagedDecodeEngine`` (prefix cache on, 16 slots),
   serving a seeded mix of rollout tasks.  Every callback must fire, the
   page audit must be clean, and the decode kernel must have launched
   num_layers times per decode step.  Then a profiled decode window.
6. ``serve_quant``: the same tasks and settings with ``quant_mode="int8",
   kv_quant="int8"``, and a weight sync (suspend, update_weights with a new
   bf16 tree, resume) once half the callbacks have fired.  The int8 kernel
   must have launched num_layers times per decode step; the held weights'
   and the KV pool's bytes are measured against bf16; then a profiled
   decode window and the device time of one forward's dequantization.
7. Slice 4, the slot ``DecodeEngine`` (dense-cache decode and RWKV-6):
   ``kernels`` also holds the dense decode-attention kernel (Qwen3-4B's
   serve shape B=16, H=32, KV=8, D=128, S=1024 with ragged lengths 1, S
   and > S; an odd S=300, G=4, D=64, window 128 with a length-0 row; bf16
   and fp32; head_dim 120) and the WKV scan (RWKV-6 3B's prefill B=1,
   T=512, H=40, D=64 and decode B=16, T=1 shapes, an odd T=300, D=32; bf16
   r/k/v with fp32 w, and all fp32) to their plain versions; the scan must refuse inputs
   that need a gradient.  ``model_slot``: fp32 full-width Qwen3-4B and
   RWKV-6 3B, slot engines with ``attn_impl="kernel"`` against ``"ref"``
   (greedy tokens; for RWKV-6 also the per-layer and accumulated logit
   differences, and the plain path on the host CPU as the witness of what
   rounding alone accumulates to), and int8 quantize-on-sync against
   fake-quantized weights.  ``serve_slot`` /
   ``serve_rwkv``: bf16 full-depth Qwen3-4B / RWKV-6 3B behind
   ``LLMProxy`` over ``DecodeEngine`` (16 slots, ``max_total_len`` 1024),
   the ``serve`` task mix, exact launch counts (decode attention:
   layers x decode steps; WKV scan: layers x (prefills + decode steps)),
   then ``profile_slot``.  ``passk``: ``evaluate_passk`` through the slot
   engine on bf16 Qwen3-4B (16 prompts x 4 candidates).
8. Slice 5, RecurrentGemma-9B (the hybrid: RG-LRU + local attention)
   through the slot engine: ``kernels`` also holds the RG-LRU scan (the
   prefill B=1, T=512 and decode B=16, T=1 shapes at W=4096, an odd B=3,
   T=300, W=96 with a nonzero h0, a state carried across a split; fp32
   and bf16 a/b) and decode attention at the hybrid's shape (B=16, H=16,
   KV=1, D=256, S=1024, window 2048; an odd S=300, window 128 with a
   length-0 row) to their plain versions; the scan must refuse inputs that
   need a gradient.  ``model_hybrid``: fp32 full width and depth, the
   recurrence's gates redrawn so that its state carries; kernel against
   ref slot engines (greedy tokens, per-layer scan error against the host
   CPU's plain path over the first layers, logits within a fixed bound),
   and int8 quantize-on-sync in the reference's scale groups against
   fake-quantized weights.  ``serve_hybrid``: bf16 behind ``LLMProxy``
   over ``DecodeEngine``, the ``serve`` task mix, exact launch counts
   (decode attention: attention layers x decode steps; the scan: RG-LRU
   layers x (prefills + decode steps)), then ``profile_slot``.
   Slice 7 redesigns both decode kernels (keys split over blocks with an
   in-launch combine, tensor cores for bf16): ``kernels`` also holds their
   edge cases at the four slice shapes (dense Qwen3-4B and
   RecurrentGemma-9B, paged bf16 and int8 pools) -- lengths on and around
   the chunk boundaries, one row per split count, empty splits, rows with
   no valid key, windows across a chunk boundary and past S, -1 entries in
   and after the live range, a softcap -- with each shape's split plan
   printed, one launch per wrapper call, and both wrappers run under
   ``torch.cuda.set_sync_debug_mode("error")``.
   Slice 8 gives both scans a chunked route for prefill (T cut into chunks
   spread over the card; the wrappers plan the route from static shapes):
   ``kernels`` also holds each scan's routes, forced, against its plain
   version (T in {2, L - 1, L, L + 1, 300, 512, 2048}, B in {1, 3, 16},
   head_dim 32 / 64 / 128, strong decays down to 1e-4, a state carried
   across two calls, strided views, bf16 and fp32 inputs), the prefill
   shape's times by route and chunk length, and both wrappers under
   ``set_sync_debug_mode("error")``.  ``model_slot`` (RWKV-6 3B, all 32
   layers) and ``model_hybrid`` (all 26 RG-LRU layers) add a float64
   witness: each layer's captured scan inputs recomputed in float64 on the
   card, every route of the kernel held to ``WITNESS_FACTOR`` times the
   plain fp32 path's distance from it.  ``serve_rwkv`` / ``serve_hybrid``
   count the chunked launches too (one per layer and prefill).
9. ``train_model``: fp32 Qwen3-1.7B at full width, 4 layers: one train step
   with ``attn_impl="kernel"`` against ``"ref"`` (loss, grad norm, params).
10. ``train``: the slice-3 main path — full-width, full-depth Qwen3-1.7B in
   bf16: 3 rounds of engine rollouts (4 prompts x groups of 4, behind
   ``LLMProxy``), ``HostTrainer.train_on_samples`` on them, and a weight
   sync back to the engine, whose next rollouts carry the new version and
   whose logits must follow the trainer's.  Exact flash and paged-decode
   launch counts.  Then ``profile_train``: one ``train_on_samples`` under
   ``torch.profiler``.
11. Slice 9, the asynchronous pipeline through its entry points:
   ``pipeline_rlvr`` (``build_rlvr_pipeline(...).run``, full-width,
   full-depth Qwen3-1.7B in bf16, two replicas of 8 slots behind the
   ``ProxyRouter``, 16 samples a step; alpha = 1 with overlapped weight
   sync, then alpha = 0, 3 steps each; exact paged-decode and flash
   launches, staleness <= alpha, the engines hold the trainer's final
   tree, clean page audits; then a traced run of each mode: device idle
   share and the threads' CPU seconds), ``pipeline_agentic``
   (``build_agentic_pipeline`` with ``GridTargetEnv``) and ``train_cli``
   (``python -m repro_torch.launch.train`` on rl_100m with int8 weights
   and int8 KV pages, two replicas).
12. Slice 10, the MoE family at full width, cut in depth (the reference's
   capacity-factor dispatch, ``moe_mode="ep"``, in serving; every expert
   on every token, ``"dense"``, in training): ``kernels`` holds the paged
   kernel (bf16 and int8 pools) and dense decode attention at
   Qwen3-MoE-235B-A22B's 64 heads over 4 KV heads and DBRX-132B's 48 over
   8, and flash forward and backward at ``train_moe``'s step, all timed
   into the rows' ``moe_shapes`` fields.  ``model_moe``: fp32, 2 layers,
   kernel against plain path through two paged engines (both configs;
   Qwen3-MoE with an fp32 and an int8 KV pool) and two slot engines
   (Qwen3-MoE), greedy tokens and exact launches.
   ``serve_moe``: Qwen3-MoE bf16, 8 of 94 layers, the ``serve`` task mix
   over ``PagedDecodeEngine`` (exact launches, page audit, weight, KV and
   peak bytes), then ``profile_moe``.  ``train_moe``: one
   ``train_on_samples`` of Qwen3-MoE bf16, 1 layer, 16 x 64 tokens (loss,
   grad norm, router losses, peak memory, exact flash launches).

13. Slice 11, the critic (PPO with GAE), checkpoints and the example twins:
   ``train_critic`` (``HostTrainer(adv_estimator="gae")`` on full-width,
   full-depth Qwen3-1.7B in bf16, as ``train`` runs GRPO: 3 rounds of
   engine rollouts, ``train_on_samples``, a weight sync; exact paged and
   flash launches; then 8 critic steps on one fixed batch, whose value
   loss must fall), ``checkpoint`` (the rl_100m critic trainer state
   through ``save_checkpoint`` / ``load_tree`` into a fresh trainer,
   bit-identical, and the same next step; ``train_critic``'s 4 GB of bf16
   params through ``save_tree`` / ``load_tree``, bit-identical),
   ``pipeline_critic`` (``build_rlvr_pipeline`` with
   ``adv_estimator="gae"``, alpha = 1, 2 steps, as ``pipeline_rlvr``) and
   ``examples`` (``examples/torch/*.py`` in subprocesses on the card, each
   exit 0).
14. Slice 12, PaliGemma-3B (``vlm``) and Seamless-M4T-medium (``audio``,
   the enc-dec) at full width and depth: ``kernels`` holds flash forward
   and backward with ``causal=False`` at Seamless' encoder shape (B=16,
   H=KV=16, S=1024, D=64) and an odd S=300, G=4, D=64, bf16 and fp32,
   causal flash at both families' train steps, and decode attention at
   both serve shapes with a length-0 and a full row, bf16 and fp32
   (every shape the phases below give either kernel; times into the rows'
   ``vlm_audio_shapes``).  ``model_vlm``: fp32, two slot engines kernel
   against ref (greedy tokens), then a prefill with 256 seeded patches
   and 16 decode steps at ``t + 256`` (logits).  ``serve_vlm``: bf16 over
   ``LLMProxy`` and ``DecodeEngine``, the ``serve`` mix, 18 decode
   launches per step, then ``profile_vlm``.  ``train_vlm``: one step on
   seeded patches, then 2 rounds of ``train_on_samples`` (8 x 256 text
   tokens behind the reference's zero patches), exact flash launches.
   ``pipeline_vlm``: ``build_rlvr_pipeline`` at alpha = 1, 2 steps, on the
   slot engine.  ``model_audio``: fp32 ``apply`` kernel against ref (24
   flash launches, 12 of them non-causal), then greedy decoding each way.
   ``decode_audio``: bf16, 16 rows of 1024 frames through ``api.prefill``
   and 64 ``api.decode_step``s (12 decode launches a step), then
   ``profile_audio``.  ``train_audio``: 2 rounds of ``train_on_samples``
   on 16 x 256 tokens with the reference's zero frames (24 flash launches
   a pass each way).  The rows carry these paths' counts as
   ``vlm_audio_launches``.
15. Slice 13, the sharding plan and the concurrency analysis: ``dryrun``
   (``python -m repro_torch.launch.dryrun --all --mesh both`` and
   ``--pools``, two subprocesses side by side; 0 failed; the largest per-device bytes by
   shape; then Qwen3-4B's 1x1 plan for a decode step at the serve shape,
   B=16, S=1,024, bf16, held against the card: the materialised params
   and cache must request exactly the plan's ``argument_bytes`` of the
   caching allocator, and be allocated that within its rounding (512 B a
   tensor, 1 MiB more a tensor over 1 MiB), and one ``decode_step``'s
   ``max_memory_allocated`` is printed against the plan's ``peak_bytes``)
   and ``sanitize`` (``build_rlvr_pipeline`` under the port's lock
   sanitizer, Qwen3-1.7B cut to 4 layers, 2 replicas of 8 slots, alpha =
   1, 2 steps: tracked locks, edges, inversions — none allowed —, holds
   over 50 ms, and the runtime edges the static checker's graph lacks).
16. Slice 15, flash's fp32 route as 3xTF32 on the tensor cores, one query
   head per block (any group size): ``kernels`` also holds fp32 flash at
   the groups the first fp32 route refused (``FP32_GROUPS``: PaliGemma-3B
   8 x 256, RecurrentGemma-9B 16 x 256 with its window of 2,048,
   Qwen3-MoE-235B-A22B 16 x 128, DBRX-132B 6 x 128), runs every fp32
   backward (and every non-causal one) twice for the same bits, requires
   TF32 HMMA in each fp32 kernel's SASS, and times the fp32 cases
   (``FP32_TIMED``, into the flash rows' ``fp32_shapes``) beside SDPA's
   fp32 call and the 3xTF32 bound (495 / 3 TFLOP/s; the CUDA cores' 67
   beside it).  ``model_fp32_flash``: fp32 ``api.apply`` kernel against
   ref for those four archs at full width, cut to the fewest layers with
   an attention layer, logits within rtol 2e-5 and atol 2e-5 x max
   |logit|, one flash forward per attention layer; ``model_hybrid``'s
   full-depth forwards count one flash launch per attention layer.
17. Slice 18, the int8 pool's paged decode on the tensor cores (bf16 q,
   G <= 16, head_dim 64 and up): ``kernels`` and ``split_kernels`` also
   hold the serving shape with a softcap for bf16 q, both int8 routes run
   under the sync debug mode, and every int8 tensor-core instance must
   show HMMA in its SASS (the int8 row's ``hmma``).  The paged rows' bounds
   read the operations at the route's peak: bf16 tensor cores (989
   TFLOP/s) for bf16 q, the CUDA cores' 67 otherwise and in
   ``bound_detail``.

Every phase's wall seconds are printed on a line of their own as it ends
(``{"phase": "wall", ...}``), and their total after the last.  Then the
card's name and power limit again, one line with every kernel's
numbers, and last ``{"ok": true, "device": {...}}``.  Weights are random, drawn from a seed
on the card.  Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import threading
import time
import traceback

ARCH = "qwen3-4b"
RWKV_ARCH = "rwkv6-3b"
HYBRID_ARCH = "recurrentgemma-9b"
SEED = 0
# H100 SXM published peaks (NVIDIA data sheet), used for the bound.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12          # fp32 outside the tensor cores
BF16_FLOPS = 989e12         # bf16 dense on the tensor cores
TF32_FLOPS = 495e12         # TF32 dense on the tensor cores
# fp32-exact products as three TF32 MMAs each (the fp32 flash route's
# "3xTF32"): the least time of its operations
FP32_3XTF32_FLOPS = TF32_FLOPS / 3
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),    # reduction order only
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}   # bf16 inputs and output
# fp32 full-width greedy tokens, kernel path against plain path: a
# divergence is tolerated only where the plain forward's top two logits lie
# closer than this (the dense family, both engines)
DENSE_TOP2_TOL = 1e-4
# RWKV-6 3B, fp32, random weights from SEED: the bound on the accumulated
# kernel-vs-plain logit difference, and the top-2 gap below which a greedy
# divergence is tolerated.  32 random-weight layers amplify rounding
# thousands of times: the plain path alone, on the host CPU against the
# card, differs by up to 0.373 over every position of model_slot's prompts
# (its printed witness).  Two rounding-size perturbations land within 7x
# of each other there (PERF.md, PR 14), so the bound is 4x that witness;
# the per-layer checks are what isolate the kernel.
RWKV_LOGIT_BOUND = 1.5
# RecurrentGemma-9B, fp32, random weights from SEED with the recurrence's
# gates perturbed (``_perturb_hybrid``): the same two bounds, fixed in
# advance (an H100 reads 2.0e-5 for the logits).  The host CPU witness
# runs its first two pattern groups (a cut of depth: six of 38 layers).
HYBRID_LOGIT_BOUND = 1e-3
HYBRID_WITNESS_LAYERS = 6
# the float64 witness of every recurrent layer (RWKV-6 3B's 32, RecurrentGemma-
# 9B's 26 RG-LRU layers): each route of the scan kernel may stray from the
# float64 recurrence at most this many times as far as the plain fp32 path
WITNESS_FACTOR = 2.0

# the serving configuration the main path runs
SERVE = dict(num_slots=16, max_total_len=1024, page_size=16, prefill_chunk=128)
# the slot engine's serving configuration (slice 4)
SERVE_SLOT = dict(num_slots=16, max_total_len=1024, prefill_bucket=16)
MAX_NEW = 64
DEVICE = "cuda"
# head_dim 120 through every attention kernel (full width, cut to 4 layers)
DANUBE_ARCH = "h2o-danube-3-4b"
DANUBE_LAYERS = 4
# the trainer the slice-3 main path runs (Qwen3-1.7B at full width and depth)
TRAIN_ARCH = "qwen3-1.7b"
TRAIN = dict(slots=16, max_seq_len=512, prompts=4, group=4, max_new=64, rounds=3)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def _torch():
    import torch
    return torch


# ---------------------------------------------------------------------------
# env / build
# ---------------------------------------------------------------------------

def phase_env() -> str:
    torch = _torch()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    emit("env", gpu=smi.splitlines()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         allow_tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         allow_tf32_cudnn=torch.backends.cudnn.allow_tf32)
    return smi.splitlines()[0]


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    built = build.build_all()
    emit("build", seconds=time.perf_counter() - t0 if built else "cached",
         built=sorted(built))


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

# the mangled name of the paged kernel's int8-pool tensor-core instances
# (paged_decode_kernel<bf16, int8_t, true, D, VB, true>)
PAGED_INT8_MMA = r"paged_decode_kernelI13__nv_bfloat16aLb1ELi(\d+)ELi(\d+)ELb1E"


def _paged_inputs(gen, b, h, kv, d, page_size, p, dtype, int8=False):
    """Pool, ragged block tables (-1 tails) and lengths; row 0 fully masked.
    ``int8``: the pools are int8 codes made by the port's ``quantize_kv``
    from the same draws, with their scales, and row 1 has length 0.
    Returns (q, k_pages, v_pages, tables, lengths, scales dict)."""
    torch = _torch()
    from repro_torch.models.paged import quantize_kv
    n = 1 + b * p
    q = torch.randn(b, h, d, generator=gen, device=DEVICE).to(dtype)
    kp = torch.randn(n, page_size, kv, d, generator=gen, device=DEVICE).to(dtype)
    vp = torch.randn(n, page_size, kv, d, generator=gen, device=DEVICE).to(dtype)
    perm = torch.randperm(n - 1, generator=gen, device=DEVICE).to(torch.int32) + 1
    tables = perm[:b * p].view(b, p).clone()
    lengths = torch.randint(1, p * page_size + 1, (b,), generator=gen,
                            device=DEVICE, dtype=torch.int32)
    for i, length in enumerate(lengths.tolist()):
        tables[i, -(-length // page_size):] = -1
    tables[0] = -1
    scales = {}
    if int8:
        (kp, ks), (vp, vs) = quantize_kv(kp), quantize_kv(vp)
        scales = {"k_scales": ks, "v_scales": vs}
        lengths[1] = 0
    return q, kp, vp, tables, lengths, scales


def _paged_bound(q, kp, tables, lengths, quantized=False, tensor_cores=False):
    """(bound_ms, bound_by, detail) from what these inputs need: each K/V
    tile the softmax can weigh is read once (a fully masked row averages V
    over its clamped entries), with its fp32 scales for an int8 pool, q read
    and the output written once; the operations at the route's peak: bf16
    tensor cores (989 TFLOP/s) where the plan takes them (bf16 q, either
    pool: int8 codes are exact in bf16), else the CUDA cores' 67, whose
    bound the detail keeps beside."""
    b, h, d = q.shape
    page_size, kv = kp.shape[1], kp.shape[2]
    tile = page_size * kv * d * kp.element_size() + (4 * page_size * kv if quantized else 0)
    k_pages, v_pages = set(), set()
    positions = 0
    for row, length in zip(tables.tolist(), lengths.tolist()):
        live = [e for j, e in enumerate(row) if e >= 0 and j * page_size < length]
        if live:
            k_pages.update(live)
            v_pages.update(live)
            positions += min(length, sum(1 for e in row if e >= 0) * page_size)
        else:
            v_pages.update(max(e, 0) for e in row)
            positions += len(row) * page_size
    nbytes = ((len(k_pages) + len(v_pages)) * tile
              + 2 * q.numel() * q.element_size()
              + tables.numel() * 4 + lengths.numel() * 4)
    flops = 4 * h * d * positions
    peak = BF16_FLOPS if tensor_cores else FP32_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    detail = {"flops": flops, "bytes": nbytes, "ops_ms": 1e3 * t_ops,
              "bytes_ms": 1e3 * t_bytes, "peak_flops": peak,
              "bound_ms_cuda_cores": 1e3 * max(t_bytes, flops / FP32_FLOPS)}
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", detail


_SLEEP_CYCLES_PER_MS = []


def _device_sleep(ms: float) -> None:
    """Hold the device in a sleep kernel for about ``ms`` (the cycle rate
    calibrated once with CUDA events)."""
    torch = _torch()
    if not _SLEEP_CYCLES_PER_MS:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(10 ** 7)
        end.record()
        torch.cuda.synchronize()
        _SLEEP_CYCLES_PER_MS.append(10 ** 7 / start.elapsed_time(end))
    torch.cuda._sleep(int(ms * _SLEEP_CYCLES_PER_MS[0]))


def _time_ms(fn, iters=30) -> float:
    """Mean device time of ``fn`` by CUDA events, L2 flushed before each
    launch (a decode step finds the pool cold).  Before each timed call the
    device sleeps for twice the host's enqueue time of one call, so the
    events time the device's work and not the host's Python: a kernel
    shorter than its wrapper's host overhead would otherwise read as that
    overhead."""
    torch = _torch()
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=DEVICE)
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        _device_sleep(2 * host_ms + 0.05)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def _wall_ms(fn, iters=3) -> float:
    """Mean synchronised wall-clock ms of ``fn``: for a plain version whose
    host loop outlasts its device work, so that no device time isolates."""
    torch = _torch()
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / iters


def _kernel_row(name, main, page_size, variant):
    """Time the kernel, its plain version and SDPA (on a bf16 dense view
    gathered, and dequantized for an int8 pool, beforehand: preparation not
    timed) at the slice shape; the bound from these inputs."""
    torch = _torch()
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels.paged_decode_attention import paged_decode_attention
    from repro_torch.kernels.ref import paged_decode_attention_ref

    q, kp, vp, tables, lengths, scales, err = main
    b, h, d = q.shape
    kv = kp.shape[2]
    s = tables.shape[1] * page_size
    kernel_ms = _time_ms(lambda: paged_decode_attention(q, kp, vp, tables, lengths,
                                                        **scales))
    plain_ms = _time_ms(lambda: paged_decode_attention_ref(q, kp, vp, tables, lengths,
                                                           **scales))
    # yardstick only (the port never calls it)
    idx = tables.long().clamp(min=0)
    kd, vd = kp[idx].reshape(b, s, kv, d), vp[idx].reshape(b, s, kv, d)
    if scales:
        kd = kd.float() * scales["k_scales"][idx].reshape(b, s, kv)[..., None]
        vd = vd.float() * scales["v_scales"][idx].reshape(b, s, kv)[..., None]
    kd = kd.to(q.dtype).transpose(1, 2).contiguous()
    vd = vd.to(q.dtype).transpose(1, 2).contiguous()
    pos = torch.arange(s, device=DEVICE)[None, :]
    mask = ((pos < lengths[:, None])
            & torch.repeat_interleave(tables >= 0, page_size, dim=1))[:, None, None, :]
    qd = q[:, :, None, :]
    library_ms = _time_ms(lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask, enable_gqa=True))
    pool = "int8 pool + fp32 scales" if scales else "bf16 pool"
    splits, chunk, tp, mma = pda.plan(tables.shape[1], page_size, b * kv,
                                      da.sm_count(q.device), h // kv, q.dtype, kp.dtype, d)
    bound_ms, bound_by, detail = _paged_bound(q, kp, tables, lengths, quantized=bool(scales),
                                              tensor_cores=mma)
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/paged_decode_attention.cu",
            "replaces": "src/repro/kernels/paged_decode_attention.py:146",
            "variant": variant,
            "launches": None, "max_abs_err": err, "ms": kernel_ms,
            "kernel_ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bound_detail": detail, "library_ms": library_ms,
            "library_call": "F.scaled_dot_product_attention(enable_gqa=True) on a bf16 "
                            "dense view gathered (and dequantized) beforehand, not timed",
            "shape": f"B={b} H={h} KV={kv} D={d} page={page_size} "
                     f"P={tables.shape[1]} bf16 q, {pool}",
            "split": {"splits": splits, "chunk_entries": chunk, "pages_per_tile": tp,
                      "route": "tensor cores" if mma else "CUDA cores"},
            "registers": _ptxas_registers("paged_decode_attention")}


def phase_kernels() -> list:
    torch = _torch()
    from repro_torch.kernels.paged_decode_attention import paged_decode_attention
    from repro_torch.kernels.ref import paged_decode_attention_ref

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    h, kv, d = 32, 8, 128                                  # Qwen3-4B
    page_size = SERVE["page_size"]
    p = SERVE["max_total_len"] // page_size
    bf16, fp32 = torch.bfloat16, torch.float32
    b = SERVE["num_slots"]
    cases = [  # (label, b, h, kv, d, page, P, q dtype, softcap, int8 pool)
        ("slice_bf16", b, h, kv, d, page_size, p, bf16, None, False),
        ("slice_fp32", b, h, kv, d, page_size, p, fp32, None, False),
        ("softcap_fp32", b, h, kv, d, page_size, p, fp32, 30.0, False),
        ("odd_bf16", 3, 12, 3, 64, 8, 5, bf16, None, False),
        ("odd_fp32", 3, 12, 3, 64, 8, 5, fp32, None, False),
        ("slice_int8_bf16q", b, h, kv, d, page_size, p, bf16, None, True),
        ("slice_int8_fp32q", b, h, kv, d, page_size, p, fp32, None, True),
        ("softcap_int8_fp32q", b, h, kv, d, page_size, p, fp32, 30.0, True),
        ("softcap_int8_bf16q", b, h, kv, d, page_size, p, bf16, 30.0, True),
        ("odd_int8_bf16q", 3, 12, 3, 64, 8, 5, bf16, None, True),
        # H2O-Danube-3's head_dim 120 (32 heads, 8 KV heads): the D=128
        # instance with the last lanes' tail idle; int8 rows 8-byte aligned
        ("d120_bf16", 4, 32, 8, 120, page_size, 8, bf16, None, False),
        ("d120_int8_bf16q", 4, 32, 8, 120, page_size, 8, bf16, None, True),
    ]
    # the pipeline phases' shapes (Qwen3-1.7B: G=2, B=8, P=4; the command
    # line's rl_100m: G=3, D=64, int8 pool, P=2)
    for phase, shape in _pipeline_shapes().items():
        bb, hh, kvv, dd, ps, pp, dtype, int8 = shape["paged"]
        cases.append((f"{phase}_{'int8' if int8 else dtype}", bb, hh, kvv, dd, ps, pp,
                      getattr(torch, dtype), None, int8))
    main = {}
    for label, bb, hh, kvv, dd, ps, pp, dtype, softcap, int8 in cases:
        q, kp, vp, tables, lengths, scales = _paged_inputs(gen, bb, hh, kvv, dd, ps, pp,
                                                           dtype, int8=int8)
        out = paged_decode_attention(q, kp, vp, tables, lengths, softcap=softcap, **scales)
        torch.cuda.synchronize()
        ref = paged_decode_attention_ref(q, kp, vp, tables, lengths, softcap=softcap,
                                         **scales)
        tol = TOL[str(dtype).split(".")[-1]]
        err = (out.float() - ref.float()).abs().max().item()
        ok = torch.allclose(out.float(), ref.float(), **tol)
        emit("kernels", case=label, shape=[bb, hh, kvv, dd, ps, pp], dtype=str(dtype),
             pool="int8" if int8 else str(dtype), softcap=softcap, max_abs_err=err,
             tol=tol, ok=ok)
        if not ok:
            raise AssertionError(f"paged_decode_attention {label}: max abs err {err}")
        if label in ("slice_bf16", "slice_int8_bf16q"):
            main[label] = (q, kp, vp, tables, lengths, scales, err)

    rows = [_kernel_row("paged_decode_attention", main.pop("slice_bf16"), page_size,
                        "fp32/bf16 pool"),
            _kernel_row("paged_decode_attention_int8", main.pop("slice_int8_bf16q"),
                        page_size, "int8 pool, k_scales/v_scales (:31-36, :51-53, "
                                   ":123-129); bf16 q on the tensor cores (codes "
                                   "exact in bf16, scales folded into S and P), fp32 "
                                   "q on the CUDA cores")]
    # the int8 pool's tensor-core instances (bf16 q, head_dim 64 / 128 / 256,
    # 16- and 8-byte copies) compute with mma.sync: HMMA in each one's SASS
    hmma = {f"D{m.group(1)}_copy{m.group(2)}": n["hmma"]
            for fn, n in _sass_hmma("paged_decode_attention").items()
            for m in [re.search(PAGED_INT8_MMA, fn)] if m}
    emit("kernels", kernel="paged_decode_attention_int8", case="sass", hmma=hmma)
    if len(hmma) != 6 or not all(hmma.values()):
        raise AssertionError(f"paged_decode_attention: int8 tensor-core instances "
                             f"without HMMA: {hmma}")
    rows[1]["hmma"] = hmma
    for row in rows:
        emit("kernels", **{k: v for k, v in row.items() if k != "launches"})
    return rows


# ---------------------------------------------------------------------------
# kernels: flash attention forward and backward
# ---------------------------------------------------------------------------

def _flash_inputs(gen, b, h, kv, s, d, dtype):
    """q, k, v and an output gradient as the trainer has them: (B, S, heads,
    D) projections seen as (B, heads, S, D) strided views."""
    torch = _torch()
    return tuple(torch.randn(b, s, n, d, generator=gen, device=DEVICE).to(dtype)
                 .transpose(1, 2) for n in (h, kv, kv, h))


def _flash_pairs(s, window, causal=True):
    """(query, key) pairs the causal (windowed) mask lets through, per head;
    without ``causal`` (and without a window) all of them."""
    if not causal:
        if window is not None:
            raise ValueError("_flash_pairs: a window without causality is not counted")
        return s * s
    if window is None:
        return s * (s + 1) // 2
    return sum(min(i + 1, window) for i in range(s))


def _flash_bound(q, k, window, backward, causal=True):
    """(bound_ms, bound_by, detail): the larger of the operations these
    inputs need (visible pairs only; 4D flops per pair forward: QK^T and PV;
    10D backward: QK^T again, dP, dV, dK, dQ) at the dtype's peak, and the
    bytes (forward: q, k, v read, o and lse written; backward: q, k, v, o,
    dO, lse read, dq, dk, dv written) at 3.35 TB/s.  fp32's peak is that of
    fp32-exact products as three TF32 MMAs (495 / 3 TFLOP/s, the route's
    design); the detail keeps the CUDA cores' 67 beside it."""
    torch = _torch()
    b, h, s, d = q.shape
    e = q.element_size()
    flops = (10 if backward else 4) * d * b * h * _flash_pairs(s, window, causal)
    qo, kv = q.numel() * e, k.numel() * e
    lse = 4 * b * h * s
    nbytes = (3 * qo + 4 * kv + lse) if backward else (2 * qo + 2 * kv + lse)
    peak = BF16_FLOPS if q.dtype == torch.bfloat16 else FP32_3XTF32_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    detail = {"flops": flops, "bytes": nbytes, "ops_ms": 1e3 * t_ops,
              "bytes_ms": 1e3 * t_bytes, "peak_flops": peak}
    if q.dtype == torch.float32:
        detail["bound_ms_cuda_cores"] = 1e3 * max(flops / FP32_FLOPS, t_bytes)
    return (1e3 * max(t_ops, t_bytes), "bytes" if t_bytes >= t_ops else "operations", detail)


def _flash_case(gen, label, b, h, kv, s, d, dtype, window, softcap, causal=True):
    """Forward O and lse, then dQ/dK/dV, against the plain versions.
    Gradients are held to the tolerance times their largest magnitude."""
    torch = _torch()
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_bwd_ref, flash_attention_ref

    q, k, v, do = _flash_inputs(gen, b, h, kv, s, d, dtype)
    opts = dict(causal=causal, window=window, softcap=softcap)
    o, lse = fa.flash_attention_fwd(q, k, v, **opts)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do, **opts)
    torch.cuda.synchronize()
    want_o, want_lse = flash_attention_ref(q, k, v, return_lse=True, **opts)
    want = flash_attention_bwd_ref(q, k, v, o, lse, do, **opts)
    tol = TOL[str(dtype).split(".")[-1]]
    errs = {"o": (o.float() - want_o.float()).abs().max().item(),
            "lse": (lse - want_lse).abs().max().item()}
    ok = (torch.allclose(o.float(), want_o.float(), **tol)
          and torch.allclose(lse, want_lse, **tol))
    for name, got, w in zip(("dq", "dk", "dv"), grads, want):
        scale = w.float().abs().max().item()
        errs[name] = (got.float() - w.float()).abs().max().item()
        errs[name + "_scaled"] = errs[name] / scale
        ok = ok and torch.allclose(got.float(), w.float(), rtol=tol["rtol"],
                                   atol=tol["atol"] * scale)
        ok = ok and bool(torch.isfinite(got).all())
    emit("kernels", case=label, kernel="flash_attention", shape=[b, h, kv, s, d],
         dtype=str(dtype), causal=causal, window=window, softcap=softcap, max_abs_err=errs,
         tol=tol, grad_tol="atol x max |grad|", ok=ok)
    if not ok:
        raise AssertionError(f"flash_attention {label}: errors {errs}")
    return (q, k, v, do, o, lse, grads, errs)


def _sass_hmma(name: str) -> dict:
    """{kernel function: {"hmma": n, "hgmma": m, "hmma_tf32": t}}: the counts
    of tensor-core MMA instructions in the SASS of ``csrc/<name>.cu``'s
    built library (``cuobjdump -sass``), ``mma.sync`` (HMMA, t of them on
    TF32 operands) and Hopper's ``wgmma`` (HGMMA) apart."""
    import re
    import shutil
    from repro_torch.kernels import build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(build._target(build.sources()[name]))],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    out, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = {"hmma": 0, "hgmma": 0, "hmma_tf32": 0}
        elif fn and "HGMMA" in line:
            out[fn]["hgmma"] += 1
        elif fn and "HMMA" in line:
            out[fn]["hmma"] += 1
            out[fn]["hmma_tf32"] += "TF32" in line
    return out


def _flash_shape(q, k, causal=True) -> str:
    b, h, s, d = q.shape
    return (f"B={b} H={h} KV={k.shape[1]} S={s} D={d} {'causal' if causal else 'non-causal'} "
            f"{str(q.dtype).split('.')[-1]}, (B, S, heads, D) strided views")


def _flash_times(case, backward: bool, causal=True, window=None, softcap=None) -> tuple:
    """(kernel ms, plain ms, library ms, max abs err, bound ms, bound by,
    bound detail) of the forward or the backward on ``_flash_case``'s
    inputs (made with the same ``causal``, ``window`` and ``softcap``).
    The library yardstick (the port never calls it): SDPA forward, or its
    backward alone (the graph of one forward, replayed); null where SDPA
    does not compute the same function (a softcap, a window shorter than
    S)."""
    torch = _torch()
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_bwd_ref, flash_attention_ref

    q, k, v, do, o, lse, _, errs = case
    opts = dict(causal=causal, window=window, softcap=softcap)
    same = softcap is None and (window is None or window >= q.shape[2])
    if backward:
        ms = _time_ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, **opts))
        plain = _time_ms(lambda: flash_attention_bwd_ref(q, k, v, o, lse, do, **opts))
        lib = None
        if same:
            ql, kl, vl = (t.detach().requires_grad_(True) for t in (q, k, v))
            out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal,
                                                 enable_gqa=True)
            lib = _time_ms(lambda: torch.autograd.grad(out, (ql, kl, vl), do,
                                                       retain_graph=True))
            del out, ql, kl, vl
        err = max(errs["dq"], errs["dk"], errs["dv"])
    else:
        ms = _time_ms(lambda: fa.flash_attention_fwd(q, k, v, **opts))
        plain = _time_ms(lambda: flash_attention_ref(q, k, v, return_lse=True, **opts))
        lib = _time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True)) if same else None
        err = errs["o"]
    return (ms, plain, lib, err) + _flash_bound(q, k, window, backward, causal)


# fp32 flash at the groups the first fp32 route refused (G x D > 512):
# label -> (B, H, KV, S, D, window); causal, as these archs' train steps
FP32_GROUPS = {
    "paligemma_fp32": (8, 8, 1, 512, 256, None),            # PaliGemma-3B, 8 x 256 (train_vlm)
    "recurrentgemma_fp32": (1, 16, 1, 2048, 256, 2048),     # RecurrentGemma-9B, 16 x 256
    "qwen3moe_fp32": (1, 64, 4, 512, 128, None),            # Qwen3-MoE-235B-A22B, 16 x 128
    "dbrx_fp32": (1, 48, 8, 512, 128, None),                # DBRX-132B, 6 x 128
}
# the fp32 cases whose times are kept (rows' ``fp32_shapes``)
FP32_TIMED = ("train_fp32", "odd_fp32", "d120_fp32") + tuple(FP32_GROUPS)


def phase_flash_kernels() -> list:
    """Flash forward and backward against the plain versions: the trainer's
    shape (Qwen3-1.7B: B=8, H=16, KV=8, S=512, D=128) in bf16 and fp32, an
    odd shape (S=300, G=4, D=64, window 128, softcap 30), a group of 16
    (G x D = 2,048), PaliGemma's group (G=8, D=256) and H2O-Danube-3's
    head_dim 120 (window 128, softcap 30) in bf16 and fp32, and fp32 at
    the four archs' groups the first fp32 route refused (``FP32_GROUPS``).
    The bf16 kernels (the wgmma route, every mask and head_dim instance)
    must compute with wgmma (HGMMA in their SASS, and no HMMA), the fp32
    ones with TF32 HMMA; registers and spills from the build's report.
    Every bf16 and every timed fp32 backward runs twice for the same bits.  The pipeline
    phases' train steps (``_pipeline_shapes``) in their dtype.  Then the
    times of the bf16 trainer-shape case, and of the fp32 cases
    (``FP32_TIMED``: kernel, plain, SDPA's fp32 call, the 3xTF32 bound)."""
    torch = _torch()

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 10)
    bf16, fp32 = torch.bfloat16, torch.float32
    main = None
    fp32_cases = {}
    for label, b, h, kv, s, d, dtype, window, softcap in [
            ("train_bf16", 8, 16, 8, 512, 128, bf16, None, None),
            ("train_fp32", 8, 16, 8, 512, 128, fp32, None, None),
            ("odd_bf16", 2, 16, 4, 300, 64, bf16, 128, 30.0),
            ("odd_fp32", 2, 16, 4, 300, 64, fp32, 128, 30.0),
            ("gqa16_bf16", 1, 32, 2, 512, 128, bf16, None, None),
            ("g8d256_bf16", 1, 8, 1, 512, 256, bf16, None, None),
            ("d120_bf16", 2, 32, 8, 300, 120, bf16, 128, 30.0),
            ("d120_fp32", 2, 32, 8, 300, 120, fp32, 128, 30.0)] + [
            (label, b, h, kv, s, d, fp32, window, None)
            for label, (b, h, kv, s, d, window) in FP32_GROUPS.items()] + [
            # the pipeline phases' train steps (B=16 / 8, S=64; rl_100m:
            # B=16, H=12, KV=4, S=32, D=64)
            (phase, *shape["flash"][:5], getattr(torch, shape["flash"][5]), None, None)
            for phase, shape in _pipeline_shapes().items()]:
        case = _flash_case(gen, label, b, h, kv, s, d, dtype, window, softcap)
        if dtype == bf16 or label in FP32_TIMED:
            _flash_repeat_check(label, case, True, window, softcap)
        if label == "train_bf16":
            main = case
        elif label in FP32_TIMED:
            fp32_cases[label] = (case, window, softcap)
    registers = _ptxas_registers("flash_attention")
    hmma = _sass_hmma("flash_attention")
    emit("kernels", kernel="flash_attention", case="build", registers=registers, hmma=hmma)
    # the bf16 kernels, all on the wgmma route (forward, dQ and dK/dV at the
    # three head_dim instances, causal and not): HGMMA in each, HMMA
    # (mma.sync) in none
    wgmma = {fn: n for fn, n in hmma.items() if "_wgmma_kernel" in fn}
    if (len(wgmma) != 18 or any("_bf16_kernel" in fn for fn in hmma)
            or not all(n["hgmma"] and not n["hmma"] for n in wgmma.values())):
        raise AssertionError(f"flash_attention: bf16 kernels not on wgmma alone: {wgmma}")
    # the fp32 kernels (forward, dQ, dK/dV at three instances): 3xTF32
    f32 = {fn: n for fn, n in hmma.items()
           if re.search(r"flash_(fwd|bwd_dq|bwd_dkv)_f32(_pair)?_kernel", fn)}
    if len(f32) != 9 or not all(n["hmma_tf32"] for n in f32.values()):
        raise AssertionError(f"flash_attention: fp32 kernels without TF32 MMAs: {f32}")
    shape = _flash_shape(main[0], main[1])
    rows = []
    for name, backward, (ms, plain, lib, err, bound_ms, bound_by, detail), call in [
            ("flash_attention", False, _flash_times(main, False),
             "F.scaled_dot_product_attention(is_causal=True, enable_gqa=True)"),
            ("flash_attention_bwd", True, _flash_times(main, True),
             "torch.autograd.grad through one SDPA forward (its backward alone)")]:
        kind = "flash_bwd" if backward else "flash_fwd"
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/csrc/flash_attention.cu",
                     "replaces": "src/repro/kernels/flash_attention.py:108",
                     "variant": ("backward: delta, dK/dV and dQ kernels (the TPU had none); "
                                 if backward else "forward, O and lse; ")
                                + "bf16 on the wgmma route (wgmma + TMA, a producer "
                                  "warp, every mask and head_dim 64 / 128 / 256), "
                                  "fp32 as 3xTF32 on tensor cores (mma.sync m16n8k8, "
                                  "three MMAs a product)",
                     "launches": None, "max_abs_err": err, "ms": ms, "kernel_ms": ms,
                     "plain_ms": plain, "bound_ms": bound_ms, "bound_by": bound_by,
                     "bound_detail": detail, "library_ms": lib, "library_call": call,
                     "shape": shape,
                     "registers": {fn: r for fn, r in registers.items() if kind in fn},
                     "hmma": {fn: n["hmma"] for fn, n in hmma.items() if kind in fn},
                     "hgmma": {fn: n["hgmma"] for fn, n in hmma.items() if kind in fn}})
    for label, (case, window, softcap) in fp32_cases.items():
        causal = True
        for row, backward in ((rows[0], False), (rows[1], True)):
            ms, plain, lib, err, bound_ms, bound_by, detail = _flash_times(
                case, backward, causal, window, softcap)
            row.setdefault("fp32_shapes", {})[label] = {
                "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bound_ms,
                "bound_by": bound_by, "bound_detail": detail, "library_ms": lib,
                "library_call": (f"SDPA(is_causal={causal}, enable_gqa=True) fp32, TF32 off"
                                 + (" backward alone" if backward else "")) if lib else None,
                "window": window, "softcap": softcap,
                "shape": _flash_shape(case[0], case[1], causal)}
        del case
    fp32_cases.clear()
    for row in rows:
        emit("kernels", **{k: v for k, v in row.items() if k != "launches"})
    return rows


# ---------------------------------------------------------------------------
# kernels: dense-cache decode attention and the RWKV-6 WKV scan (slice 4)
# ---------------------------------------------------------------------------

def _live_range(length: int, s: int, window):
    """The keys a row's softmax weighs: [max(0, len - window), min(len, S)),
    or all S when that is empty (the -1e30 fill averages V uniformly)."""
    lo = max(0, length - window) if window is not None else 0
    hi = min(length, s)
    return (lo, hi) if lo < hi else (0, s)


def _decode_bound(q, k, lengths, window):
    """(bound_ms, bound_by, detail): 4HD flops per live key at 67 TFLOP/s
    fp32 against the live K/V rows, q, o and the lengths at 3.35 TB/s."""
    b, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    live = sum(hi - lo for lo, hi in (_live_range(n, s, window)
                                      for n in lengths.tolist()))
    nbytes = 2 * live * kv * d * k.element_size() + 2 * q.numel() * q.element_size() + 4 * b
    flops = 4 * h * d * live
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            {"live_keys": live, "flops": flops, "bytes": nbytes})


def _decode_times(q, k, v, lengths, err, lengths_text: str) -> dict:
    """Kernel, plain, SDPA (on the same cache, a boolean length mask) and
    the bound of one decode-attention call, the wrapper's plan, and the
    shape, with ``lengths_text`` saying which lengths."""
    torch = _torch()
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.ref import decode_attention_ref

    b, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    pos = torch.arange(s, device=DEVICE)[None, :]
    mask = (pos < lengths[:, None])[:, None, None, :]
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    bound_ms, bound_by, detail = _decode_bound(q, k, lengths, None)
    splits, chunk, mma = da.plan(s, b * kv, da.sm_count(q.device), h // kv, q.dtype, d)
    names = {torch.bfloat16: "bf16", torch.float32: "fp32"}
    return {"max_abs_err": err, "ms": _time_ms(lambda: decode_attention(q, k, v, lengths)),
            "plain_ms": _time_ms(lambda: decode_attention_ref(q, k, v, lengths)),
            "bound_ms": bound_ms, "bound_by": bound_by, "bound_detail": detail,
            "library_ms": _time_ms(lambda: F.scaled_dot_product_attention(
                q[:, :, None, :], kt, vt, attn_mask=mask, enable_gqa=True)),
            "shape": f"B={b} H={h} KV={kv} S={s} D={d} {names[q.dtype]}, "
                     + lengths_text,
            "split": {"splits": splits, "chunk": chunk,
                      "route": "tensor cores" if mma else "CUDA cores"}}


def _wkv_bound(r, k, v, w, y):
    """(bound_ms, bound_by, detail): about 5 D^2 flops per (b, t, h) at
    67 TFLOP/s fp32 against r/k/v/w read, y written and the state read and
    written once, at 3.35 TB/s."""
    b, t, h, d = r.shape
    nbytes = (sum(x.numel() * x.element_size() for x in (r, k, v, w, y))
              + 2 * 4 * b * h * d * d)
    flops = 5 * d * d * b * t * h
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            {"flops": flops, "bytes": nbytes})


def _strong_decays(gen, shape):
    """Decays log-uniform in [1e-4, 1]: -log w up to 9.2 a step (RWKV-6's
    w = exp(-exp(x)) reaches ~7)."""
    torch = _torch()
    return 10.0 ** (-4.0 * torch.rand(*shape, generator=gen, device=DEVICE))


def _route_errors(label, kernel, run, routes, want) -> dict:
    """Each forced route (``run(route, chunk)``) against the plain version's
    outputs ``want`` at the fp32 tolerance (fp32 arithmetic on both sides;
    bf16 inputs widen exactly).  One line per case; raises on a miss."""
    torch = _torch()
    tol = TOL["float32"]
    errs, ok = {}, True
    for route, chunk in routes:
        got = run(route, chunk)
        torch.cuda.synchronize()
        key = f"{route}{chunk or ''}"
        errs[key] = max((g - w).abs().max().item() for g, w in zip(got, want))
        ok &= all(torch.allclose(g, w, **tol) for g, w in zip(got, want))
    emit("kernels", case=label, kernel=kernel, max_abs_err=errs, tol=tol, ok=ok)
    if not ok:
        raise AssertionError(f"{kernel} {label}: max abs err by route {errs}")
    return errs


def _wkv_route_cases(gen) -> dict:
    """The WKV scan's two routes, forced, against the plain version: T in
    {2, L - 1, L, L + 1, 300, 512, 2048} for the chunk length L = 16, B in
    {1, 3, 16}, head_dim 32, 64 and 128, strong decays (w down to 1e-4) and
    the milder U(0.3, 1), bf16 r/k/v with fp32 w and all fp32, a state
    carried across two chunked calls, strided views, and a NaN in w, which
    every route passes on to the same outputs.  Then the prefill shape's
    times by route and a sweep over T and B.  Returns {"errors": worst
    error, "times": ..., "plan": ...}."""
    torch = _torch()
    from repro_torch.kernels import rwkv6_scan as wkv
    from repro_torch.kernels.ref import rwkv6_scan_ref

    bf16, fp32 = torch.bfloat16, torch.float32

    def inputs(b, t, h, d, rkv_dtype, strong):
        r, k, v = (torch.randn(b, t, h, d, generator=gen, device=DEVICE).to(rkv_dtype)
                   for _ in range(3))
        w = (_strong_decays(gen, (b, t, h, d)) if strong
             else torch.rand(b, t, h, d, generator=gen, device=DEVICE) * 0.7 + 0.3)
        u = torch.randn(h, d, generator=gen, device=DEVICE) * 0.5
        st = torch.randn(b, h, d, d, generator=gen, device=DEVICE) * 0.3
        return r, k, v, w, u, st

    routes = [("step", 0), ("chunked", wkv.CHUNK)]
    edges = [wkv.CHUNK - 1, wkv.CHUNK, wkv.CHUNK + 1]
    cases = ([(f"route_T{t}_strong", 1, t, 40, 64, bf16, True)
              for t in [2, *edges, 300, 512, 2048]]
             + [(f"route_B3_T{t}_D32", 3, t, 8, 32, bf16, True) for t in [*edges, 300]]
             + [(f"route_D128_T{t}", 1, t, 16, 128, bf16, True) for t in [*edges, 300]]
             + [("route_B16_T300_mild", 16, 300, 40, 64, bf16, False),
                ("route_B16_T33_fp32", 16, 33, 40, 64, fp32, True),
                ("route_T512_fp32_mild", 1, 512, 40, 64, fp32, False)])
    worst = 0.0
    for label, b, t, h, d, dtype, strong in cases:
        args = inputs(b, t, h, d, dtype, strong)
        want = rwkv6_scan_ref(*args)
        errs = _route_errors(label, "rwkv6_scan", lambda route, c: wkv.run(*args, route),
                             routes, want)
        worst = max(worst, *errs.values())

    # two chunked calls, the second from the first's state, equal one call;
    # strided views: time stride 2, head stride 2 D
    r, k, v, w, u, st = inputs(2, 600, 4, 128, fp32, True)
    r, k, v, w = (x[:, ::2, :, lo:lo + 64] for x, lo in ((r, 0), (k, 64), (v, 0), (w, 64)))
    want = rwkv6_scan_ref(r, k, v, w, u[:, :64].contiguous(), st[:, :, :64, :64].contiguous())
    u, st = u[:, :64].contiguous(), st[:, :, :64, :64].contiguous()

    def split(route, c):
        y1, s1 = wkv.run(r[:, :101], k[:, :101], v[:, :101], w[:, :101], u, st, route)
        y2, s2 = wkv.run(r[:, 101:], k[:, 101:], v[:, 101:], w[:, 101:], u, s1, route)
        return torch.cat([y1, y2], 1), s2
    errs = _route_errors("route_continuation_strided", "rwkv6_scan", split, routes, want)
    worst = max(worst, *errs.values())

    # a NaN in w at step 37, row 5 of one head: every route makes NaN the same
    # outputs as the plain version (the later steps, and that state row)
    args = inputs(1, 100, 4, 64, bf16, True)
    args[3][0, 37, 2, 5] = float("nan")
    want = rwkv6_scan_ref(*args)
    masks = {route: [torch.equal(g.isnan(), x.isnan()) for g, x in
                     zip(wkv.run(*args, route), want)] for route, _ in routes}
    finite = {route: [torch.allclose(g.nan_to_num(), x.nan_to_num(), **TOL["float32"])
                      for g, x in zip(wkv.run(*args, route), want)] for route, _ in routes}
    ok = all(all(m) for m in masks.values()) and all(all(f) for f in finite.values())
    emit("kernels", case="route_nan_decay", kernel="rwkv6_scan", same_nans=masks,
         finite_close=finite, nan_outputs=int(want[0].isnan().sum()), ok=ok)
    if not ok:
        raise AssertionError(f"rwkv6_scan route_nan_decay: NaN masks {masks}, "
                             f"finite values {finite}")

    # times at the prefill shape (RWKV-6 3B, one sequence of 512 tokens), by
    # route; the chunked route's kernels (profiler, L2 warm)
    args = inputs(1, 512, 40, 64, bf16, True)
    plan = wkv.plan(*args[0].shape)
    times = {f"{route}{c or ''}": _time_ms(lambda: wkv.run(*args, route))
             for route, c in routes}
    kernels = _device_busy(lambda: wkv.run(*args, plan[0]), 20,
                           kernel=("wkv_chunk_state", "wkv_carry", "wkv_chunk_out"))[1]
    # where the plan's thresholds sit: both routes over T at one sequence,
    # and at batches whose heads begin to fill the card
    sweep = {}
    for b, t in ((1, 16), (1, 32), (1, 64), (1, 128), (1, 2048), (4, 512), (5, 512),
                 (6, 512), (8, 512), (12, 512), (16, 512)):
        a = inputs(b, t, 40, 64, bf16, True)
        sweep[f"B{b}_T{t}"] = {"plan": wkv.plan(*a[0].shape),
                               **{f"{route}{c or ''}": _time_ms(lambda: wkv.run(*a, route))
                                  for route, c in routes}}
    emit("kernels", case="wkv_route_times", kernel="rwkv6_scan", shape=[1, 512, 40, 64],
         plan=plan, ms_by_route=times, chunked_kernels_ms=kernels, sweep_ms=sweep,
         min_t_chunked=wkv.CHUNKED_MIN_T, step_min_heads=wkv.STEP_MIN_HEADS)
    return {"errors": worst, "times": times, "plan": plan}


def _check_close(label, kernel, got, want, tol) -> float:
    torch = _torch()
    err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
    ok = all(torch.allclose(g.float(), w.float(), **tol) for g, w in zip(got, want))
    emit("kernels", case=label, kernel=kernel, max_abs_err=err, tol=tol, ok=ok)
    if not ok:
        raise AssertionError(f"{kernel} {label}: max abs err {err}")
    return err


def phase_slot_kernels() -> list:
    """The slot engine's kernels against their plain versions: decode
    attention at the serve shape (Qwen3-4B: B=16, H=32, KV=8, D=128,
    S=1024, ragged lengths with 1, S and > S) and an odd shape (S=300, G=4,
    D=64, window 128, a length-0 row), bf16 and fp32; the WKV scan at the
    RWKV-6 3B prefill (B=1, T=512, H=40, D=64) and decode (B=16, T=1)
    shapes and an odd one (T=300, D=32), with bf16 r/k/v and fp32 w, plus
    an all-fp32 case; the WKV scan's routes forced (``_wkv_route_cases``).
    Then the rows' times."""
    torch = _torch()
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels import rwkv6_scan as wkv
    from repro_torch.kernels.ref import decode_attention_ref, rwkv6_scan_ref
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 40)
    bf16, fp32 = torch.bfloat16, torch.float32

    def dense_case(b, h, kv, s, d, dtype, fixed):
        q = torch.randn(b, h, d, generator=gen, device=DEVICE).to(dtype)
        k = torch.randn(b, s, kv, d, generator=gen, device=DEVICE).to(dtype)
        v = torch.randn(b, s, kv, d, generator=gen, device=DEVICE).to(dtype)
        lengths = torch.randint(1, s + 1, (b,), generator=gen, device=DEVICE,
                                dtype=torch.int32)
        lengths[:len(fixed)] = torch.tensor(fixed, dtype=torch.int32, device=DEVICE)
        return q, k, v, lengths

    main = {}
    for label, b, h, kv, s, d, dtype, window, fixed in [
            ("serve_bf16", 16, 32, 8, 1024, 128, bf16, None, [1, 1024, 1100]),
            ("serve_fp32", 16, 32, 8, 1024, 128, fp32, None, [1, 1024, 1100]),
            ("odd_bf16", 3, 8, 2, 300, 64, bf16, 128, [0, 1, 320]),
            ("odd_fp32", 3, 8, 2, 300, 64, fp32, 128, [0, 1, 320]),
            # H2O-Danube-3's head_dim 120 (32 heads, 8 KV heads)
            ("d120_bf16", 4, 32, 8, 1024, 120, bf16, None, [1, 1024, 1100]),
            ("d120_fp32", 3, 32, 8, 300, 120, fp32, 128, [0, 1, 320])]:
        q, k, v, lengths = dense_case(b, h, kv, s, d, dtype, fixed)
        out = decode_attention(q, k, v, lengths, window=window)
        torch.cuda.synchronize()
        want = decode_attention_ref(q, k, v, lengths, window=window)
        err = _check_close(label, "decode_attention", [out], [want],
                           TOL[str(dtype).split(".")[-1]])
        if label == "serve_bf16":
            main["decode"] = (q, k, v, lengths, err)

    def wkv_case(b, t, h, d, rkv_dtype):
        r, k, v = (torch.randn(b, t, h, d, generator=gen, device=DEVICE).to(rkv_dtype)
                   for _ in range(3))
        w = torch.rand(b, t, h, d, generator=gen, device=DEVICE) * 0.7 + 0.3
        u = torch.randn(h, d, generator=gen, device=DEVICE) * 0.5
        st = torch.randn(b, h, d, d, generator=gen, device=DEVICE) * 0.3
        return r, k, v, w, u, st

    for label, b, t, h, d, dtype in [
            ("prefill_bf16rkv", 1, 512, 40, 64, bf16),
            ("decode_bf16rkv", 16, 1, 40, 64, bf16),
            ("odd_bf16rkv", 2, 300, 3, 32, bf16),
            ("prefill_fp32", 1, 512, 40, 64, fp32)]:
        args = wkv_case(b, t, h, d, dtype)
        got = rwkv6_scan(*args)
        torch.cuda.synchronize()
        want = rwkv6_scan_ref(*args)
        # fp32 outputs and fp32 arithmetic on both sides (bf16 inputs widen exactly)
        err = _check_close(label, "rwkv6_scan", got, want, TOL["float32"])
        if label in ("prefill_bf16rkv", "decode_bf16rkv"):
            main[label] = (args, got[0], err)

    q, k, v, lengths, err = main["decode"]
    times = _decode_times(q, k, v, lengths, err,
                          f"ragged lengths 1..{k.shape[1]} and above S")
    rows = [{"name": "decode_attention", "route": "cuda",
             "source": "src/repro_torch/csrc/decode_attention.cu",
             "replaces": "src/repro/kernels/decode_attention.py:85",
             "launches": None, **times, "kernel_ms": times["ms"],
             "library_call": "F.scaled_dot_product_attention(enable_gqa=True) with a "
                             "boolean length mask, on (B, KV, S, D) views of the cache"}]

    (args, y, err) = main["decode_bf16rkv"]
    pargs, py, perr = main["prefill_bf16rkv"]
    # the kernel has no backward: under autograd the wrapper must refuse
    try:
        rwkv6_scan(args[0].float().requires_grad_(), *args[1:])
    except RuntimeError:
        pass
    else:
        raise AssertionError("rwkv6_scan ran on inputs that need a gradient")
    routes = _wkv_route_cases(gen)
    times = {}
    for key, a, out in (("decode", args, y), ("prefill", pargs, py)):
        # the plain prefill is a 512-step host loop that no device sleep
        # covers: it is timed by the synchronised wall clock
        times[key] = (_time_ms(lambda: rwkv6_scan(*a)),
                      _wall_ms(lambda: rwkv6_scan_ref(*a), iters=3) if key == "prefill"
                      else _time_ms(lambda: rwkv6_scan_ref(*a)),
                      _wkv_bound(*a[:4], out))
    (kernel_ms, plain_ms, (bound_ms, bound_by, detail)) = times["decode"]
    (p_ms, p_plain, (p_bound, p_by, p_detail)) = times["prefill"]
    rows.append({"name": "rwkv6_scan", "route": "cuda",
                 "source": "src/repro_torch/csrc/rwkv6_scan.cu",
                 "replaces": "src/repro/kernels/rwkv6_scan.py:66",
                 "launches": None, "max_abs_err": max(err, perr), "ms": kernel_ms,
                 "kernel_ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "bound_by": bound_by, "bound_detail": detail, "library_ms": None,
                 "library_call": "none: no PyTorch call computes the WKV recurrence",
                 "shape": "decode: B=16 T=1 H=40 D=64, bf16 r/k/v, fp32 w and state "
                          "(the step route)",
                 "prefill_ms": p_ms, "prefill_plain_wall_ms": p_plain,
                 "prefill_bound_ms": p_bound, "prefill_bound_by": p_by,
                 "prefill_bound_detail": p_detail,
                 "prefill_route": routes["plan"][0], "prefill_chunk": routes["plan"][1],
                 "prefill_kernels_per_call": wkv.KERNELS_PER_CALL[routes["plan"][0]],
                 "prefill_ms_by_route": routes["times"],
                 "route_cases_max_abs_err": routes["errors"],
                 "registers": _ptxas_registers("rwkv6_scan"),
                 "prefill_shape": "B=1 T=512 H=40 D=64, bf16 r/k/v, fp32 w and state"})
    for row in rows:
        emit("kernels", **{k: v for k, v in row.items() if k != "launches"})
    return rows


# ---------------------------------------------------------------------------
# kernels: the RG-LRU scan and decode attention at RecurrentGemma's shapes
# (slice 5)
# ---------------------------------------------------------------------------

def _rglru_bound(a, b):
    """(bound_ms, bound_by, detail): a and b read in their dtypes, h0 read,
    hs and h_last written (fp32), at 3.35 TB/s, against 2 flops per element
    at 67 TFLOP/s fp32."""
    bsz, t, w = a.shape
    nbytes = (a.numel() * a.element_size() + b.numel() * b.element_size()
              + 4 * bsz * w * 2 + 4 * bsz * t * w)
    flops = 2 * bsz * t * w
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            {"flops": flops, "bytes": nbytes})


def _ptxas_registers(name: str) -> dict:
    """{kernel function: [registers, spill store bytes, spill load bytes]}
    from the ``-Xptxas -v`` report of ``csrc/<name>.cu``'s build."""
    import re
    from repro_torch.kernels import build
    log = build._target(build.sources()[name]).with_suffix(".log")
    out, fn = {}, None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
            out[fn] = [None, 0, 0]
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn:
            out[fn][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out[fn][0] = int(m.group(1))
    return out


def _rglru_route_cases(gen) -> dict:
    """The RG-LRU scan's two routes, forced, against the plain version: T in
    {2, L - 1, L, L + 1, 300, 512, 2048} for L in 16, 32, 64 (and the
    plan's L), B in {1, 3, 16}, W 4096 and an odd 96, fp32 and bf16 a/b,
    decays a log-uniform in [1e-4, 1) and a near 1 (long memory), a nonzero
    h0, a state carried across two chunked calls, and strided views.  Then
    the prefill shape's times by route and L.  Returns {"errors": worst
    error, "times": ..., "plan": ...}."""
    torch = _torch()
    from repro_torch.kernels import rglru_scan as lru
    from repro_torch.kernels.ref import rglru_scan_ref

    bf16, fp32 = torch.bfloat16, torch.float32
    chunks = sorted({16, 32, 64, lru.plan(1, 512, 4096)[1]})
    routes = [("direct", 0)] + [("chunked", c) for c in chunks]

    def inputs(b, t, w, dtype, decays):
        a = (_strong_decays(gen, (b, t, w)).clamp(max=0.9999) if decays == "strong"
             else 1.0 - 10.0 ** (-1.0 - 3.0 * torch.rand(b, t, w, generator=gen, device=DEVICE)))
        bb = torch.randn(b, t, w, generator=gen, device=DEVICE) * 0.5
        h0 = torch.randn(b, w, generator=gen, device=DEVICE)
        return a.to(dtype), bb.to(dtype), h0

    edges = sorted({t for c in chunks for t in (c - 1, c, c + 1)})
    cases = ([(f"route_T{t}_strong", 1, t, 4096, fp32, "strong") for t in [2, *edges, 300, 512]]
             + [("route_T2048_long", 1, 2048, 4096, bf16, "long"),
                ("route_T512_long_bf16", 1, 512, 4096, bf16, "long"),
                ("route_B3_T300_W96", 3, 300, 96, fp32, "long"),
                ("route_B3_T300_bf16", 3, 300, 4096, bf16, "strong"),
                ("route_B16_T300", 16, 300, 4096, fp32, "long")])
    worst = 0.0
    for label, b, t, w, dtype, decays in cases:
        a, bb, h0 = inputs(b, t, w, dtype, decays)
        want = rglru_scan_ref(a, bb, h0)
        errs = _route_errors(label, "rglru_scan", lambda route, c: lru.run(a, bb, h0, route, c),
                             routes, want)
        worst = max(worst, *errs.values())

    # two chunked calls equal one; strided views: time stride 2, batch rows
    # of a wider buffer
    a, bb, h0 = inputs(2, 1200, 8192, fp32, "long")
    a, bb = a[:, ::2, :4096], bb[:, ::2, 4096:]
    want = rglru_scan_ref(a, bb, h0[:, :4096].contiguous())
    h0 = h0[:, :4096].contiguous()

    def split(route, c):
        hs1, h1 = lru.run(a[:, :257], bb[:, :257], h0, route, c)
        hs2, h2 = lru.run(a[:, 257:], bb[:, 257:], h1, route, c)
        return torch.cat([hs1, hs2], 1), h2
    errs = _route_errors("route_continuation_strided", "rglru_scan", split, routes, want)
    worst = max(worst, *errs.values())

    times = {}
    for dtype in (fp32, bf16):
        a, bb, h0 = inputs(1, 512, 4096, dtype, "long")
        times[str(dtype).split(".")[-1]] = {
            f"{route}{c or ''}": _time_ms(lambda: lru.run(a, bb, h0, route, c))
            for route, c in routes}
    plan = lru.plan(1, 512, 4096)
    kernels = _device_busy(lambda: lru.run(a, bb, h0, *plan), 20,
                           kernel=("rglru_chunk_aggregate", "rglru_chunk_finish"))[1]
    # where the plan's thresholds sit (fp32 a/b)
    sweep = {}
    for b, t in ((1, 32), (1, 64), (1, 128), (1, 2048), (3, 512), (4, 512), (5, 512),
                 (6, 512), (8, 512), (12, 512), (16, 512)):
        a, bb, h0 = inputs(b, t, 4096, fp32, "long")
        sweep[f"B{b}_T{t}"] = {"plan": lru.plan(*a.shape),
                               **{f"{route}{c or ''}": _time_ms(lambda: lru.run(a, bb, h0,
                                                                                route, c))
                                  for route, c in routes}}
    emit("kernels", case="rglru_route_times", kernel="rglru_scan", shape=[1, 512, 4096],
         plan=plan, ms_by_route=times, chunked_kernels_ms_bf16=kernels, sweep_ms=sweep,
         min_t_chunked=lru.CHUNKED_MIN_T, direct_min_threads=lru.DIRECT_MIN_THREADS)
    return {"errors": worst, "times": times, "plan": plan}


def _scan_sync_check() -> None:
    """Both scan wrappers at their prefill shapes (the chunked route) and at
    decode (step / direct) under ``set_sync_debug_mode("error")``: the
    routes come from static shapes, so no call may read a device value on
    the host.  One launch counted per call."""
    torch = _torch()
    from repro_torch.kernels.rglru_scan import rglru_scan
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan

    def wkv_args(b, t):
        return [torch.rand(b, t, 40, 64, device=DEVICE) for _ in range(4)] + [
            torch.zeros(40, 64, device=DEVICE), torch.zeros(b, 40, 64, 64, device=DEVICE)]

    def lru_args(b, t):
        return [torch.rand(b, t, 4096, device=DEVICE) for _ in range(2)] + [
            torch.zeros(b, 4096, device=DEVICE)]
    calls = [(rwkv6_scan, wkv_args(1, 512)), (rwkv6_scan, wkv_args(16, 1)),
             (rglru_scan, lru_args(1, 512)), (rglru_scan, lru_args(16, 1))]
    for fn, args in calls:                       # built and warm
        fn(*args)
    torch.cuda.synchronize()
    before = [(fn.launches, fn.launches_chunked) for fn, _ in calls]
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for fn, args in calls:
            fn(*args)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()
    wkv_counts = (rwkv6_scan.launches - before[0][0], rwkv6_scan.launches_chunked - before[0][1])
    lru_counts = (rglru_scan.launches - before[2][0], rglru_scan.launches_chunked - before[2][1])
    emit("kernels", case="scan_sync_debug", sync_debug_mode="error", ok=True,
         routes={"rwkv6_scan": ["chunked", "step"], "rglru_scan": ["chunked", "direct"]},
         launches={"rwkv6_scan": wkv_counts, "rglru_scan": lru_counts})
    if wkv_counts != (2, 1) or lru_counts != (2, 1):
        raise AssertionError(f"scan wrappers counted {wkv_counts} / {lru_counts} launches "
                             "(calls, chunked) for two calls each, one at a prefill shape")


def phase_hybrid_kernels():
    """The hybrid's kernels against their plain versions: the RG-LRU scan
    at RecurrentGemma-9B's prefill (B=1, T=512, W=4096) and decode (B=16,
    T=1) shapes and an odd one (B=3, T=300, W=96, a nonzero h0), fp32 and
    bf16 a/b with a in (0, 1), a state carried across a split of the
    prefill, and the refusal of inputs that need a gradient; decode
    attention at the hybrid's serve shape (B=16, H=16, KV=1, D=256,
    S=1024, ragged lengths, window 2048) and an odd one (S=300, window
    128, a length-0 row), bf16 and fp32.  Every scan case is timed; the
    scan's routes forced (``_rglru_route_cases``), and both scan wrappers
    under the sync debug mode (``_scan_sync_check``).
    Returns (the ``rglru_scan`` row, the decode-attention row's hybrid
    fields)."""
    torch = _torch()
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import rglru_scan as lru
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.ref import decode_attention_ref, rglru_scan_ref
    from repro_torch.kernels.rglru_scan import rglru_scan

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 60)
    bf16, fp32 = torch.bfloat16, torch.float32
    cases = {}
    for label, b, t, w, dtype, h0_scale in [
            ("prefill_fp32", 1, 512, 4096, fp32, 0.0),
            ("prefill_bf16", 1, 512, 4096, bf16, 0.0),
            ("decode_fp32", 16, 1, 4096, fp32, 1.0),
            ("decode_bf16", 16, 1, 4096, bf16, 1.0),
            ("odd_fp32", 3, 300, 96, fp32, 1.0),
            ("odd_bf16", 3, 300, 96, bf16, 1.0)]:
        a = (torch.rand(b, t, w, generator=gen, device=DEVICE) * 0.98 + 0.01).to(dtype)
        bb = (torch.randn(b, t, w, generator=gen, device=DEVICE) * 0.5).to(dtype)
        h0 = torch.randn(b, w, generator=gen, device=DEVICE) * h0_scale
        got = rglru_scan(a, bb, h0)
        torch.cuda.synchronize()
        want = rglru_scan_ref(a, bb, h0)
        # fp32 outputs and fp32 arithmetic on both sides (bf16 inputs widen
        # exactly); the kernel fuses each step's multiply-add
        err = _check_close(label, "rglru_scan", got, want, TOL["float32"])
        cases[label] = (a, bb, h0, got, err)

    # the state carried across a split of T continues the recurrence
    a, bb, h0, (hs, h_last), _ = cases["prefill_fp32"]
    hs1, h_mid = rglru_scan(a[:, :256], bb[:, :256], h0)
    hs2, h_end = rglru_scan(a[:, 256:], bb[:, 256:], h_mid)
    _check_close("continuation_fp32", "rglru_scan", [torch.cat([hs1, hs2], 1), h_end],
                 [hs, h_last], TOL["float32"])
    # the kernel has no backward: under autograd the wrapper must refuse
    before = rglru_scan.launches
    try:
        rglru_scan(a.detach().requires_grad_(), bb, h0)
    except RuntimeError:
        pass
    else:
        raise AssertionError("rglru_scan ran on inputs that need a gradient")
    if rglru_scan.launches != before:
        raise AssertionError("rglru_scan launched on inputs that need a gradient")

    times = {}
    for label, (a, bb, h0, _, err) in cases.items():
        # a plain version over T > 1 is a host loop that no device sleep
        # covers: it is timed by the synchronised wall clock
        plain = (_wall_ms(lambda: rglru_scan_ref(a, bb, h0), iters=3) if a.shape[1] > 1
                 else _time_ms(lambda: rglru_scan_ref(a, bb, h0)))
        bound_ms, bound_by, detail = _rglru_bound(a, bb)
        times[label] = dict(ms=_time_ms(lambda: rglru_scan(a, bb, h0)), plain_ms=plain,
                            plain_timing="wall" if a.shape[1] > 1 else "events",
                            bound_ms=bound_ms, bound_by=bound_by, bound_detail=detail,
                            max_abs_err=err, shape=list(a.shape), dtype=str(a.dtype))
        emit("kernels", case=label, kernel="rglru_scan", **times[label])
    registers = _ptxas_registers("rglru_scan")
    routes = _rglru_route_cases(gen)
    _scan_sync_check()
    dec, pre = times["decode_fp32"], times["prefill_fp32"]
    row = {"name": "rglru_scan", "route": "cuda",
           "source": "src/repro_torch/csrc/rglru_scan.cu",
           "replaces": "src/repro/kernels/rglru_scan.py:57",
           "launches": None, "max_abs_err": max(c[4] for c in cases.values()),
           "ms": dec["ms"], "kernel_ms": dec["ms"], "plain_ms": dec["plain_ms"],
           "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
           "bound_detail": dec["bound_detail"], "library_ms": None,
           "library_call": "none: no PyTorch call computes the linear recurrence",
           "shape": "decode: B=16 T=1 W=4096, fp32 a/b and h0 (the model's gates; the "
                    "direct route)",
           "prefill_ms": pre["ms"], "prefill_plain_wall_ms": pre["plain_ms"],
           "prefill_bound_ms": pre["bound_ms"], "prefill_bound_by": pre["bound_by"],
           "prefill_shape": "B=1 T=512 W=4096, fp32 a/b",
           "prefill_route": routes["plan"][0], "prefill_chunk": routes["plan"][1],
           "prefill_kernels_per_call": lru.KERNELS_PER_CALL[routes["plan"][0]],
           "prefill_ms_by_route": routes["times"],
           "route_cases_max_abs_err": routes["errors"],
           "cases": times, "registers": registers}

    def dense_case(b, h, kv, s, d, dtype, fixed):
        q = torch.randn(b, h, d, generator=gen, device=DEVICE).to(dtype)
        k = torch.randn(b, s, kv, d, generator=gen, device=DEVICE).to(dtype)
        v = torch.randn(b, s, kv, d, generator=gen, device=DEVICE).to(dtype)
        lengths = torch.randint(1, s + 1, (b,), generator=gen, device=DEVICE,
                                dtype=torch.int32)
        lengths[:len(fixed)] = torch.tensor(fixed, dtype=torch.int32, device=DEVICE)
        return q, k, v, lengths

    main = None
    for label, b, h, kv, s, d, dtype, window, fixed in [
            ("hybrid_serve_bf16", 16, 16, 1, 1024, 256, bf16, 2048, [1, 1024, 1100]),
            ("hybrid_serve_fp32", 16, 16, 1, 1024, 256, fp32, 2048, [1, 1024, 1100]),
            ("hybrid_odd_bf16", 3, 16, 1, 300, 256, bf16, 128, [0, 1, 320]),
            ("hybrid_odd_fp32", 3, 16, 1, 300, 256, fp32, 128, [0, 1, 320])]:
        q, k, v, lengths = dense_case(b, h, kv, s, d, dtype, fixed)
        out = decode_attention(q, k, v, lengths, window=window)
        torch.cuda.synchronize()
        want = decode_attention_ref(q, k, v, lengths, window=window)
        err = _check_close(label, "decode_attention", [out], [want],
                           TOL[str(dtype).split(".")[-1]])
        if label == "hybrid_serve_bf16":
            main = (q, k, v, lengths, window, err)
    q, k, v, lengths, window, err = main
    s = k.shape[1]
    pos = torch.arange(s, device=DEVICE)[None, :]
    mask = ((pos < lengths[:, None]) & (pos >= lengths[:, None] - window))[:, None, None, :]
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    bound_ms, bound_by, detail = _decode_bound(q, k, lengths, window)
    splits, chunk, mma = da.plan(s, q.shape[0] * k.shape[2], da.sm_count(q.device),
                                 q.shape[1] // k.shape[2], q.dtype, q.shape[2])
    extra = {"hybrid_ms": _time_ms(lambda: decode_attention(q, k, v, lengths, window=window)),
             "hybrid_plain_ms": _time_ms(lambda: decode_attention_ref(q, k, v, lengths,
                                                                      window=window)),
             "hybrid_library_ms": _time_ms(lambda: F.scaled_dot_product_attention(
                 q[:, :, None, :], kt, vt, attn_mask=mask, enable_gqa=True)),
             "hybrid_bound_ms": bound_ms, "hybrid_bound_by": bound_by,
             "hybrid_bound_detail": detail, "hybrid_max_abs_err": err,
             "hybrid_shape": "RecurrentGemma-9B: B=16 H=16 KV=1 D=256 S=1024 bf16, "
                             "window 2048, ragged lengths 1..1024 and above S",
             "hybrid_split": {"splits": splits, "chunk": chunk,
                              "route": "tensor cores" if mma else "CUDA cores"},
             "registers": _ptxas_registers("decode_attention")}
    emit("kernels", kernel="decode_attention", case="hybrid_times",
         **{k: v for k, v in extra.items() if k != "registers"})
    emit("kernels", **{k: v for k, v in row.items() if k != "launches"})
    return row, extra


# ---------------------------------------------------------------------------
# kernels: the split decode kernels' edge cases at the slice shapes (slice 7)
# ---------------------------------------------------------------------------

def _split_lengths(b: int, keys: int, chunk: int, splits: int, window=None) -> list:
    """Row lengths that put the split kernels' edges at the slice shape:
    0, 1, chunk - 1, chunk, chunk + 1 (keys), the last key, past it (with a
    window: past S by more than the window, so no key is valid), then one
    row ending in each split count, as many as the other rows allow."""
    fixed = [0, 1, chunk - 1, chunk, chunk + 1, keys, keys + (window or 0) + 37]
    rest = b - len(fixed)
    spread = [(1 + i * (splits - 1) // max(rest - 1, 1)) * chunk - i % 3 for i in range(rest)]
    return (fixed + spread)[:b]


def _split_tables(gen, b, p, page_size, n_pages, lengths, chunk):
    """Block tables for ``lengths``: distinct pages below each length, -1
    tails; row 0 all -1, row 1 every entry assigned (give it length 0),
    row 2 a -1 entry inside its live range, and the first row that reaches
    a third chunk of ``chunk`` entries its whole second chunk -1 (an empty
    split between live ones)."""
    torch = _torch()
    perm = torch.randperm(n_pages - 1, generator=gen, device=DEVICE).to(torch.int32) + 1
    tables = perm[:b * p].view(b, p).clone()
    for i, length in enumerate(lengths):
        if i != 1:
            tables[i, max(0, -(-length // page_size)):] = -1
    tables[0] = -1
    tables[2, 0] = -1
    middle = next(i for i, n in enumerate(lengths)
                  if i > 2 and n > 2 * chunk * page_size and n <= p * page_size)
    tables[middle, chunk:2 * chunk] = -1
    return tables


def phase_split_kernels() -> None:
    """The split decode kernels at the four slice shapes (dense Qwen3-4B,
    dense RecurrentGemma-9B, paged bf16 and int8 pools) with the rows of
    ``_split_lengths``: an empty split, rows with no valid key, lengths at
    chunk boundaries and above S, windows across a chunk boundary and past
    S, -1 entries in and after the live range, a softcap; bf16 and fp32
    against the plain versions.  Each shape's plan (splits and chunk per
    (row, KV head)) is printed, each wrapper call must launch once, and both
    wrappers run once under ``torch.cuda.set_sync_debug_mode("error")``:
    neither may wait for the device."""
    torch = _torch()
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels.ref import decode_attention_ref, paged_decode_attention_ref
    from repro_torch.models.paged import quantize_kv

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 70)
    bf16, fp32 = torch.bfloat16, torch.float32
    sms = da.sm_count(torch.device(DEVICE, torch.cuda.current_device()))
    b, s = 16, 1024

    def once(wrapper, counter, *args, **kw):
        before = getattr(wrapper, counter)
        out = wrapper(*args, **kw)
        if getattr(wrapper, counter) - before != 1:
            raise AssertionError(f"{wrapper.__name__}: {getattr(wrapper, counter) - before} "
                                 "launches in one call")
        return out

    last = {}
    for label, h, kv, d, window, dtypes in [
            ("qwen3", 32, 8, 128, None, (bf16, fp32)),
            ("qwen3_window", 32, 8, 128, "chunk", (fp32,)),
            ("hybrid", 16, 1, 256, 2048, (bf16, fp32)),
            ("hybrid_window", 16, 1, 256, "chunk", (fp32,))]:
        for dtype in dtypes:
            name = str(dtype).split(".")[-1]
            splits, chunk, mma = da.plan(s, b * kv, sms, h // kv, dtype, d)
            win = chunk + 5 if window == "chunk" else window   # across a chunk boundary
            lengths = torch.tensor(_split_lengths(b, s, chunk, splits, win),
                                   dtype=torch.int32, device=DEVICE)
            emit("kernels", kernel="decode_attention", case=f"split_plan_{label}_{name}",
                 shape=[b, h, kv, s, d], window=win, sms=sms, splits=splits, chunk=chunk,
                 route="tensor cores" if mma else "CUDA cores", lengths=lengths.tolist())
            q = torch.randn(b, h, d, generator=gen, device=DEVICE).to(dtype)
            k = torch.randn(b, s, kv, d, generator=gen, device=DEVICE).to(dtype)
            v = torch.randn(b, s, kv, d, generator=gen, device=DEVICE).to(dtype)
            out = once(da.decode_attention, "launches", q, k, v, lengths, window=win)
            torch.cuda.synchronize()
            want = decode_attention_ref(q, k, v, lengths, window=win)
            _check_close(f"split_{label}_{name}", "decode_attention", [out], [want], TOL[name])
            last["dense"] = (q, k, v, lengths, win)

    h, kv, d = 32, 8, 128
    page_size = SERVE["page_size"]
    p = SERVE["max_total_len"] // page_size
    n_pages = 1 + b * p
    for label, dtype, softcap, int8 in [
            ("bf16", bf16, None, False), ("fp32", fp32, None, False),
            ("softcap_fp32", fp32, 30.0, False), ("int8_bf16q", bf16, None, True),
            ("int8_fp32q", fp32, None, True), ("softcap_int8_fp32q", fp32, 30.0, True),
            ("softcap_int8_bf16q", bf16, 30.0, True)]:
        splits, chunk, tp, mma = pda.plan(p, page_size, b * kv, sms, h // kv, dtype,
                                          torch.int8 if int8 else dtype, d)
        keys = chunk * page_size
        lengths = _split_lengths(b, p * page_size, keys, splits)
        lengths[0] = 5 * page_size + 3      # all -1 entries with a length
        lengths[1] = 0                      # every entry assigned, no length
        lengths[2] = max(lengths[2], 3 * page_size)
        tables = _split_tables(gen, b, p, page_size, n_pages, lengths, chunk)
        lengths = torch.tensor(lengths, dtype=torch.int32, device=DEVICE)
        emit("kernels", kernel="paged_decode_attention", case=f"split_plan_{label}",
             shape=[b, h, kv, d, page_size, p], sms=sms, splits=splits, chunk_entries=chunk,
             pages_per_tile=tp, route="tensor cores" if mma else "CUDA cores",
             lengths=lengths.tolist())
        q = torch.randn(b, h, d, generator=gen, device=DEVICE).to(dtype)
        kp = torch.randn(n_pages, page_size, kv, d, generator=gen, device=DEVICE).to(dtype)
        vp = torch.randn(n_pages, page_size, kv, d, generator=gen, device=DEVICE).to(dtype)
        scales = {}
        if int8:
            (kp, ks), (vp, vs) = quantize_kv(kp), quantize_kv(vp)
            scales = {"k_scales": ks, "v_scales": vs}
        out = once(pda.paged_decode_attention, "launches", q, kp, vp, tables, lengths,
                   softcap=softcap, **scales)
        torch.cuda.synchronize()
        want = paged_decode_attention_ref(q, kp, vp, tables, lengths, softcap=softcap,
                                          **scales)
        _check_close(f"split_{label}", "paged_decode_attention", [out], [want],
                     TOL[str(dtype).split(".")[-1]])
        last[f"paged_int8_{'tensor' if mma else 'cuda'}" if int8 else "paged"] = (
            q, kp, vp, tables, lengths, scales)

    # neither wrapper may read a device value on the host: a sync raises
    q, k, v, lengths, window = last["dense"]
    qp, kp, vp, tables, plens, _ = last["paged"]
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        da.decode_attention(q, k, v, lengths, window=window)
        pda.paged_decode_attention(qp, kp, vp, tables, plens)
        for route in ("tensor", "cuda"):     # the int8 pool by both routes
            qi, ki, vi, ti, ilens, scales = last[f"paged_int8_{route}"]
            pda.paged_decode_attention(qi, ki, vi, ti, ilens, **scales)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()
    emit("kernels", case="split_sync_debug", sync_debug_mode="error", ok=True,
         launches_per_call=1)


# ---------------------------------------------------------------------------
# model: kernel vs ref decode attention at full width, fp32
# ---------------------------------------------------------------------------

def _drain(engine, want: int, max_steps: int = 2000) -> dict:
    out = {}
    for _ in range(max_steps):
        for rid, toks, lps in engine.step():
            out[rid] = (toks.tolist(), lps.tolist())
        if hasattr(engine, "audit_pages"):       # the paged engine's pool
            engine.audit_pages()
        if len(out) >= want:
            return out
    raise AssertionError(f"engine stalled: {len(out)}/{want} finished")


def _top2_gap(api, params, tokens) -> float:
    """Gap between the two largest next-token logits after ``tokens``
    (plain forward, fp32)."""
    torch = _torch()
    with torch.no_grad():
        logits, _ = api.apply(params, {"tokens": torch.tensor([tokens], device=DEVICE)},
                              attn_impl="ref")
    top = torch.topk(logits[0, -1], 2).values
    return float(top[0] - top[1])


def _kernel_vs_ref(api, params, prompts, kv_quant: str, max_new: int,
                   phase: str = "model") -> dict:
    """Kernel vs plain decode attention at full width: the first decode
    step's logits on one shared pool, then greedy tokens through two
    engines.  A divergence is tolerated only at a near-tie of the top two
    logits (dense plain forward)."""
    torch = _torch()

    ps, pp = 16, 32
    cache = api.init_paged_cache(1 + len(prompts) * pp, ps, kv_quant=kv_quant)
    tables = torch.arange(1, 1 + len(prompts) * pp, dtype=torch.int32,
                          device=DEVICE).view(len(prompts), pp)
    first = []
    with torch.no_grad():
        for i, prompt in enumerate(prompts):
            for lo in range(0, len(prompt), 128):
                chunk = torch.tensor(prompt[lo:lo + 128], device=DEVICE)[None]
                logits, cache = api.prefill_chunk(
                    params, chunk, torch.ones_like(chunk, dtype=torch.bool), lo,
                    tables[i], cache)
            first.append(int(logits.argmax()))
        token = torch.tensor(first, dtype=torch.int32, device=DEVICE)
        pos = torch.tensor([len(x) for x in prompts], dtype=torch.int32, device=DEVICE)
        lk, _ = api.decode_paged(params, token, pos, cache, tables, attn_impl="kernel")
        lr, _ = api.decode_paged(params, token, pos, cache, tables, attn_impl="ref")
    logit_diff = (lk - lr).abs().max().item()
    del cache

    results = {}
    for impl in ("kernel", "ref"):
        results[impl] = _greedy(api, params, prompts, max_new, attn_impl=impl,
                                kv_quant=kv_quant)
    divergences = []
    for rid, prompt in enumerate(prompts):
        a, b = results["kernel"][rid][0], results["ref"][rid][0]
        if a != b:
            step = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
            gap = _top2_gap(api, params, list(prompt) + a[:step])
            divergences.append({"request": rid, "step": step, "top2_gap": gap})
    emit(phase, arch=api.cfg.arch_id, dtype="float32", kv_quant=kv_quant,
         check="kernel_vs_ref",
         layers=api.cfg.num_layers, d_model=api.cfg.d_model,
         first_decode_logits_max_abs_diff=logit_diff, requests=len(prompts),
         max_new_tokens=max_new, tokens_identical=not divergences,
         divergences=divergences)
    bad = [dv for dv in divergences if not dv["top2_gap"] < DENSE_TOP2_TOL]
    if bad:
        raise AssertionError(f"kv_quant={kv_quant}: kernel and ref greedy tokens "
                             f"diverge: {bad}")
    return results


def _greedy(api, params, prompts, max_new, steps_out=None, **engine_kw) -> dict:
    """Greedy tokens of ``prompts`` through a ``PagedDecodeEngine``; its
    decode steps appended to ``steps_out`` when given."""
    torch = _torch()
    from repro_torch.rollout import PagedDecodeEngine
    eng = PagedDecodeEngine(api, params, num_slots=len(prompts), max_total_len=512,
                            page_size=16, prefill_chunk=128, temperature=0.0,
                            eos_id=-1, device=DEVICE, **engine_kw)
    for rid, prompt in enumerate(prompts):
        eng.add_request(rid, prompt, max_new)
    with torch.no_grad():
        out = _drain(eng, len(prompts))
    if steps_out is not None:
        steps_out.append(eng.total_decode_steps)
    del eng
    return out


def phase_model() -> None:
    import dataclasses
    import numpy as np
    torch = _torch()
    from repro_torch.configs import get_config
    from repro_torch.models import get_api
    from repro_torch.quant import dequantize_params, quantize_params

    cfg = dataclasses.replace(get_config(ARCH), dtype="float32")
    api = get_api(cfg, device=DEVICE)
    params = api.init(SEED)
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(3, cfg.vocab_size, n).astype(np.int32)
               for n in (40, 100, 180, 250)]
    max_new = 16
    for kv_quant in ("off", "int8"):
        _kernel_vs_ref(api, params, prompts, kv_quant, max_new)
        torch.cuda.empty_cache()

    # quantize-on-sync: the engine's per-layer dequantization must give
    # exactly the tokens of the off engine on weights quantized and
    # dequantized up front (the same fp32 products, the same matmuls)
    for mode in ("int8", "fp8"):
        quantized = _greedy(api, params, prompts, max_new, quant_mode=mode)
        fake = dequantize_params(quantize_params(params, mode))
        offline = _greedy(api, fake, prompts, max_new)
        del fake
        torch.cuda.empty_cache()
        same = quantized == offline
        emit("model", arch=ARCH, dtype="float32", check="quantize_on_sync",
             quant_mode=mode, requests=len(prompts), max_new_tokens=max_new,
             tokens_identical=same)
        if not same:
            raise AssertionError(f"quant_mode={mode}: engine tokens differ from the "
                                 "off engine on fake-quantized weights")
    del params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# model_slot: the slot engine at full width, fp32 (slice 4)
# ---------------------------------------------------------------------------

def _slot_greedy(api, params, prompts, max_new, steps_out=None, **engine_kw) -> dict:
    """As ``_greedy``, through the slot ``DecodeEngine``."""
    torch = _torch()
    from repro_torch.rollout import DecodeEngine
    eng = DecodeEngine(api, params, num_slots=len(prompts), max_total_len=512,
                       temperature=0.0, eos_id=-1, device=DEVICE, **engine_kw)
    for rid, prompt in enumerate(prompts):
        eng.add_request(rid, prompt, max_new)
    with torch.no_grad():
        out = _drain(eng, len(prompts))
    if steps_out is not None:
        steps_out.append(eng.total_decode_steps)
    del eng
    return out


def _slot_first_logits(api, params, prompts, attn_impl):
    """Exact-length prefill of each prompt into its row of one slot cache,
    then one decode step of every row: (prefill logits, decode logits,
    cache)."""
    torch = _torch()
    cache = api.init_cache(len(prompts), 512)
    first = []
    with torch.no_grad():
        for i, prompt in enumerate(prompts):
            logits, _ = api.prefill(params, {"tokens": torch.tensor(prompt, device=DEVICE)[None]},
                                    cache.rows(i, i + 1), attn_impl=attn_impl)
            first.append(logits)
        first = torch.cat(first)
        token = first.argmax(-1).to(torch.int32)
        pos = torch.tensor([len(x) for x in prompts], dtype=torch.int32, device=DEVICE)
        logits, _ = api.decode_step(params, token, pos, cache, attn_impl=attn_impl)
    return first, logits, cache


def _layer_divergence(params, host_blocks, prompts, block) -> list:
    """Each prompt's prefill through every block three ways: the kernel
    path, its plain version on the card, and the plain version on the host
    CPU (``host_blocks``: the first layers' params there; another reduction
    order, no kernel).  ``block(lp, x, i, attn_impl)`` runs layer ``i``
    from a zero state.  Per layer, the largest over the prompts, for the
    kernel and for the host (None past the host's layers): the abs
    difference of its hidden stream from the card's plain one
    (accumulated), and the difference that layer alone makes when it starts
    from the card's plain stream (its own error at that layer, in the
    model); and the stream's largest magnitude."""
    torch = _torch()
    keys = ("diff", "one_layer_diff", "host_diff", "host_one_layer_diff", "scale")
    out = [dict({"layer": i}, **dict.fromkeys(keys, 0.0))
           for i in range(len(params["blocks"]))]
    with torch.no_grad():
        for prompt in prompts:
            x_k = x_r = params["embed"][torch.tensor(prompt, device=DEVICE)[None]]
            x_h = x_r.cpu()
            for i, lp in enumerate(params["blocks"]):
                one = block(lp, x_r, i, "kernel")
                x_k = block(lp, x_k, i, "kernel")
                x_next = block(lp, x_r, i, "ref")
                pairs = [("diff", x_k, x_next), ("one_layer_diff", one, x_next),
                         ("scale", x_next, 0.0)]
                if i < len(host_blocks):
                    one_h = block(host_blocks[i], x_r.cpu(), i, "ref")
                    x_h = block(host_blocks[i], x_h, i, "ref")
                    x_rh = x_next.cpu()
                    pairs += [("host_diff", x_h, x_rh), ("host_one_layer_diff", one_h, x_rh)]
                x_r = x_next
                for key, a, b in pairs:
                    out[i][key] = max(out[i][key], (a - b).abs().max().item())
    for ly in out[len(host_blocks):]:
        ly["host_diff"] = ly["host_one_layer_diff"] = None
    return out


def _rwkv_block(cfg):
    """``_layer_divergence``'s block for RWKV-6: a zero state per device."""
    from repro_torch.models import rwkv6
    zeros = {}

    def block(lp, x, i, attn_impl):
        if x.device.type not in zeros:
            zeros[x.device.type] = rwkv6.init_rwkv_state(cfg, 1, x.device)
        return rwkv6.block(lp, cfg, x, zeros[x.device.type].layer(i),
                           attn_impl=attn_impl)[0]
    return block


def _hybrid_block(cfg):
    """``_layer_divergence``'s block for the hybrid: an RG-LRU layer from a
    zero state (the scan kernel or the doubling scan), or an attention
    layer (plain ``attend`` on both paths, as in the model's prefill)."""
    from repro_torch.models import rglru, transformer
    kinds = transformer.layer_kinds(cfg)

    def block(lp, x, i, attn_impl):
        if kinds[i][0] == "attn":
            positions = _torch().arange(x.shape[1], dtype=_torch().int32,
                                        device=x.device)[None]
            return transformer._attn_block_apply(lp, cfg, x, positions, "ref")[0]
        zero = rglru.init_rglru_state(cfg, 1, x.device).layer(0)
        return transformer._rglru_block_apply(lp, cfg, x, zero, decode=False,
                                              attn_impl=attn_impl)[0]
    return block


def _to_host(tree):
    """A copy of a param tree on the host CPU."""
    from repro_torch.train.optimizer import tree_map
    return tree_map(lambda t: t.cpu(), tree)


def _tensors(cache) -> list:
    """Every tensor of a slot cache (the parts of a ``HybridCache`` too)."""
    torch = _torch()
    if torch.is_tensor(cache):
        return [cache]
    if hasattr(cache, "_asdict"):
        return [t for part in cache for t in _tensors(part)]
    return []


def _apply_logits(api, params, prompts, attn_impl) -> list:
    """Every position's logits of each prompt, from a zero state, on the
    host: one (prompt length, V) fp32 tensor per prompt."""
    torch = _torch()
    with torch.no_grad():
        return [api.apply(params, {"tokens": torch.tensor(p, device=api.device)[None]},
                          attn_impl=attn_impl)[0][0].cpu() for p in prompts]


def _max_diffs(xs, ys) -> list:
    return [(x - y).abs().max().item() for x, y in zip(xs, ys)]


def _wkv_f64(r, k, v, w, u, state):
    """The WKV recurrence in float64 on the card (``ref.py``'s plain version
    works in fp32)."""
    torch = _torch()
    rf, kf, vf, wf = (x.double() for x in (r, k, v, w))
    ud, s = u.double(), state.double()
    ys = []
    for t in range(rf.shape[1]):
        a = kf[:, t, :, :, None] * vf[:, t, :, None, :]
        ys.append(torch.einsum("bhi,bhij->bhj", rf[:, t], s + ud[..., None] * a))
        s = wf[:, t, :, :, None] * s + a
    return torch.stack(ys, dim=1), s


def _rglru_f64(a, b, h0):
    """The RG-LRU recurrence in float64 on the card."""
    torch = _torch()
    ad, bd, h = a.double(), b.double(), h0.double()
    hs = []
    for t in range(ad.shape[1]):
        h = ad[:, t] * h + bd[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1), h


def _scan_witness(api, params, prompts) -> list:
    """The float64 witness of each recurrent layer: every prompt's plain
    forward runs on the card with its scan's inputs captured layer by layer;
    each layer's recurrence is recomputed in float64 on the card, and the
    plain fp32 version (``ref.py``: the kernels' plain versions) and every
    route of the kernel (forced: step / direct and each chunk length) are
    held to it.  Per layer, the largest over the prompts of the max abs
    error of the outputs and the final state.  A route passes a layer when
    its error is at most ``WITNESS_FACTOR`` times the plain fp32 path's.
    For the hybrid the model's own plain scan (the doubling scan) is
    printed beside them."""
    torch = _torch()
    from repro_torch.kernels import rglru_scan as lru
    from repro_torch.kernels import rwkv6_scan as wkv
    from repro_torch.kernels.ref import rglru_scan_ref
    from repro_torch.models import rglru, rwkv6

    ssm = api.cfg.family == "ssm"
    layers: list = []
    calls = [0]                       # scan calls so far in this forward: the layer

    def record(outs, f64):
        i = calls[0]
        calls[0] += 1
        errs = {key: max((o.double() - x).abs().max().item() for o, x in zip(out, f64))
                for key, out in outs.items()}
        if i == len(layers):
            layers.append({"layer": i, **errs})
        else:
            layers[i] = {key: max(e, errs.get(key, e)) for key, e in layers[i].items()}

    if ssm:
        module, name = rwkv6, "rwkv6_scan_ref"
        real = rwkv6.rwkv6_scan_ref

        def shim(r, k, v, w, u, state):
            out = real(r, k, v, w, u, state)
            outs = {"plain": out}
            outs.update({route: wkv.run(r, k, v, w, u, state, route)
                         for route in ("step", "chunked")})
            record(outs, _wkv_f64(r, k, v, w, u, state))
            return out
    else:
        module, name = rglru, "doubling_scan"
        real = rglru.doubling_scan

        def shim(a, b, h0):
            hs = real(a, b, h0)
            chunks = sorted({16, 32, 64, lru.plan(*a.shape)[1]} - {0})
            outs = {"plain": rglru_scan_ref(a, b, h0), "doubling_scan": (hs, hs[:, -1])}
            outs.update({f"{route}{c or ''}": lru.run(a, b, h0, route, c)
                         for route, c in [("direct", 0)] + [("chunked", c) for c in chunks]})
            record(outs, _rglru_f64(a, b, h0))
            return hs
    setattr(module, name, shim)
    try:
        with torch.no_grad():
            for prompt in prompts:
                calls[0] = 0
                api.apply(params, {"tokens": torch.tensor(prompt, device=DEVICE)[None]},
                          attn_impl="ref")
    finally:
        setattr(module, name, real)
    return layers


def _slot_kernel_vs_ref(arch, api, params, prompts, max_new, phase=None) -> None:
    """The slot engine's kernel path against its plain one at full width:
    prefill and first decode logits, then greedy tokens through two engines
    sharing the weights.  Dense: a divergence is tolerated only at a top-2
    gap (plain forward) below ``DENSE_TOP2_TOL``.  RWKV-6 and the hybrid:
    the scan kernel's own error in each layer must stay within 1e-5 of the
    layer's scale and within the largest that the plain path on the host
    CPU (the witness: another reduction order, no kernel) makes in a layer
    (the hybrid's witness covers its first ``HYBRID_WITNESS_LAYERS``
    layers, and the kernel is held to it over those layers); the
    accumulated logit difference (prefill, first decode, every position of
    a forward) within ``RWKV_LOGIT_BOUND`` / ``HYBRID_LOGIT_BOUND``; a
    divergence is tolerated only at a top-2 gap below that bound; and the
    float64 witness of every recurrent layer (``_scan_witness``) holds
    each route of the scan kernel within ``WITNESS_FACTOR`` times the plain
    fp32 path's distance from float64."""
    torch = _torch()
    from repro_torch.models import transformer
    family = api.cfg.family
    ssm = family == "ssm"
    pk, dk, ck = _slot_first_logits(api, params, prompts, "kernel")
    pr, dr, cr = _slot_first_logits(api, params, prompts, "ref")
    diffs = {"prefill_logits": (pk - pr).abs().max().item(),
             "first_decode_logits": (dk - dr).abs().max().item(),
             "cache": max((a.float() - b.float()).abs().max().item()
                          for a, b in zip(_tensors(ck), _tensors(cr)))}
    del ck, cr
    layers = witness = None
    if family == "hybrid":
        # the witness at a cut depth: the first layers' plain path on the host
        host = [_to_host(lp) for lp in params["blocks"][:HYBRID_WITNESS_LAYERS]]
        layers = _layer_divergence(params, host, prompts, _hybrid_block(api.cfg))
        del host
        plain = _apply_logits(api, params, prompts, "ref")
        _zero_flash()
        kernel = _max_diffs(_apply_logits(api, params, prompts, "kernel"), plain)
        del plain
        # the forwards' attention layers run flash: one launch each a prompt
        n_attn = sum(kind == "attn" for kind, _ in transformer.layer_kinds(api.cfg))
        flash = _flash_counts()
        if flash != (n_attn * len(prompts), 0):
            raise AssertionError(f"{arch}: {flash} flash launches in the kernel path's "
                                 f"forwards, expected ({n_attn * len(prompts)}, 0)")
        diffs["logits"] = max(kernel)
        witness = {"host_layers": HYBRID_WITNESS_LAYERS, "flash_launches": list(flash),
                   "logits_per_prompt": {"kernel": kernel}}
    if ssm:
        # the witness: the plain path on the host CPU, another reduction
        # order with no kernel, against the plain path on the card
        from repro_torch.models import get_api
        host_api = get_api(api.cfg, device="cpu")
        host_params = _to_host(params)
        layers = _layer_divergence(params, host_params["blocks"], prompts,
                                   _rwkv_block(api.cfg))
        plain = _apply_logits(api, params, prompts, "ref")
        kernel = _max_diffs(_apply_logits(api, params, prompts, "kernel"), plain)
        host = _max_diffs(_apply_logits(host_api, host_params, prompts, "ref"), plain)
        del host_params, plain
        diffs["logits"] = max(kernel)

        # the last layer's accumulated difference over the largest
        # one-layer difference (None where no layer differs at all)
        def amplification(key):
            one = max(ly[f"{key}one_layer_diff"] for ly in layers)
            return layers[-1][f"{key}diff"] / one if one else None
        witness = {"logits_plain_host_vs_plain_card": max(host),
                   "logits_per_prompt": {"kernel": kernel, "host": host},
                   "kernel_amplification": amplification(""),
                   "host_amplification": amplification("host_")}
    tol = {"ssm": RWKV_LOGIT_BOUND, "hybrid": HYBRID_LOGIT_BOUND}.get(family,
                                                                     DENSE_TOP2_TOL)
    results = {impl: _slot_greedy(api, params, prompts, max_new, attn_impl=impl)
               for impl in ("kernel", "ref")}
    divergences = []
    for rid, prompt in enumerate(prompts):
        a, b = results["kernel"][rid][0], results["ref"][rid][0]
        if a != b:
            step = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
            gap = _top2_gap(api, params, list(prompt) + a[:step])
            divergences.append({"request": rid, "step": step, "top2_gap": gap})
    emit(phase or ("model_hybrid" if family == "hybrid" else "model_slot"), arch=arch,
         family=family, dtype="float32",
         check="kernel_vs_ref", layers=api.cfg.num_layers, d_model=api.cfg.d_model,
         max_abs_diff=diffs, requests=len(prompts), max_new_tokens=max_new,
         tokens_identical=not divergences, divergences=divergences,
         tolerated_top2_gap_below=tol, rounding_witness=witness,
         layer_divergence=layers)
    worst = {}
    if layers is not None:
        f64 = _scan_witness(api, params, prompts)
        kernel_keys = [k for k in f64[0] if k not in ("layer", "plain", "doubling_scan")]
        worst = {k: max(ly[k] / ly["plain"] for ly in f64) for k in kernel_keys}
        emit(phase or ("model_hybrid" if family == "hybrid" else "model_slot"), arch=arch,
             check="float64_witness", layers=len(f64), factor=WITNESS_FACTOR,
             worst_ratio_to_plain=worst, per_layer_max_abs_err_vs_float64=f64)
        want = (api.cfg.num_layers if ssm
                else sum(kind != "attn" for kind, _ in transformer.layer_kinds(api.cfg)))
        if len(f64) != want:
            raise AssertionError(f"{arch}: the float64 witness saw {len(f64)} of {want} "
                                 "recurrent layers")
    bad = [dv for dv in divergences if not dv["top2_gap"] < tol]
    if bad:
        raise AssertionError(f"{arch}: slot kernel and ref greedy tokens diverge: {bad}")
    if layers is None:
        return
    if not all(r <= WITNESS_FACTOR for r in worst.values()):
        raise AssertionError(f"{arch}: a scan route strays from float64 more than "
                             f"{WITNESS_FACTOR}x the plain fp32 path: {worst}")
    if any(not ly["one_layer_diff"] <= 1e-5 * ly["scale"] for ly in layers):
        raise AssertionError(f"{arch}: the scan kernel's error in a layer exceeds 1e-5 "
                             f"of its scale: {layers}")
    held = [ly for ly in layers if ly["host_one_layer_diff"] is not None]
    if not (max(ly["one_layer_diff"] for ly in held)
            <= max(ly["host_one_layer_diff"] for ly in held)):
        raise AssertionError(f"{arch}: the scan kernel's error in a layer exceeds what "
                             f"the plain path on the host makes: {layers}")
    if not max(diffs["prefill_logits"], diffs["first_decode_logits"],
               diffs["logits"]) <= tol:
        raise AssertionError(f"{arch}: kernel and ref logits differ by more than "
                             f"{tol}: {diffs}")


def phase_model_slot() -> None:
    """Full-width fp32: Qwen3-4B through two slot engines (``attn_impl``
    kernel and ref) and int8 quantize-on-sync against the off engine on
    fake-quantized weights; RWKV-6 3B kernel against ref."""
    import dataclasses
    import numpy as np
    torch = _torch()
    from repro_torch.configs import get_config
    from repro_torch.models import get_api
    from repro_torch.quant import dequantize_params, quantize_params

    max_new = 16
    for arch in (ARCH, RWKV_ARCH):
        cfg = dataclasses.replace(get_config(arch), dtype="float32")
        api = get_api(cfg, device=DEVICE)
        params = api.init(SEED)
        rng = np.random.default_rng(SEED + 50)
        prompts = [rng.integers(3, cfg.vocab_size, n).astype(np.int32)
                   for n in (40, 100, 180, 250)]
        _slot_kernel_vs_ref(arch, api, params, prompts, max_new)
        if arch == ARCH:
            quantized = _slot_greedy(api, params, prompts, max_new, quant_mode="int8")
            fake = dequantize_params(quantize_params(params, "int8"))
            offline = _slot_greedy(api, fake, prompts, max_new)
            del fake
            same = quantized == offline
            emit("model_slot", arch=arch, dtype="float32", check="quantize_on_sync",
                 quant_mode="int8", requests=len(prompts), max_new_tokens=max_new,
                 tokens_identical=same)
            if not same:
                raise AssertionError("slot quant_mode=int8: engine tokens differ from "
                                     "the off engine on fake-quantized weights")
        del params, api
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# serve: the main path
# ---------------------------------------------------------------------------

def _serve_tasks(vocab: int):
    import numpy as np
    from repro_torch.core.types import RolloutTask, next_uid
    rng = np.random.default_rng(SEED + 2)
    preamble = rng.integers(3, vocab, 128).astype(np.int32)
    tasks = []
    for i in range(12):
        n = int(rng.integers(64, 513))
        prompt = rng.integers(3, vocab, n).astype(np.int32)
        if i % 2 == 0 and n > 128:
            prompt = np.concatenate([preamble, prompt[128:]])
        meta = {"num_return_sequences": 4} if i == 5 else {}
        tasks.append(RolloutTask(task_id=next_uid(), prompt_id=i, replica_idx=0,
                                 prompt_tokens=prompt, max_new_tokens=MAX_NEW,
                                 meta=meta))
    return tasks


def _serve_run(eng, tasks, vocab: int, sync=None, counters=None) -> dict:
    """Serve ``tasks`` behind ``LLMProxy``; with ``sync``, once half the
    callbacks have fired: ``proxy.suspend()``, ``sync(proxy)``,
    ``proxy.resume()``.  Checks every result (and the page audit of a paged
    engine); returns the run's numbers.  ``counters``: {result key:
    (wrapper, attribute)} launch counts set to 0 just before the run and
    read right after it (default: the paged decode kernel's)."""
    import numpy as np
    from repro_torch.core.llm_proxy import LLMProxy
    from repro_torch.kernels.paged_decode_attention import paged_decode_attention

    if counters is None:
        counters = {"kernel_launches": (paged_decode_attention, "launches"),
                    "kernel_launches_int8": (paged_decode_attention, "launches_int8")}
    want = sum(int(t.meta.get("num_return_sequences", 1)) for t in tasks)
    lock = threading.Lock()
    done, half = threading.Event(), threading.Event()
    results, first_token_at, submitted_at = [], {}, {}

    def callback(res):
        with lock:
            results.append(res)
            if 2 * len(results) >= want:
                half.set()
            if len(results) == want:
                done.set()

    def stream_cb_for(rid):
        def cb(delta):
            first_token_at.setdefault(rid, time.perf_counter())
        return cb

    decode0, tokens0 = eng.total_decode_steps, eng.total_tokens_decoded
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    proxy = LLMProxy(eng, name="chip_smoke_proxy")
    sync_s = 0.0
    t0 = time.perf_counter()
    proxy.start()
    try:
        for t in tasks:
            submitted_at[t.task_id] = time.perf_counter()
            grouped = "num_return_sequences" in t.meta
            proxy.generate(t, version=0, callback=callback,
                           stream_cb=None if grouped else stream_cb_for(t.task_id))
        if sync is not None:
            if not half.wait(timeout=300):
                raise AssertionError(f"serve: {len(results)}/{want} callbacks fired "
                                     "before the weight sync")
            s0 = time.perf_counter()
            proxy.suspend()
            sync(proxy)
            proxy.resume()
            sync_s = time.perf_counter() - s0
        finished = done.wait(timeout=300)
        wall = time.perf_counter() - t0
    finally:
        proxy.stop()
    launches = {key: getattr(fn, attr) for key, (fn, attr) in counters.items()}
    if not finished:
        raise AssertionError(f"serve: {len(results)}/{want} callbacks fired")
    decode_steps = eng.total_decode_steps - decode0
    for res in results:
        toks, lps = np.asarray(res.tokens), np.asarray(res.logprobs)
        if res.aborted or toks.shape != (MAX_NEW,) or not np.isfinite(lps).all() \
                or (lps > 0).any() or (toks < 0).any() or (toks >= vocab).any():
            raise AssertionError(f"serve: bad result for request {res.request_id}")
    ttft = sorted(first_token_at[r] - submitted_at[r] for r in first_token_at)
    decoded = eng.total_tokens_decoded - tokens0
    steps = proxy.steps_executed
    out = dict(requests=want, callbacks=len(results), results=results,
               prompt_tokens=int(sum(len(t.prompt_tokens) for t in tasks)))
    if hasattr(eng, "audit_pages"):
        eng.audit_pages()
        out.update(prefill_tokens=eng.total_prefill_tokens,
                   cache_hit_tokens=eng.cache_hit_tokens,
                   groups_forked=eng.total_groups_forked,
                   peak_pages_in_use=eng.peak_pages_in_use, audit_pages="clean")
    first = next(iter(launches))
    out.update(
        wall_s=wall, sync_s=sync_s, engine_steps=steps, decode_steps=decode_steps,
        decoded_tokens=decoded, decode_tokens_per_s=decoded / (wall - sync_s),
        mean_step_ms=1e3 * (wall - sync_s) / max(1, steps),
        ttft_s_median=ttft[len(ttft) // 2], ttft_s_max=ttft[-1], **launches,
        kernel_launches_per_decode_step=launches[first] / max(1, decode_steps))
    return out


def _warm(eng) -> None:
    """Warm-up outside the measured run: cuBLAS handles, the kernel's load."""
    import numpy as np
    eng.add_request(-1, np.arange(3, 35, dtype=np.int32), 4)
    _drain(eng, 1)


def phase_serve(kernel_row: dict) -> dict:
    """The slice-1 main path, bf16.  Returns {api, params, bf16 tree bytes
    measured as the allocation delta of ``api.init``} for ``serve_quant``
    (a dict, so that the next phase can drop the last reference)."""
    torch = _torch()
    from repro_torch.configs import get_config
    from repro_torch.models import get_api
    from repro_torch.rollout import PagedDecodeEngine

    cfg = get_config(ARCH)
    api = get_api(cfg, device=DEVICE)
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    params = api.init(SEED)
    torch.cuda.synchronize()
    bf16_bytes = torch.cuda.memory_allocated() - m0
    eng = PagedDecodeEngine(api, params, prefix_cache=True, temperature=1.0,
                            eos_id=-1, seed=SEED, device=DEVICE, **SERVE)
    _warm(eng)
    run = _serve_run(eng, _serve_tasks(cfg.vocab_size), cfg.vocab_size)
    run.pop("results")
    kernel_row["launches"] = run["kernel_launches"]
    if run["kernel_launches_int8"] or run["kernel_launches"] != cfg.num_layers * run[
            "decode_steps"] or not run["kernel_launches"]:
        raise AssertionError(f"serve: {run['kernel_launches']} kernel launches "
                             f"({run['kernel_launches_int8']} int8) for "
                             f"{run['decode_steps']} decode steps x {cfg.num_layers} layers")
    emit("serve", arch=ARCH, dtype=cfg.dtype, **run)
    _profile_decode(eng)
    del eng
    torch.cuda.empty_cache()
    return {"api": api, "params": params, "bf16_bytes": bf16_bytes}


def phase_serve_quant(kernel_row: dict, shared: dict) -> None:
    """Quantized rollouts on the main path: int8 weights quantized at every
    sync, an int8 KV pool, a weight sync mid-run."""
    torch = _torch()
    from repro_torch.quant import dequantize_params, quantize_params
    from repro_torch.rollout import PagedDecodeEngine

    api, bf16_bytes = shared["api"], shared["bf16_bytes"]
    params = shared.pop("params")
    cfg = api.cfg
    # held weights: the quantized tree keeps the fp islands (embed,
    # lm_head, norms) as the same tensors; freeing the bf16 originals of
    # the quantized leaves leaves islands + codes + scales
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    qparams = quantize_params(params, "int8")
    del params
    torch.cuda.empty_cache()
    held_bytes = bf16_bytes + torch.cuda.memory_allocated() - m0
    m1 = torch.cuda.memory_allocated()
    eng = PagedDecodeEngine(api, qparams, quant_mode="int8", kv_quant="int8",
                            prefix_cache=True, temperature=1.0, eos_id=-1, seed=SEED,
                            device=DEVICE, **SERVE)
    pool_bytes = torch.cuda.memory_allocated() - m1
    del qparams
    pool_tokens = eng.num_pages * eng.page_size
    bf16_token = 2 * cfg.num_layers * cfg.num_kv_heads * cfg.resolved_head_dim * 2
    _warm(eng)

    def sync(proxy):
        new = api.init(SEED + 1)          # the trainer's next policy, bf16
        proxy.update_weights(new)

    syncs0 = eng.total_weight_syncs_quantized
    run = _serve_run(eng, _serve_tasks(cfg.vocab_size), cfg.vocab_size, sync=sync)
    torch.cuda.empty_cache()
    results = run.pop("results")
    kernel_row["launches"] = run["kernel_launches_int8"]
    syncs = eng.total_weight_syncs_quantized - syncs0
    if syncs != 1:
        raise AssertionError(f"serve_quant: {syncs} quantized weight syncs, expected 1")
    if not run["kernel_launches_int8"] or run["kernel_launches"] != run[
            "kernel_launches_int8"] or run["kernel_launches_int8"] != (
            cfg.num_layers * run["decode_steps"]):
        raise AssertionError(f"serve_quant: {run['kernel_launches_int8']} int8 kernel "
                             f"launches ({run['kernel_launches']} in all) for "
                             f"{run['decode_steps']} decode steps x {cfg.num_layers} layers")
    stamps = {(r.task.meta.get("quant_mode"), r.task.meta.get("kv_quant")) for r in results}
    if stamps != {("int8", "int8")}:
        raise AssertionError(f"serve_quant: meta stamps {stamps}")
    emit("serve_quant", arch=ARCH, dtype=cfg.dtype, quant_mode="int8", kv_quant="int8",
         weight_syncs_quantized=syncs, meta_stamps="int8/int8", **run,
         held_weight_bytes=held_bytes, bf16_weight_bytes=bf16_bytes,
         weight_bytes_ratio=held_bytes / bf16_bytes, kv_pool_bytes=pool_bytes,
         kv_bytes_per_token=pool_bytes / pool_tokens, kv_bytes_per_token_bf16=bf16_token,
         kv_bytes_ratio=pool_bytes / pool_tokens / bf16_token)
    busy_ms = _profile_decode(eng, phase="profile_quant")
    # the device time of one forward's per-layer dequantization
    blocks = eng.params["blocks"]

    def dequantize_all():
        for lp in blocks:             # one layer alive at a time, as in the forwards
            dequantize_params(lp)

    dequantize_all()
    dequant_ms, _, dequant_launches, _, _ = _device_busy(dequantize_all, 3)
    emit("profile_quant", dequant_device_ms_per_forward=dequant_ms,
         dequant_launches_per_forward=dequant_launches,
         dequant_share_of_device_busy=dequant_ms / busy_ms,
         note="decode-only steps run one forward each; device time from torch.profiler")
    del eng, blocks
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# serve_slot / serve_rwkv / passk: the slot engine's main paths (slice 4)
# ---------------------------------------------------------------------------

def phase_serve_slot(kernel_row: dict, arch: str, kernel: str, phase=None, gpu=None,
                     launches_key: str = "launches"):
    """A slice-4 main path, bf16, full width and depth: ``LLMProxy`` over
    the slot ``DecodeEngine`` (16 slots, ``max_total_len`` 1024, prefill
    bucket 16 for dense prompts, exact length for RWKV-6, temperature 1.0)
    serving the seeded ``serve`` task mix.  Exact kernel launch counts,
    written to ``kernel_row[launches_key]``; then a profiled decode window
    (``profile_slot``, or ``profile_*`` after ``phase``'s name).
    ``kernel``: the wrapper whose launches the path must make.  Returns
    (api, params) for ``passk``."""
    torch = _torch()
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan
    from repro_torch.models import get_api
    from repro_torch.rollout import DecodeEngine

    cfg = get_config(arch)
    api = get_api(cfg, device=DEVICE)
    params = api.init(SEED)
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    eng = DecodeEngine(api, params, temperature=1.0, eos_id=-1, seed=SEED,
                       device=DEVICE, **SERVE_SLOT)
    torch.cuda.synchronize()
    cache_bytes = torch.cuda.memory_allocated() - m0
    _warm(eng)
    wrapper = {"decode_attention": decode_attention, "rwkv6_scan": rwkv6_scan}[kernel]
    counters = {"kernel_launches": (wrapper, "launches"),
                "decode_attention_launches": (decode_attention, "launches"),
                "rwkv6_scan_launches": (rwkv6_scan, "launches"),
                "rwkv6_scan_chunked_launches": (rwkv6_scan, "launches_chunked")}
    tasks = _serve_tasks(cfg.vocab_size)
    run = _serve_run(eng, tasks, cfg.vocab_size, counters=counters)
    run.pop("results")
    prefills = len(tasks) + sum(int(t.meta.get("num_return_sequences", 1)) - 1
                                for t in tasks)
    # dense: one decode-attention launch per layer and decode step (prefill
    # runs plain attention); RWKV-6: one scan per layer and forward
    want = cfg.num_layers * (run["decode_steps"]
                             + (prefills if kernel == "rwkv6_scan" else 0))
    other = ("rwkv6_scan_launches" if kernel == "decode_attention"
             else "decode_attention_launches")
    kernel_row[launches_key] = run["kernel_launches"]
    # RWKV-6: every prompt of the mix (64-512 tokens) takes the chunked route
    want_chunked = cfg.num_layers * prefills if kernel == "rwkv6_scan" else 0
    if (run["kernel_launches"] != want or run[other] or not want
            or run["rwkv6_scan_chunked_launches"] != want_chunked):
        raise AssertionError(f"{arch}: {run['kernel_launches']} {kernel} launches "
                             f"({run[other]} {other}, "
                             f"{run['rwkv6_scan_chunked_launches']} chunked), expected {want} "
                             f"({want_chunked} chunked): {run['decode_steps']} decode steps, "
                             f"{prefills} prefills, {cfg.num_layers} layers")
    extra = {}
    if cfg.family == "ssm":
        extra["state_bytes_per_slot"] = cache_bytes / SERVE_SLOT["num_slots"]
    else:
        extra["kv_cache_bytes"] = cache_bytes
    if cfg.family == "vlm":
        extra["cache_slots"] = eng.cache.k.shape[2]
    if gpu is not None:
        extra["gpu"] = gpu
    phase = phase or ("serve_rwkv" if cfg.family == "ssm" else "serve_slot")
    emit(phase, arch=arch,
         dtype=cfg.dtype, family=cfg.family, engine="DecodeEngine", prefills=prefills,
         expected_launches=want, expected_chunked_launches=want_chunked, **run, **extra)
    profile = ("profile_slot" if phase in ("serve_slot", "serve_rwkv")
               else phase.replace("serve_", "profile_"))
    _profile_decode(eng, phase=profile,
                    kernel="wkv_kernel" if kernel == "rwkv6_scan" else "decode_kernel",
                    arch=arch, engine="DecodeEngine")
    del eng
    torch.cuda.empty_cache()
    return api, params


def phase_passk(api, params) -> None:
    """``evaluate_passk`` through the port's slot engine on full-width bf16
    Qwen3-4B: 16 prompts x 4 candidates, 6 new tokens, ``max_total_len``
    32.  With random weights pass@k is about 0: the call proves the entry
    point runs on the card, with exactly one decode-kernel launch per layer
    and decode step of its engine (``EvalResult.decode_steps``)."""
    torch = _torch()
    from repro_torch.eval import evaluate_passk
    from repro_torch.kernels.decode_attention import decode_attention

    kw = dict(num_slots=16, max_total_len=32, temperature=1.0, seed=SEED)
    decode_attention.launches = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        res = evaluate_passk(api, params, num_prompts=16, n_per_prompt=4, ks=(1, 4),
                             max_new_tokens=6, device=DEVICE, **kw)
    wall = time.perf_counter() - t0
    launches = decode_attention.launches
    layers, steps = api.cfg.num_layers, res.decode_steps
    emit("passk", arch=ARCH, dtype=api.cfg.dtype, num_prompts=res.num_prompts,
         n_per_prompt=res.n_per_prompt, pass_at_1=res.pass_at_1,
         pass_at_k=res.pass_at_k, wall_s=wall, decode_steps=steps,
         decode_attention_launches=launches)
    if launches != layers * steps or not steps:
        raise AssertionError(f"passk: {launches} decode-attention launches for {steps} "
                             f"decode steps x {layers} layers")
    if not (0.0 <= res.pass_at_1 <= 1.0 and res.num_prompts == 16):
        raise AssertionError(f"passk: bad result {res}")


# ---------------------------------------------------------------------------
# model_hybrid / serve_hybrid: RecurrentGemma-9B through the slot engine
# (slice 5)
# ---------------------------------------------------------------------------

def _perturb_hybrid(params, seed: int) -> None:
    """Redraw ``lam``, ``ba``, ``bi`` and ``conv_b`` of every RG-LRU layer
    (in place) so that the recurrence carries state: the init's lam = 2
    gives a = exp(-8 softplus(2) r) ~ 2e-4, and the scan's carry would go
    unchecked.  lam ~ U(-8, -1) puts a between ~0.3 and ~0.999 at r = 0.5;
    ba, bi ~ N(0, 0.5); conv_b ~ N(0, 0.1)."""
    torch = _torch()
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    for lp in params["blocks"]:
        rec = lp.get("rec")
        if rec is None:
            continue
        w = rec["lam"].shape[0]
        draw = lambda: torch.randn(w, generator=gen, device=DEVICE)  # noqa: E731
        rec["lam"] = torch.rand(w, generator=gen, device=DEVICE) * 7.0 - 8.0
        rec["ba"] = draw() * 0.5
        rec["bi"] = draw() * 0.5
        rec["conv_b"] = (draw() * 0.1).to(rec["conv_b"].dtype)


def phase_model_hybrid() -> None:
    """Full-width, full-depth fp32 RecurrentGemma-9B (41.8 GB of weights),
    its recurrence's gates perturbed: two slot engines sharing the
    weights, ``attn_impl`` kernel and ref (``_slot_kernel_vs_ref``: greedy
    tokens, per-layer scan error against the host witness, logits within
    ``HYBRID_LOGIT_BOUND``); then int8 quantize-on-sync against the off
    engine on weights quantized and dequantized up front, in the
    reference's scale groups (the tail unquantized).  The fake-quantized
    tree replaces the weights layer by layer: two fp32 trees would not fit
    beside the int8 codes."""
    import dataclasses
    import numpy as np
    torch = _torch()
    from repro_torch.configs import get_config
    from repro_torch.models import get_api, transformer
    from repro_torch.quant import dequantize_params, is_quantized_tree, quantize_params

    cfg = dataclasses.replace(get_config(HYBRID_ARCH), dtype="float32")
    api = get_api(cfg, device=DEVICE)
    params = api.init(SEED)
    _perturb_hybrid(params, SEED + 61)
    rng = np.random.default_rng(SEED + 50)
    prompts = [rng.integers(3, cfg.vocab_size, n).astype(np.int32)
               for n in (40, 100, 180, 250)]
    max_new = 16
    _slot_kernel_vs_ref(HYBRID_ARCH, api, params, prompts, max_new)
    torch.cuda.empty_cache()

    quantized = _slot_greedy(api, params, prompts, max_new, quant_mode="int8")
    torch.cuda.empty_cache()
    groups = transformer.block_groups(cfg)
    q = quantize_params(params, "int8", groups=groups)
    tail = [i for i, g in enumerate(groups) if g is None]
    if any(q["blocks"][i] is not params["blocks"][i] for i in tail) or not all(
            is_quantized_tree(q["blocks"][i]) for i, g in enumerate(groups) if g is not None):
        raise AssertionError("model_hybrid: the tail must stay unquantized and every "
                             "layer of a scale group quantized")
    for i in range(len(params["blocks"])):
        params["blocks"][i] = dequantize_params(q["blocks"][i])
        q["blocks"][i] = None
    del q
    torch.cuda.empty_cache()
    offline = _slot_greedy(api, params, prompts, max_new)
    same = quantized == offline
    emit("model_hybrid", arch=HYBRID_ARCH, dtype="float32", check="quantize_on_sync",
         quant_mode="int8", scale_groups=len(cfg.block_pattern), tail_unquantized=len(tail),
         requests=len(prompts), max_new_tokens=max_new, tokens_identical=same)
    if not same:
        raise AssertionError("hybrid quant_mode=int8: engine tokens differ from the off "
                             "engine on fake-quantized weights")
    del params, api
    torch.cuda.empty_cache()


def phase_serve_hybrid(scan_row: dict, decode_row: dict) -> None:
    """The slice-5 main path, bf16, full width and depth: RecurrentGemma-9B
    behind ``LLMProxy`` over the slot ``DecodeEngine`` (16 slots,
    ``max_total_len`` 1024, exact-length prefill, temperature 1.0), its
    gates perturbed as in ``model_hybrid``, serving the seeded ``serve``
    task mix.  Exact launch counts: decode attention once per attention
    layer and decode step, the RG-LRU scan once per RG-LRU layer and
    forward (prefills and decode steps); then ``profile_slot``."""
    torch = _torch()
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.rglru_scan import rglru_scan
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan
    from repro_torch.models import get_api, transformer
    from repro_torch.rollout import DecodeEngine

    cfg = get_config(HYBRID_ARCH)
    api = get_api(cfg, device=DEVICE)
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    params = api.init(SEED)
    _perturb_hybrid(params, SEED + 61)
    torch.cuda.synchronize()
    weight_bytes = torch.cuda.memory_allocated() - m0
    eng = DecodeEngine(api, params, temperature=1.0, eos_id=-1, seed=SEED,
                       device=DEVICE, **SERVE_SLOT)
    kv_bytes = sum(t.numel() * t.element_size() for t in _tensors(eng.cache.kv))
    state_bytes = sum(t.numel() * t.element_size() for t in _tensors(eng.cache.rglru))
    _warm(eng)
    counters = {"kernel_launches": (rglru_scan, "launches"),
                "rglru_scan_chunked_launches": (rglru_scan, "launches_chunked"),
                "decode_attention_launches": (decode_attention, "launches"),
                "rwkv6_scan_launches": (rwkv6_scan, "launches")}
    tasks = _serve_tasks(cfg.vocab_size)
    run = _serve_run(eng, tasks, cfg.vocab_size, counters=counters)
    run.pop("results")
    prefills = len(tasks) + sum(int(t.meta.get("num_return_sequences", 1)) - 1
                                for t in tasks)
    kinds = transformer.layer_kinds(cfg)
    n_attn = sum(k == "attn" for k, _ in kinds)
    n_rglru = len(kinds) - n_attn
    want_scan = n_rglru * (prefills + run["decode_steps"])
    want_decode = n_attn * run["decode_steps"]
    # every prompt of the mix (64-512 tokens) takes the chunked route
    want_chunked = n_rglru * prefills
    scan_row["launches"] = run["kernel_launches"]
    decode_row["hybrid_launches"] = run["decode_attention_launches"]
    if (run["kernel_launches"] != want_scan or run["decode_attention_launches"] != want_decode
            or run["rglru_scan_chunked_launches"] != want_chunked
            or run["rwkv6_scan_launches"] or not run["decode_steps"]):
        raise AssertionError(f"serve_hybrid: {run['kernel_launches']} scan launches "
                             f"(expected {want_scan}; "
                             f"{run['rglru_scan_chunked_launches']} chunked, expected "
                             f"{want_chunked}), {run['decode_attention_launches']} "
                             f"decode-attention launches (expected {want_decode}): "
                             f"{run['decode_steps']} decode steps, {prefills} prefills, "
                             f"{n_rglru} RG-LRU and {n_attn} attention layers")
    emit("serve_hybrid", arch=HYBRID_ARCH, dtype=cfg.dtype, family=cfg.family,
         engine="DecodeEngine", layers={"rglru": n_rglru, "attn": n_attn},
         prefills=prefills, expected_launches={"rglru_scan": want_scan,
                                               "rglru_scan_chunked": want_chunked,
                                               "decode_attention": want_decode},
         **run, weight_bytes=weight_bytes, kv_cache_bytes=kv_bytes,
         rglru_state_bytes_per_slot=state_bytes / SERVE_SLOT["num_slots"])
    _profile_decode(eng, phase="profile_slot", kernel=("rglru_kernel", "decode_kernel"),
                    arch=HYBRID_ARCH, engine="DecodeEngine")
    del eng, params, api
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# train: the GRPO trainer on engine rollouts (Qwen3-1.7B)
# ---------------------------------------------------------------------------

def _train_batch(vocab: int, rng, logprobs=None):
    """4 rows of 512 tokens, 64 response tokens each at staggered offsets,
    two rewarded; old/prox/ref log-probs are ``logprobs(tokens)`` (zeros
    without) plus seeded noise."""
    torch = _torch()
    b, s = 4, 512
    tokens = torch.from_numpy(rng.integers(3, vocab, (b, s)).astype("int32")).to(DEVICE)
    mask = torch.zeros(b, s, device=DEVICE)
    for i, lo in enumerate((128, 200, 256, 384)):
        mask[i, lo:lo + 64] = 1.0
    lp = logprobs(tokens) if logprobs else torch.zeros(b, s, device=DEVICE)
    noise = torch.from_numpy(rng.normal(scale=0.1, size=(3, b, s)).astype("float32")).to(DEVICE)
    rewards = torch.tensor([1.0, 0.0, 1.0, 0.0], device=DEVICE)
    return {"tokens": tokens, "mask": mask,
            "advantages": (rewards - 0.5)[:, None] * 2 * mask,
            "old_logprobs": (lp + noise[0]) * mask, "prox_logprobs": (lp + noise[1]) * mask,
            "ref_logprobs": (lp + noise[2]) * mask, "is_positive": rewards}


def phase_model_danube() -> None:
    """H2O-Danube-3-4B at full width (d_model 3840, 32 heads over 8 KV heads
    of head_dim 120, d_ff 10240, vocab 32000, window 4096), cut to 4 layers:
    head_dim 120 through every attention kernel on an entry point.  fp32:
    4 requests through ``PagedDecodeEngine`` (an fp32 and an int8 KV pool)
    and through the slot ``DecodeEngine``, ``attn_impl`` kernel against
    ref, greedy tokens identical but at a top-2 gap below
    ``DENSE_TOP2_TOL``.  bf16: one ``make_train_step`` through the flash
    kernels: a finite loss and grad norm, exactly one forward and one
    backward launch per layer."""
    import dataclasses
    import numpy as np
    torch = _torch()
    from repro_torch.algos import LossConfig
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import get_api
    from repro_torch.train import OptConfig, make_train_step
    from repro_torch.train.optimizer import init_opt_state

    cfg = dataclasses.replace(get_config(DANUBE_ARCH), dtype="float32",
                              num_layers=DANUBE_LAYERS)
    api = get_api(cfg, device=DEVICE)
    params = api.init(SEED)
    rng = np.random.default_rng(SEED + 70)
    prompts = [rng.integers(3, cfg.vocab_size, n).astype(np.int32)
               for n in (40, 100, 180, 250)]
    max_new = 16
    for kv_quant in ("off", "int8"):
        _kernel_vs_ref(api, params, prompts, kv_quant, max_new, phase="model_danube")
    _slot_kernel_vs_ref(DANUBE_ARCH, api, params, prompts, max_new, phase="model_danube")
    del params, api
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    api = get_api(cfg, device=DEVICE)
    params = api.init(SEED)
    batch = _train_batch(cfg.vocab_size, rng)
    step = make_train_step(api, LossConfig(pg_variant="decoupled_ppo", kl_beta=1e-3),
                           OptConfig(learning_rate=1e-3, warmup_steps=2), remat=False,
                           attn_impl="kernel")
    fa.flash_attention.launches_fwd = fa.flash_attention.launches_bwd = 0
    state, metrics = step({"params": params, "opt": init_opt_state(params)}, batch)
    torch.cuda.synchronize()
    launches = (fa.flash_attention.launches_fwd, fa.flash_attention.launches_bwd)
    loss, grad_norm = float(metrics["loss"]), float(metrics["grad_norm"])
    emit("model_danube", arch=DANUBE_ARCH, dtype="bfloat16", layers=cfg.num_layers,
         d_model=cfg.d_model, head_dim=cfg.resolved_head_dim, check="train_step",
         batch=list(batch["tokens"].shape), loss=loss, grad_norm=grad_norm,
         flash_launches=list(launches))
    if launches != (cfg.num_layers, cfg.num_layers):
        raise AssertionError(f"model_danube: flash launches {launches}, expected "
                             f"{(cfg.num_layers, cfg.num_layers)}")
    if not (np.isfinite(loss) and np.isfinite(grad_norm) and grad_norm > 0):
        raise AssertionError(f"model_danube: loss {loss}, grad norm {grad_norm}")
    del params, state, api
    torch.cuda.empty_cache()


def _rel_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def phase_train_model() -> None:
    """fp32, full-width Qwen3-1.7B cut to 4 layers: one train step with
    ``attn_impl="kernel"`` against ``"ref"`` from the same params and batch.
    The optimizer's eps is 1e-3 here, as in tests/test_torch_trainer.py:
    Adam divides each gradient by its own size, and a larger eps keeps the
    reduction-order noise of near-zero gradients out of the params."""
    import dataclasses
    import numpy as np
    torch = _torch()
    from repro_torch.algos import LossConfig
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import get_api
    from repro_torch.train import OptConfig, make_logprob_fn, make_train_step
    from repro_torch.train.optimizer import init_opt_state, tree_leaves

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), dtype="float32", num_layers=4)
    api = get_api(cfg, device=DEVICE)
    params = api.init(SEED)
    rng = np.random.default_rng(SEED + 20)
    logprob_fn = make_logprob_fn(api, attn_impl="ref")
    batch = _train_batch(cfg.vocab_size, rng,
                         lambda tokens: logprob_fn(params, {"tokens": tokens}))
    b, s = batch["tokens"].shape
    loss_cfg = LossConfig(pg_variant="decoupled_ppo", kl_beta=1e-3)
    opt_cfg = OptConfig(learning_rate=1e-2, warmup_steps=2, weight_decay=0.1, eps=1e-3)
    out = {}
    for impl in ("kernel", "ref"):
        fa.flash_attention.launches_fwd = fa.flash_attention.launches_bwd = 0
        state = {"params": params,
                 "opt": init_opt_state(params)}
        step = make_train_step(api, loss_cfg, opt_cfg, remat=False, attn_impl=impl)
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        out[impl] = (state, metrics, fa.flash_attention.launches_fwd,
                     fa.flash_attention.launches_bwd)
        del state
        torch.cuda.empty_cache()
    (ks, km, kf, kb), (rs, rm, rf, rb) = out["kernel"], out["ref"]
    if (kf, kb) != (cfg.num_layers, cfg.num_layers) or (rf, rb) != (0, 0):
        raise AssertionError(f"train_model: flash launches kernel {kf}/{kb}, ref {rf}/{rb}")
    tol = 1e-5
    checks = {k: abs(float(km[k]) - float(rm[k])) / max(abs(float(rm[k])), 1e-12)
              for k in ("loss", "grad_norm", "ratio_mean", "kl")}
    params_err = max(_rel_err(a, b) for a, b in zip(tree_leaves(ks["params"]),
                                                    tree_leaves(rs["params"])))
    grads_err = max(_rel_err(a, b) for a, b in zip(tree_leaves(ks["opt"]["m"]),
                                                   tree_leaves(rs["opt"]["m"])))
    moved = max(_rel_err(a, b) for a, b in zip(tree_leaves(ks["params"]), tree_leaves(params)))
    emit("train_model", arch=TRAIN_ARCH, dtype="float32", layers=cfg.num_layers,
         d_model=cfg.d_model, batch=[b, s], check="kernel_vs_ref",
         loss=float(km["loss"]), grad_norm=float(km["grad_norm"]), rel_err=checks,
         params_rel_err_max=params_err, grads_rel_err_max=grads_err,
         params_moved_rel=moved, tol_rel=tol,
         flash_launches={"kernel": [kf, kb], "ref": [rf, rb]})
    bad = {k: v for k, v in checks.items() if not v <= tol}
    if bad or not params_err <= tol or not moved > 100 * tol:
        raise AssertionError(f"train_model: kernel vs ref {bad}, params {params_err}, "
                             f"moved {moved}")
    del out, ks, rs
    torch.cuda.empty_cache()
    _remat_check(api, params, batch, loss_cfg, tol)
    del params
    torch.cuda.empty_cache()


def _remat_check(api, params, batch, loss_cfg, tol: float) -> None:
    """The kernel route's loss and gradients with layer remat (non-reentrant
    ``torch.utils.checkpoint`` around each block) against without, on the
    same params and batch: equal within ``tol``, two flash forwards a
    layer (the forward, and its recompute in the backward) against one,
    and a lower peak of the bytes the loss and gradient allocate."""
    torch = _torch()
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.trainer import make_loss_and_grad

    layers = api.cfg.num_layers
    out = {}
    for remat in (False, True):
        fn = make_loss_and_grad(api, loss_cfg, attn_impl="kernel", remat=remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fa.flash_attention.launches_fwd = fa.flash_attention.launches_bwd = 0
        loss, _, grads = fn(params, batch)
        torch.cuda.synchronize()
        out[remat] = (float(loss), tree_leaves(grads), torch.cuda.max_memory_allocated() - base,
                      (fa.flash_attention.launches_fwd, fa.flash_attention.launches_bwd))
    (l0, g0, p0, n0), (l1, g1, p1, n1) = out[False], out[True]
    loss_err = abs(l1 - l0) / max(abs(l0), 1e-12)
    grads_err = max(_rel_err(a, b) for a, b in zip(g1, g0))
    emit("train_model", check="remat_vs_none", layers=layers, loss=l1,
         loss_rel_err=loss_err, grads_rel_err_max=grads_err, tol_rel=tol,
         peak_bytes={"none": int(p0), "remat": int(p1)}, peak_ratio=p1 / p0,
         flash_launches={"none": list(n0), "remat": list(n1)})
    if n0 != (layers, layers) or n1 != (2 * layers, layers):
        raise AssertionError(f"train_model: remat flash launches {n1}, none {n0}")
    if not (loss_err <= tol and grads_err <= tol and p1 < p0):
        raise AssertionError(f"train_model: remat loss {loss_err}, grads {grads_err}, "
                             f"peak {p1} vs {p0}")


def _train_tasks(vocab: int, round_: int):
    """4 prompts of 128-384 tokens, each as a group of 4 replicas."""
    import numpy as np
    from repro_torch.core.types import RolloutTask, next_uid
    rng = np.random.default_rng(SEED + 100 + round_)
    groups = []
    for i in range(TRAIN["prompts"]):
        prompt = rng.integers(3, vocab, int(rng.integers(128, 385))).astype(np.int32)
        gid = round_ * TRAIN["prompts"] + i
        groups.append([RolloutTask(task_id=next_uid(), prompt_id=gid, replica_idx=j,
                                   prompt_tokens=prompt, max_new_tokens=TRAIN["max_new"],
                                   group_id=gid)
                       for j in range(TRAIN["group"])])
    return groups


def _rollouts(proxy, groups, version: int) -> list:
    """Submit every group, wait for all callbacks, return GenerationResults."""
    lock, done, results = threading.Lock(), threading.Event(), []
    want = sum(len(g) for g in groups)

    def callback(res):
        with lock:
            results.append(res)
            if len(results) == want:
                done.set()

    for g in groups:
        proxy.generate_group(g, version, callback)
    if not done.wait(timeout=600):
        raise AssertionError(f"train: {len(results)}/{want} rollouts came back")
    return results


def _to_samples(results, vocab: int):
    """GenerationResults -> Samples.  The pipeline's RolloutProducer and
    verifier are a later slice of the port; here a seeded synthetic reward
    scores each response: 1 when more than half its tokens are even."""
    import numpy as np
    from repro_torch.core.types import Sample
    samples = []
    for res in sorted(results, key=lambda r: r.request_id):
        toks, lps = np.asarray(res.tokens), np.asarray(res.logprobs)
        if res.aborted or toks.shape != (TRAIN["max_new"],) or not np.isfinite(lps).all() \
                or (toks < 0).any() or (toks >= vocab).any():
            raise AssertionError(f"train: bad rollout {res.request_id}")
        t = res.task
        samples.append(Sample(sample_id=res.request_id, prompt_id=t.prompt_id,
                              replica_idx=t.replica_idx, prompt_tokens=t.prompt_tokens,
                              response_tokens=toks, logprobs=lps,
                              reward=float(np.mean(toks % 2 == 0) > 0.5),
                              version_started=res.version_started,
                              version_finished=res.version_started, group_id=t.group_id))
    return samples


def _engine_logits(api, params, prompt):
    """Next-token logits after ``prompt`` through the engine's own paged
    prefill, on a pool of its own, with the weights the engine holds."""
    torch = _torch()
    ps = 16
    n = -(-len(prompt) // ps)
    cache = api.init_paged_cache(1 + n, ps)
    row = torch.arange(1, 1 + n, dtype=torch.int32, device=DEVICE)
    with torch.no_grad():
        for lo in range(0, len(prompt), 128):
            chunk = torch.tensor(prompt[lo:lo + 128], device=DEVICE)[None]
            logits, cache = api.prefill_chunk(params, chunk,
                                              torch.ones_like(chunk, dtype=torch.bool),
                                              lo, row, cache)
    return logits[0].float()


def phase_train() -> dict:
    """The slice-3 main path, bf16, full width and depth: a PagedDecodeEngine
    behind LLMProxy serves rollouts of the trainer's weights, HostTrainer
    trains on them, and the new weights go back to the engine, 3 times."""
    import numpy as np
    torch = _torch()
    from repro_torch.algos import LossConfig
    from repro_torch.configs import get_config
    from repro_torch.core.llm_proxy import LLMProxy
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.paged_decode_attention import paged_decode_attention
    from repro_torch.models import get_api
    from repro_torch.rollout import PagedDecodeEngine
    from repro_torch.train import HostTrainer, OptConfig, TrainerConfig

    cfg = get_config(TRAIN_ARCH)
    api = get_api(cfg, device=DEVICE)
    torch.cuda.reset_peak_memory_stats()
    ref_params = api.init(SEED)                 # the frozen reference policy
    trainer = HostTrainer(
        api, SEED, LossConfig(pg_variant="decoupled_ppo", kl_beta=1e-3),
        # build_rlvr_pipeline's optimizer; at the default 1e-6 a bf16 weight
        # would not move (the update is far below a bf16 ulp)
        OptConfig(learning_rate=3e-3, warmup_steps=5),
        TrainerConfig(max_seq_len=TRAIN["max_seq_len"], group_size=TRAIN["group"],
                      minibatches=2),
        ref_params=ref_params)
    eng = PagedDecodeEngine(api, trainer.get_weights(), num_slots=TRAIN["slots"],
                            max_total_len=TRAIN["max_seq_len"], page_size=16,
                            prefill_chunk=128, temperature=1.0, eos_id=-1, seed=SEED,
                            device=DEVICE)
    _warm(eng)
    probe = np.random.default_rng(SEED + 30).integers(3, cfg.vocab_size, 200).astype(np.int32)
    proxy = LLMProxy(eng, name="chip_smoke_train")
    proxy.start()
    steps = []
    try:
        for round_ in range(TRAIN["rounds"]):
            decode0 = eng.total_decode_steps
            paged_decode_attention.launches = 0
            t0 = time.perf_counter()
            results = _rollouts(proxy, _train_tasks(cfg.vocab_size, round_), round_)
            rollout_s = time.perf_counter() - t0
            paged = paged_decode_attention.launches
            decode_steps = eng.total_decode_steps - decode0
            if paged != cfg.num_layers * decode_steps or not paged:
                raise AssertionError(f"train: {paged} paged decode launches for "
                                     f"{decode_steps} decode steps x {cfg.num_layers}")
            versions = {r.version_started for r in results}
            if versions != {round_}:
                raise AssertionError(f"train round {round_}: rollout versions {versions}")
            samples = _to_samples(results, cfg.vocab_size)

            fa.flash_attention.launches_fwd = fa.flash_attention.launches_bwd = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = trainer.train_on_samples(samples)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            launches = (fa.flash_attention.launches_fwd, fa.flash_attention.launches_bwd)
            if launches != (cfg.num_layers * 4, cfg.num_layers * 2):
                raise AssertionError(f"train: flash launches {launches}, expected "
                                     f"{(cfg.num_layers * 4, cfg.num_layers * 2)}")
            if not all(np.isfinite(v) for v in metrics.values()):
                raise AssertionError(f"train: non-finite metrics {metrics}")

            # weight sync: suspend, hand the engine the new tree, resume
            proxy.suspend()
            pre = _engine_logits(api, eng.params, probe)
            t0 = time.perf_counter()
            proxy.update_weights(trainer.get_weights())
            torch.cuda.synchronize()
            sync_s = time.perf_counter() - t0
            post = _engine_logits(api, eng.params, probe)
            with torch.no_grad():
                want, _ = api.apply(trainer.get_weights(),
                                    {"tokens": torch.tensor(probe, device=DEVICE)[None]})
            proxy.resume()
            served = (post - want[0, -1]).abs().max().item()
            moved = (post - pre).abs().max().item()
            scale = want[0, -1].abs().max().item()
            if not (served <= 5e-2 * scale and moved > 4 * served):
                raise AssertionError(f"train: after the sync the engine's logits differ "
                                     f"from the trainer's by {served} (scale {scale}) and "
                                     f"moved by {moved}")
            real = int(sum(len(x.prompt_tokens) + len(x.response_tokens) for x in samples))
            padded = len(samples) * TRAIN["max_seq_len"]
            step = dict(round=round_, samples=len(samples), rollout_s=rollout_s,
                        decode_steps=decode_steps, paged_launches=paged,
                        loss=metrics["loss"], grad_norm=metrics["grad_norm"],
                        clip_frac=metrics["clip_frac"], ratio_mean=metrics["ratio_mean"],
                        ratio_max=metrics["ratio_max"], kl=metrics["kl"], lr=metrics["lr"],
                        reward_mean=metrics["reward_mean"], train_step_s=train_s,
                        trained_tokens=real, trained_tokens_per_s=real / train_s,
                        padded_tokens_per_s=padded / train_s, weight_sync_s=sync_s,
                        flash_launches_fwd=launches[0], flash_launches_bwd=launches[1],
                        engine_vs_trainer_logits_max_abs=served,
                        engine_logits_moved_max_abs=moved, logits_scale=scale,
                        max_memory_allocated=torch.cuda.max_memory_allocated())
            steps.append(step)
            emit("train", arch=TRAIN_ARCH, dtype=cfg.dtype, layers=cfg.num_layers, **step)
    finally:
        proxy.stop()
    eng.audit_pages()
    return {"trainer": trainer, "samples": samples, "steps": steps, "engine": eng}


def phase_profile_train(shared: dict) -> None:
    """Where one ``train_on_samples`` call's time goes (prox and ref passes,
    two minibatch steps): host wall (unprofiled, synchronised) against the
    device's busy time, and device ms by kernel (torch.profiler)."""
    torch = _torch()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    trainer, samples = shared["trainer"], shared["samples"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train_on_samples(samples)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_on_samples(samples)
        torch.cuda.synchronize()
        profiled_wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    by = {"flash_fwd": 0.0, "flash_bwd": 0.0, "gemm": 0.0, "other": 0.0}
    names: dict = {}
    for e in kernels:
        n = e.name.lower()
        key = ("flash_fwd" if "flash_fwd" in n else
               "flash_bwd" if "flash_bwd" in n else
               "gemm" if any(w in n for w in ("gemm", "nvjet", "xmma", "cutlass", "matmul"))
               else "other")
        ms = _device_us(e) / 1e3
        by[key] += ms
        names[e.name] = names.get(e.name, 0.0) + ms
    busy_ms = sum(by.values())
    top = sorted(names.items(), key=lambda kv: -kv[1])[:12]
    launches = sum(1 for e in events
                   if e.name in ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx"))
    emit("profile_train", window="one train_on_samples: prox + ref passes, 2 minibatch steps",
         host_wall_ms=wall_ms, profiled_wall_ms=profiled_wall_ms, device_busy_ms=busy_ms,
         device_idle_share=max(0.0, 1 - busy_ms / wall_ms), launches=launches,
         device_ms_by_kernel=by, top_kernels_ms=[[n[:80], ms] for n, ms in top])
    if not busy_ms > 0:
        raise AssertionError("profile_train: the profiler saw no device time")


# ---------------------------------------------------------------------------
# pipeline_rlvr / pipeline_agentic / train_cli: the asynchronous pipeline
# through its entry points (slice 9)
# ---------------------------------------------------------------------------

# the RLVR pipeline on full-width, full-depth Qwen3-1.7B: two replicas of 8
# slots behind the ProxyRouter, 16 samples a step in groups of 4
PIPE = dict(num_slots=16, rollout_batch_size=16, num_return_sequences_in_group=4,
            max_new_tokens=32, max_seq_len=64, page_size=16, prefill_chunk=16,
            pg_variant="decoupled_ppo", num_rollout_replicas=2,
            weight_sync="overlapped", seed=SEED)
# cut from 4, 3 and 2 steps to keep the whole run inside its time limit
# on a slow host (its host-bound phases ran 20-30% longer on one card's
# machine than on another's)
PIPE_STEPS = 2
TRACE_STEPS = 2         # the traced runs: step 1 under the profiler
# the agentic pipeline: 2 env groups of 4 GridTargetEnvs (3 turns at most),
# 2 steps of 8 trajectories
AGENTIC = dict(num_env_groups=2, group_size=4, max_env_steps=3, steps=2)
AGENTIC_PIPE = dict(PIPE, rollout_batch_size=8, max_new_tokens=8,
                    async_generation_ratio=1)


# ``train_cli``'s command line (``launch/train.py`` fixes ``max_seq_len``
# at 32)
CLI = dict(preset="rl_100m", replicas=2, slots=16, batch=16, max_seq_len=32)


def _pipeline_shapes() -> dict:
    """{phase: {"paged": (B, H, KV, D, page, P, q dtype, int8 pool),
    "flash": (B, H, KV, S, D, dtype)}}: what the pipeline phases give the
    paged decode kernel (B = one replica's slots, P = pages per sequence)
    and the flash kernels (B = samples a train step, S = ``max_seq_len``).
    ``phase_kernels`` and ``phase_flash_kernels`` hold the kernels against
    their plain versions at these shapes; ``_run_pipeline`` checks that its
    engines and trainer have them."""
    from repro_torch.configs import get_config
    from repro_torch.launch.pipeline import PipelineSettings
    from repro_torch.launch.train import build_model_cfg

    def shapes(cfg, slots, replicas, max_seq_len, page, batch, int8):
        return {"paged": (-(-slots // replicas), cfg.num_heads, cfg.num_kv_heads,
                          cfg.head_dim, page, -(-max_seq_len // page), cfg.dtype, int8),
                "flash": (batch, cfg.num_heads, cfg.num_kv_heads, max_seq_len,
                          cfg.head_dim, cfg.dtype)}

    cfg = get_config(TRAIN_ARCH)
    out = {phase: shapes(cfg, pipe["num_slots"], pipe["num_rollout_replicas"],
                         pipe["max_seq_len"], pipe["page_size"],
                         pipe["rollout_batch_size"], False)
           for phase, pipe in (("pipeline_rlvr", PIPE), ("pipeline_agentic", AGENTIC_PIPE))}
    out["train_cli"] = shapes(build_model_cfg(TRAIN_ARCH, CLI["preset"]), CLI["slots"],
                              CLI["replicas"], CLI["max_seq_len"],
                              PipelineSettings().page_size, CLI["batch"], True)
    return out


def _free_device() -> None:
    """Release an earlier pipeline's tensors: its objects hold reference
    cycles (the producer's client calls back into the producer), so only
    the cycle collector frees them."""
    import gc
    gc.collect()
    _torch().cuda.empty_cache()


def _pipeline_reward(sample) -> float:
    """A seeded synthetic reward (random weights never solve the task):
    1 when more than half the response's tokens are even."""
    import numpy as np
    return float(np.mean(np.asarray(sample.response_tokens) % 2 == 0) > 0.5)


def _flash_per_train(layers: int, s) -> tuple:
    """(forward, backward) flash launches of one ``train_on_samples``
    (``train/trainer.py``): a forward per layer for the proximal pass
    (``decoupled_ppo``, or minibatches > 1), a forward and a backward per
    layer for each minibatch step of each epoch; no reference pass (the
    pipeline's trainer holds no reference policy)."""
    steps = s.ppo_epochs * s.minibatches
    prox = int(s.pg_variant == "decoupled_ppo" or s.minibatches > 1)
    return layers * (steps + prox), layers * steps


def _run_pipeline(phase: str, pipe, steps: int, gpu: str, shapes_of=None,
                  **fields) -> dict:
    """``pipe.run(steps)`` with the paged decode and flash counts set to 0
    just before and read just after; holds launches, staleness, versions,
    the engines' weights and page audits.  The kernels must have run at
    ``_pipeline_shapes()[shapes_of or phase]``."""
    import numpy as np
    torch = _torch()
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.paged_decode_attention import paged_decode_attention as pda

    cfg, s = pipe.trainer.api.cfg, pipe.settings
    alpha = s.async_generation_ratio
    flash = fa.flash_attention
    per_train = []          # only the trainer (this thread) launches flash
    batch_sizes = []
    train = pipe.controller.train_fn

    def counted(samples):
        f0, b0 = flash.launches_fwd, flash.launches_bwd
        metrics = train(samples)
        per_train.append((flash.launches_fwd - f0, flash.launches_bwd - b0))
        batch_sizes.append(len(samples))
        return metrics

    pipe.controller.train_fn = counted
    pda.launches = pda.launches_int8 = 0
    flash.launches_fwd = flash.launches_bwd = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = pipe.run(steps, timeout=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    paged, paged_int8 = pda.launches, pda.launches_int8
    fwd, bwd = flash.launches_fwd, flash.launches_bwd
    decode_steps = [e.total_decode_steps for e in pipe.engines]

    # the kernels ran at the shapes phase_kernels / phase_flash_kernels held
    want = _pipeline_shapes()[shapes_of or phase]
    paged_shapes = [(e.num_slots, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                     e.page_size, e.pages_per_seq, cfg.dtype, e.kv_quant == "int8")
                    for e in pipe.engines]
    flash_shapes = {(n // s.minibatches, cfg.num_heads, cfg.num_kv_heads,
                     pipe.trainer.tcfg.max_seq_len, cfg.head_dim, cfg.dtype)
                    for n in batch_sizes}
    if set(paged_shapes) != {want["paged"]} or flash_shapes != {want["flash"]}:
        raise AssertionError(f"{phase}: kernel shapes {paged_shapes} / {flash_shapes}, "
                             f"checked {want}")

    want_paged = cfg.num_layers * sum(decode_steps)
    if paged != want_paged or not paged or paged_int8:
        raise AssertionError(f"{phase}: {paged} paged decode launches ({paged_int8} int8) "
                             f"for decode steps {decode_steps} x {cfg.num_layers} layers")
    want_train = _flash_per_train(cfg.num_layers, s)
    if per_train != [want_train] * steps or (fwd, bwd) != (steps * want_train[0],
                                                           steps * want_train[1]):
        raise AssertionError(f"{phase}: flash launches per train_on_samples {per_train} "
                             f"(total {fwd}, {bwd}), expected {want_train} x {steps}")
    stale = max(st.staleness_max for st in stats)
    if len(stats) != steps or stale > alpha:
        raise AssertionError(f"{phase}: {len(stats)} steps, staleness max {stale} > {alpha}")
    if pipe.buffer.version != steps or \
            pipe.buffer.total_consumed != steps * s.rollout_batch_size:
        raise AssertionError(f"{phase}: version {pipe.buffer.version}, consumed "
                             f"{pipe.buffer.total_consumed}")
    final = pipe.trainer.get_weights()
    if not all(e.params is final for e in pipe.engines):
        raise AssertionError(f"{phase}: an engine does not hold the trainer's final tree")
    for e in pipe.engines:
        e.audit_pages()
    if pipe.router is None or pipe.router.replicas_alive != len(pipe.engines):
        raise AssertionError(f"{phase}: replicas alive {pipe.router and pipe.router.replicas_alive}")
    if not all(np.isfinite(st.loss) for st in stats):
        raise AssertionError(f"{phase}: non-finite loss {[st.loss for st in stats]}")

    step_wall = [st.wait_time + st.train_time + st.sync_time for st in stats]
    out = dict(
        gpu=gpu, arch=cfg.arch_id, dtype=cfg.dtype, layers=cfg.num_layers, alpha=alpha,
        weight_sync="blocking (alpha=0)" if alpha == 0 else s.weight_sync,
        replicas=len(pipe.engines), slots_per_replica=pipe.engines[0].num_slots,
        batch=s.rollout_batch_size, steps=steps, wall_s=wall, wall_per_step_s=wall / steps,
        step_wall_s=step_wall,
        steady_wall_per_step_s=(sum(step_wall[1:]) / (steps - 1) if steps > 1
                                else step_wall[0]),
        per_step=[dict(step=st.step, wait_s=st.wait_time, train_s=st.train_time,
                       sync_s=st.sync_time, staleness_mean=st.staleness_mean,
                       staleness_max=st.staleness_max, reward_mean=st.reward_mean,
                       loss=st.loss, queue_depth=st.queue_depth,
                       active_per_replica=st.active_per_replica) for st in stats],
        decode_steps_per_replica=decode_steps, paged_launches=paged,
        paged_launches_per_step=paged / steps, flash_launches=[fwd, bwd],
        flash_launches_per_train_on_samples=list(want_train),
        samples_produced=pipe.buffer.total_produced,
        samples_consumed=pipe.buffer.total_consumed,
        max_memory_allocated=torch.cuda.max_memory_allocated(), **fields)
    emit(phase, **out)
    return out


class _ThreadCPU:
    """CPU seconds of each thread of this process (``/proc/self/task``),
    read every ``period`` s by a thread of its own and named by
    ``threading``'s native ids ("native" for threads Python did not
    start).  A thread that ends loses at most one period.  At each read
    also where each Python thread is: its innermost frame in the port's
    code (``sys._current_frames``), a sample of wall time, not of CPU."""

    def __init__(self, period: float = 0.1):
        self.period, self.cpu, self.names = period, {}, {}
        self._base: dict = {}
        self.where: dict = {}
        self._halt = threading.Event()
        self._thread = threading.Thread(target=self._loop, name="cpu_sampler", daemon=True)

    def _sample_frames(self) -> None:
        names = {t.ident: t.name for t in threading.enumerate()}
        for ident, frame in sys._current_frames().items():
            name = names.get(ident)
            if name in (None, "cpu_sampler"):
                continue
            inner = frame
            while frame is not None and "repro_torch" not in frame.f_code.co_filename:
                frame = frame.f_back
            frame = frame or inner
            key = (f"{os.path.basename(frame.f_code.co_filename)}:"
                   f"{frame.f_code.co_name}:{frame.f_lineno}")
            counts = self.where.setdefault(name, {})
            counts[key] = counts.get(key, 0) + 1

    def _read(self) -> None:
        tick = os.sysconf("SC_CLK_TCK")
        names = {t.native_id: t.name for t in threading.enumerate()}
        for tid in os.listdir("/proc/self/task"):
            try:
                with open(f"/proc/self/task/{tid}/stat") as f:
                    fields = f.read().rsplit(")", 1)[1].split()
            except OSError:
                continue
            self.cpu[int(tid)] = (int(fields[11]) + int(fields[12])) / tick  # utime + stime
            self.names.setdefault(int(tid), names.get(int(tid), "native"))

    def _loop(self) -> None:
        while not self._halt.wait(self.period):
            self._read()
            self._sample_frames()

    def top_frames(self, k: int = 6) -> dict:
        """{thread name: [[frame, share of its samples], ...]}, the ``k``
        most sampled frames of each Python thread."""
        out = {}
        for name, counts in self.where.items():
            n = sum(counts.values())
            out[name] = [[key, c / n] for key, c in
                         sorted(counts.items(), key=lambda kv: -kv[1])[:k]]
        return out

    def start(self) -> None:
        self._read()
        self._base = dict(self.cpu)
        self._thread.start()

    def stop(self) -> dict:
        """{thread name: CPU seconds since ``start``}, summed over threads
        of one name, the sampler itself left out."""
        self._halt.set()
        self._thread.join()
        self._read()
        out: dict = {}
        for tid, sec in self.cpu.items():
            name = self.names[tid]
            if name != "cpu_sampler":
                out[name] = out.get(name, 0.0) + sec - self._base.get(tid, 0.0)
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def _busy_us(events) -> float:
    """Microseconds in which the device ran at least one of ``events``."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def _trace_pipeline(phase: str, pipe, steps: int, gpu: str) -> dict:
    """Where a pipeline step's time goes: ``pipe.run(steps)`` with steps
    1.. (from the end of the first train call) under ``torch.profiler``
    (CUDA activity only) and ``_ThreadCPU``.  Device busy against wall
    gives the idle share; the process's CPU seconds against wall say how
    many cores the host kept busy (about 1 when the threads take turns on
    the interpreter lock), the threads' CPU seconds say who kept them
    busy, and the sampled frames where each thread spent its wall time.  A separate run: the wall numbers of ``_run_pipeline`` are not
    profiled."""
    torch = _torch()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prof, cpu, marks = profile(activities=[ProfilerActivity.CUDA]), _ThreadCPU(), {}
    train = pipe.controller.train_fn

    def traced(samples):
        metrics = train(samples)
        if not marks:
            torch.cuda.synchronize()
            cpu.start()
            prof.start()
            marks.update(t0=time.perf_counter(), p0=time.process_time())
        return metrics

    pipe.controller.train_fn = traced
    stats = pipe.run(steps, timeout=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - marks["t0"]
    process_cpu = time.process_time() - marks["p0"]
    threads = cpu.stop()            # before the profiler's own processing
    prof.stop()
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = _busy_us(device) / 1e6
    n = steps - 1
    out = dict(gpu=gpu, alpha=pipe.settings.async_generation_ratio, traced_steps=n,
               window="from the end of step 0's train call to the end of the run",
               wall_s=wall, wall_per_step_s=wall / n, device_busy_s=busy,
               device_busy_per_step_s=busy / n, device_idle_share=max(0.0, 1 - busy / wall),
               device_ops_per_step=len(device) / n,
               process_cpu_s=process_cpu, cores_busy=process_cpu / wall,
               thread_cpu_s={k: v for k, v in list(threads.items())[:10]},
               thread_frames=cpu.top_frames(),
               per_step=[dict(step=st.step, wait_s=st.wait_time, train_s=st.train_time,
                              sync_s=st.sync_time) for st in stats[1:]])
    emit(phase + "_trace", **out)
    if not device:
        raise AssertionError(f"{phase}: the profiler saw no device work")
    return out


def phase_pipeline_rlvr(gpu: str) -> dict:
    """``build_rlvr_pipeline(...).run`` on full-width, full-depth Qwen3-1.7B,
    bf16: two replicas, overlapped weight sync at alpha = 1, then the
    synchronous baseline (alpha = 0, the paper's switch), ``PIPE_STEPS``
    steps each.  Then one traced run of 2 steps in each mode
    (``_trace_pipeline``)."""
    torch = _torch()
    from repro_torch.configs import get_config
    from repro_torch.launch.pipeline import PipelineSettings, build_rlvr_pipeline

    cfg = get_config(TRAIN_ARCH)
    runs = {}
    for alpha in (1, 0):
        _free_device()
        torch.cuda.reset_peak_memory_stats()
        pipe = build_rlvr_pipeline(cfg, PipelineSettings(async_generation_ratio=alpha,
                                                         **PIPE),
                                   reward_fn=_pipeline_reward, device=DEVICE)
        runs[alpha] = _run_pipeline("pipeline_rlvr", pipe, PIPE_STEPS, gpu)
        del pipe
    emit("pipeline_rlvr_summary", gpu=gpu,
         wall_per_step_s={"alpha1": runs[1]["wall_per_step_s"],
                          "alpha0": runs[0]["wall_per_step_s"]},
         steady_wall_per_step_s={"alpha1": runs[1]["steady_wall_per_step_s"],
                                 "alpha0": runs[0]["steady_wall_per_step_s"]},
         alpha1_over_alpha0=runs[1]["wall_per_step_s"] / runs[0]["wall_per_step_s"])
    for alpha in (1, 0):
        _free_device()
        pipe = build_rlvr_pipeline(cfg, PipelineSettings(async_generation_ratio=alpha,
                                                         **PIPE),
                                   reward_fn=_pipeline_reward, device=DEVICE)
        runs[alpha]["trace"] = _trace_pipeline("pipeline_rlvr", pipe, TRACE_STEPS, gpu)
        del pipe
    return runs


def phase_pipeline_agentic(gpu: str) -> dict:
    """``build_agentic_pipeline(...).run`` on the same model: GridTargetEnv
    managers behind two replicas, 2 steps of 8 trajectories."""
    torch = _torch()
    from repro_torch.configs import get_config
    from repro_torch.envs import GridTargetEnv
    from repro_torch.launch.pipeline import PipelineSettings, build_agentic_pipeline

    _free_device()
    torch.cuda.reset_peak_memory_stats()
    pipe = build_agentic_pipeline(
        get_config(TRAIN_ARCH), PipelineSettings(**AGENTIC_PIPE),
        make_env=lambda i: GridTargetEnv(i, max_steps=AGENTIC["max_env_steps"]),
        num_env_groups=AGENTIC["num_env_groups"], group_size=AGENTIC["group_size"],
        max_env_steps=AGENTIC["max_env_steps"], device=DEVICE)
    run = _run_pipeline("pipeline_agentic", pipe, AGENTIC["steps"], gpu,
                        env="GridTargetEnv", **{k: v for k, v in AGENTIC.items()
                                                if k != "steps"})
    if any(m.is_alive() for m in pipe.pool.managers):
        raise AssertionError("pipeline_agentic: env managers outlived the run")
    del pipe
    _free_device()
    return run


def phase_train_cli(gpu: str) -> None:
    """``python -m repro_torch.launch.train`` as a user runs it, on the card:
    a 100M-parameter Qwen3 (rl_100m), two replicas, int8 rollout weights
    and int8 KV pages (the int8 paged kernel), 3 steps."""
    root = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(root, "build", "chip_smoke", "train_cli.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    if os.path.exists(out):
        os.remove(out)
    cmd = ["-m", "repro_torch.launch.train", "--arch", TRAIN_ARCH, "--preset", CLI["preset"],
           "--steps", "3", "--rollout-replicas", str(CLI["replicas"]),
           "--num-slots", str(CLI["slots"]), "--rollout-batch-size", str(CLI["batch"]),
           "--rollout-quant", "int8", "--kv-quant", "int8", "--tis-clip", "2", "--out", out]
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, *cmd], env=env, cwd=root, capture_output=True,
                         text=True, timeout=300)
    seconds = time.perf_counter() - t0
    if run.returncode != 0:
        raise AssertionError(f"train_cli: exit {run.returncode}\n{run.stdout[-2000:]}\n"
                             f"{run.stderr[-4000:]}")
    with open(out) as f:
        stats = json.load(f)
    if len(stats) != 3 or [st["step"] for st in stats] != [0, 1, 2]:
        raise AssertionError(f"train_cli: wrote {len(stats)} steps")
    if not all(st["quant_modes"] == {"int8": CLI["batch"]} for st in stats):
        raise AssertionError(f"train_cli: batches by quant mode "
                             f"{[st['quant_modes'] for st in stats]}")
    emit("train_cli", gpu=gpu, command="python " + " ".join(cmd[:-2]), exit=run.returncode,
         seconds=seconds, steps=len(stats),
         step_wall_s=[st["wait_time"] + st["train_time"] + st["sync_time"] for st in stats],
         staleness_max=[st["staleness_max"] for st in stats],
         quant_modes=stats[-1]["quant_modes"], replicas_alive=stats[-1]["replicas_alive"],
         stdout=run.stdout.strip().splitlines()[-6:])


# ---------------------------------------------------------------------------
# the MoE family (slice 10): Qwen3-MoE-235B-A22B and DBRX-132B at full
# width, cut in depth
# ---------------------------------------------------------------------------

MOE_ARCH = "qwen3-moe-235b-a22b"
DBRX_ARCH = "dbrx-132b"
MOE_MODEL_LAYERS = 2        # model_moe: fp32, kernel path against plain path
MOE_SERVE_LAYERS = 8        # serve_moe: bf16, 8 of Qwen3-MoE's 94 layers
MOE_TRAIN_LAYERS = 1        # train_moe: bf16 weights and grads, fp32 master, m, v
MOE_TRAIN = dict(groups=4, group=4, prompt=32, response=32)    # 16 x 64 tokens
# fp32 greedy tokens, kernel path against plain path (model_moe): besides a
# top-2 logit gap below DENSE_TOP2_TOL, a divergence is tolerated only where
# the plain path, replayed to the diverging step, routed a decoded token
# (the kernel runs in decode steps only; prefill is plain in both engines)
# with its k-th and (k+1)-th router probabilities closer than this: a
# near-tie there flips an expert choice, a discrete change that rounding
# alone can make.  Fixed before the first run.
MOE_ROUTER_GAP_TOL = 1e-6


def _moe_configs() -> dict:
    from repro_torch.configs import get_config
    return {arch: get_config(arch) for arch in (MOE_ARCH, DBRX_ARCH)}


def phase_moe_kernels(rows: list, gpu: str) -> None:
    """The kernels at the MoE family's shapes, against their plain versions
    and timed: paged decode (bf16 and int8 pools) at the serving shape
    (B=16, page 16, P=64) with Qwen3-MoE-235B-A22B's 64 heads over 4 KV
    heads (G=16) and DBRX-132B's 48 over 8 (G=6); dense decode attention at
    both (S=1024, bf16); the flash forward and backward at ``train_moe``'s
    step (B=16, S=64, Qwen3-MoE's heads, bf16).  The numbers go into the
    existing rows as their ``moe_shapes`` field."""
    torch = _torch()
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.paged_decode_attention import paged_decode_attention
    from repro_torch.kernels.ref import decode_attention_ref, paged_decode_attention_ref

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 200)
    bf16 = torch.bfloat16
    tol = TOL["bfloat16"]
    page_size, b = SERVE["page_size"], SERVE["num_slots"]
    p = SERVE["max_total_len"] // page_size
    keep = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "bound_detail",
            "library_ms", "shape", "split")
    for arch, cfg in _moe_configs().items():
        h, kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        for row, int8 in ((rows[0], False), (rows[1], True)):
            q, kp, vp, tables, lengths, scales = _paged_inputs(gen, b, h, kv, d, page_size,
                                                               p, bf16, int8=int8)
            out = paged_decode_attention(q, kp, vp, tables, lengths, **scales)
            torch.cuda.synchronize()
            ref = paged_decode_attention_ref(q, kp, vp, tables, lengths, **scales)
            err = (out.float() - ref.float()).abs().max().item()
            ok = torch.allclose(out.float(), ref.float(), **tol)
            emit("kernels", case=f"moe_{arch}_{'int8' if int8 else 'bf16'}",
                 kernel=row["name"], shape=[b, h, kv, d, page_size, p], max_abs_err=err,
                 tol=tol, ok=ok, gpu=gpu)
            if not ok:
                raise AssertionError(f"{row['name']} at {arch}'s shape: max abs err {err}")
            timed = _kernel_row(row["name"], (q, kp, vp, tables, lengths, scales, err),
                                page_size, row["variant"])
            row.setdefault("moe_shapes", {})[arch] = {k: timed[k] for k in keep}
            del q, kp, vp, out, ref

        # dense decode attention (the slot engine), ragged lengths 1..S
        s = SERVE_SLOT["max_total_len"]
        q = torch.randn(b, h, d, generator=gen, device=DEVICE).to(bf16)
        k, v = (torch.randn(b, s, kv, d, generator=gen, device=DEVICE).to(bf16)
                for _ in range(2))
        lengths = torch.randint(1, s + 1, (b,), generator=gen, device=DEVICE,
                                dtype=torch.int32)
        lengths[:2] = torch.tensor([1, s], dtype=torch.int32, device=DEVICE)
        out = decode_attention(q, k, v, lengths)
        torch.cuda.synchronize()
        err = _check_close(f"moe_{arch}_bf16", "decode_attention", [out],
                           [decode_attention_ref(q, k, v, lengths)], tol)
        rows[4].setdefault("moe_shapes", {})[arch] = _decode_times(
            q, k, v, lengths, err, f"ragged lengths 1..{s}")
        del q, k, v, out

    # the flash kernels at train_moe's step
    cfg = _moe_configs()[MOE_ARCH]
    n = MOE_TRAIN["groups"] * MOE_TRAIN["group"]
    seq = MOE_TRAIN["prompt"] + MOE_TRAIN["response"]
    case = _flash_case(gen, f"moe_{MOE_ARCH}_train_bf16", n, cfg.num_heads,
                       cfg.num_kv_heads, seq, cfg.resolved_head_dim, bf16, None, None)
    for row, backward in ((rows[2], False), (rows[3], True)):
        ms, plain, lib, err, bound_ms, bound_by, _ = _flash_times(case, backward)
        row.setdefault("moe_shapes", {})[MOE_ARCH] = {
            "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib, "shape": _flash_shape(case[0], case[1])}
    for row in rows[:5]:
        emit("kernels", kernel=row["name"], case="moe_shapes", gpu=gpu,
             moe_shapes=row["moe_shapes"])
    del case
    _free_device()


class _RouterGaps:
    """While entered, every router call of the MoE layer records the
    smallest gap between a token's k-th and (k+1)-th router probability."""

    def __init__(self):
        self.gaps = []

    def __enter__(self):
        from repro_torch.models import moe
        self._router = router = moe._router

        def recorded(p, cfg, x):
            out = router(p, cfg, x)
            top = _torch().topk(out[1], cfg.num_experts_per_tok + 1, dim=-1).values
            self.gaps.append(float((top[..., -2] - top[..., -1]).min()))
            return out
        moe._router = recorded
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe._router = self._router


def _moe_replay(api, params, prompt, generated, engine: str, kv_quant: str) -> dict:
    """The plain path's computation of one request of ``engine``, replayed
    alone (an MoE layer routes each request's tokens apart from the
    others'): the prompt's prefill (paged: 128-token chunks padded like the
    engine's, into a ``kv_quant`` pool; slot: one call padded to the
    16-token bucket), then a decode
    step for each of ``generated``.  Returns the last logits' top-2 gap and
    the smallest router k-th against (k+1)-th probability gap over the
    decode steps (None without one)."""
    torch = _torch()
    import numpy as np
    prompt, n = np.asarray(prompt, np.int32), len(generated)

    def padded(x, m):
        toks = np.zeros((1, -(-len(x) // m) * m), np.int32)
        toks[0, :len(x)] = x
        t = torch.from_numpy(toks).to(DEVICE)
        return t, torch.arange(t.shape[1], device=DEVICE)[None] < len(x)

    with torch.no_grad(), _RouterGaps() as rec:
        if engine == "paged":
            pages = -(-(len(prompt) + n + 128) // 16)
            cache = api.init_paged_cache(1 + pages, 16, kv_quant=kv_quant)
            row = torch.arange(1, 1 + pages, dtype=torch.int32, device=DEVICE)
            for lo in range(0, len(prompt), 128):
                toks, valid = padded(prompt[lo:lo + 128], 128)
                logits, cache = api.prefill_chunk(params, toks, valid, lo, row, cache)
        else:
            cache = api.init_cache(1, len(prompt) + n + 16)
            toks, valid = padded(prompt, 16)
            logits, cache = api.prefill(params, {"tokens": toks, "valid": valid}, cache,
                                        attn_impl="ref")
        del rec.gaps[:]
        for i, t in enumerate(generated):
            tok = torch.tensor([t], dtype=torch.int32, device=DEVICE)
            pos = torch.tensor([len(prompt) + i], dtype=torch.int32, device=DEVICE)
            if engine == "paged":
                logits, cache = api.decode_paged(params, tok, pos, cache, row[None],
                                                 attn_impl="ref")
            else:
                logits, cache = api.decode_step(params, tok, pos, cache, attn_impl="ref")
    top = torch.topk(logits[0].float(), 2).values
    return {"top2_gap": float(top[0] - top[1]),
            "router_gap": min(rec.gaps) if rec.gaps else None}


def _moe_kernel_vs_ref(api, params, prompts, max_new, engine: str, gpu: str,
                       kv_quant: str = "off") -> dict:
    """Greedy tokens through two engines (``engine`` "paged", with a
    ``kv_quant`` pool, or "slot") sharing the weights, ``attn_impl`` kernel
    against ref, with the kernel's launches in the kernel engine's run (an
    int8 pool: ``launches_int8`` as well).  A divergence is
    tolerated only at a near-tie of the plain path replayed to it: a top-2
    logit gap below ``DENSE_TOP2_TOL`` or a router gap below
    ``MOE_ROUTER_GAP_TOL``."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.paged_decode_attention import paged_decode_attention
    wrapper = paged_decode_attention if engine == "paged" else decode_attention
    counter = "launches_int8" if kv_quant == "int8" else "launches"
    pool = {"kv_quant": kv_quant} if engine == "paged" else {}
    results, launches = {}, {}
    for impl in ("kernel", "ref"):
        wrapper.launches = 0
        setattr(wrapper, counter, 0)
        steps = []
        run = _greedy if engine == "paged" else _slot_greedy
        results[impl] = run(api, params, prompts, max_new, attn_impl=impl,
                            steps_out=steps, **pool)
        launches[impl] = (getattr(wrapper, counter), steps[0], wrapper.launches)
    divergences = []
    for rid, prompt in enumerate(prompts):
        a, b = results["kernel"][rid][0], results["ref"][rid][0]
        if a != b:
            step = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
            divergences.append({"request": rid, "step": step,
                                **_moe_replay(api, params, prompt, a[:step], engine,
                                              kv_quant)})
    cfg = api.cfg
    kernel_launches, decode_steps, _ = launches["kernel"]
    emit("model_moe", arch=cfg.arch_id, gpu=gpu, dtype="float32", engine=engine,
         kv_quant=kv_quant, check="kernel_vs_ref", layers=cfg.num_layers, d_model=cfg.d_model,
         experts=cfg.num_experts, top_k=cfg.num_experts_per_tok, requests=len(prompts),
         max_new_tokens=max_new, tokens_identical=not divergences,
         divergences=divergences, tolerated_top2_gap_below=DENSE_TOP2_TOL,
         tolerated_router_gap_below=MOE_ROUTER_GAP_TOL,
         kernel_launches=kernel_launches, decode_steps=decode_steps,
         ref_engine_kernel_launches=launches["ref"][2])
    bad = [dv for dv in divergences
           if not (dv["top2_gap"] < DENSE_TOP2_TOL
                   or (dv["router_gap"] or 1.0) < MOE_ROUTER_GAP_TOL)]
    if bad:
        raise AssertionError(f"{cfg.arch_id} ({engine}): kernel and ref greedy tokens "
                             f"diverge: {bad}")
    if (kernel_launches != cfg.num_layers * decode_steps or launches["kernel"][2]
            != kernel_launches or launches["ref"][2]):
        raise AssertionError(f"{cfg.arch_id} ({engine}, kv_quant={kv_quant}): "
                             f"{launches['kernel']} kernel launches ({counter}, steps, "
                             f"all) for {decode_steps} decode steps x {cfg.num_layers} "
                             f"layers ({launches['ref']} on the ref engine)")
    return {"launches": kernel_launches, "decode_steps": decode_steps}


def phase_model_moe(rows: list, gpu: str) -> None:
    """fp32, full width, cut to ``MOE_MODEL_LAYERS`` layers: Qwen3-MoE-
    235B-A22B (128 experts, top 8; ~25 GB) through two ``PagedDecodeEngine``s
    (an fp32 and an int8 KV pool) and two slot ``DecodeEngine``s, then
    DBRX-132B (16 experts, top 4; ~31 GB) through two paged engines:
    ``attn_impl`` kernel against ref, greedy tokens, exact launches.  MoE layers dispatch with the
    reference's capacity factor (``moe_mode="ep"``): prefill chunks of 128
    tokens drop assignments past each expert's capacity in both engines
    alike."""
    import dataclasses
    import numpy as np
    from repro_torch.models import get_api

    rng = np.random.default_rng(SEED + 210)
    counts = {}
    for arch, cfg in _moe_configs().items():
        _free_device()
        cfg = dataclasses.replace(cfg, dtype="float32", num_layers=MOE_MODEL_LAYERS)
        api = get_api(cfg, device=DEVICE)
        params = api.init(SEED)
        prompts = [rng.integers(3, cfg.vocab_size, n).astype(np.int32)
                   for n in (40, 100, 180, 250)]
        counts[(0, f"model_moe_{arch}")] = _moe_kernel_vs_ref(api, params, prompts, 16,
                                                              "paged", gpu)
        if arch == MOE_ARCH:
            counts[(1, f"model_moe_{arch}")] = _moe_kernel_vs_ref(
                api, params, prompts, 16, "paged", gpu, kv_quant="int8")
            counts[(4, f"model_moe_{arch}_slot")] = _moe_kernel_vs_ref(
                api, params, prompts, 16, "slot", gpu)
        del api, params
    for (i, key), c in counts.items():
        rows[i].setdefault("moe_launches", {})[key] = c["launches"]
    _free_device()


def phase_serve_moe(rows: list, gpu: str) -> None:
    """Qwen3-MoE-235B-A22B in bf16 at full width (128 experts, the whole
    vocabulary), cut to ``MOE_SERVE_LAYERS`` of 94 layers, behind
    ``LLMProxy`` over ``PagedDecodeEngine`` (the ``serve`` settings: 16
    slots, ``max_total_len`` 1024, page 16, prefill chunk 128, prefix cache
    on) serving the ``serve`` task mix.  Exact paged-kernel launches
    (layers x decode steps), a clean page audit, held weight and KV bytes,
    peak memory; then a profiled decode window."""
    import dataclasses
    torch = _torch()
    from repro_torch.models import get_api
    from repro_torch.rollout import PagedDecodeEngine
    from repro_torch.train.optimizer import tree_leaves

    _free_device()
    full = _moe_configs()[MOE_ARCH]
    cfg = dataclasses.replace(full, num_layers=MOE_SERVE_LAYERS)
    api = get_api(cfg, device=DEVICE)
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    params = api.init(SEED)
    torch.cuda.synchronize()
    weight_bytes = torch.cuda.memory_allocated() - m0
    eng = PagedDecodeEngine(api, params, prefix_cache=True, temperature=1.0,
                            eos_id=-1, seed=SEED, device=DEVICE, **SERVE)
    kv_bytes = sum(t.numel() * t.element_size() for t in eng.cache if t is not None)
    _warm(eng)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run = _serve_run(eng, _serve_tasks(cfg.vocab_size), cfg.vocab_size)
    run.pop("results")
    peak = torch.cuda.max_memory_allocated()
    want = cfg.num_layers * run["decode_steps"]
    emit("serve_moe", arch=MOE_ARCH, gpu=gpu, dtype=cfg.dtype, layers=cfg.num_layers,
         of_layers=full.num_layers, experts=cfg.num_experts, top_k=cfg.num_experts_per_tok,
         params=sum(t.numel() for t in tree_leaves(params)),
         weight_bytes=weight_bytes, kv_pool_bytes=kv_bytes, peak_memory_bytes=peak,
         expected_launches=want,
         note=f"{cfg.num_layers} of {full.num_layers} layers: host dispatch is a larger "
              "share of a step than at full depth", **run)
    if run["kernel_launches_int8"] or run["kernel_launches"] != want or not want:
        raise AssertionError(f"serve_moe: {run['kernel_launches']} kernel launches "
                             f"({run['kernel_launches_int8']} int8), expected {want}")
    rows[0].setdefault("moe_launches", {})["serve_moe"] = run["kernel_launches"]
    _profile_decode(eng, phase="profile_moe", arch=MOE_ARCH, gpu=gpu)
    del eng, params, api
    _free_device()


def _seeded_samples(vocab: int, spec: dict, seed: int) -> list:
    """``spec["groups"]`` prompts of ``spec["prompt"]`` tokens, each with
    ``spec["group"]`` responses of ``spec["response"]``; a seeded synthetic
    reward (1 when more than half the response's tokens are even)."""
    import numpy as np
    from repro_torch.core.types import Sample
    rng = np.random.default_rng(seed)
    out = []
    for g in range(spec["groups"]):
        prompt = rng.integers(3, vocab, spec["prompt"]).astype(np.int32)
        for j in range(spec["group"]):
            r = rng.integers(3, vocab, spec["response"]).astype(np.int32)
            out.append(Sample(sample_id=len(out), prompt_id=g, replica_idx=j,
                              prompt_tokens=prompt, response_tokens=r,
                              logprobs=(-rng.random(len(r)) * 3 - 9).astype(np.float32),
                              reward=float(np.mean(r % 2 == 0) > 0.5), group_id=g))
    return out


def phase_train_moe(rows: list, gpu: str) -> None:
    """One ``HostTrainer.train_on_samples`` of Qwen3-MoE-235B-A22B in bf16
    at full width, cut to ``MOE_TRAIN_LAYERS`` layer (~3.73 B parameters:
    bf16 weights and grads, fp32 master, m and v, ~60 GB), ``decoupled_ppo``
    on 16 x 64 tokens, the MoE in ``moe_mode="dense"`` as in the reference:
    loss, grad norm, the router losses, wall time, peak memory and exact
    flash launches.  A step that does not fit in the card's memory is
    reported with its peak, not narrowed."""
    import dataclasses
    import numpy as np
    torch = _torch()
    from repro_torch.algos import LossConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import get_api
    from repro_torch.train import HostTrainer, OptConfig, TrainerConfig
    from repro_torch.train.optimizer import tree_leaves

    _free_device()
    cfg = dataclasses.replace(_moe_configs()[MOE_ARCH], num_layers=MOE_TRAIN_LAYERS)
    api = get_api(cfg, device=DEVICE)
    torch.cuda.reset_peak_memory_stats()
    seq = MOE_TRAIN["prompt"] + MOE_TRAIN["response"]
    trainer = HostTrainer(api, SEED, LossConfig(pg_variant="decoupled_ppo"),
                          OptConfig(learning_rate=1e-5, warmup_steps=1),
                          TrainerConfig(max_seq_len=seq, group_size=MOE_TRAIN["group"]),
                          attn_impl="kernel")
    torch.cuda.synchronize()
    state_bytes = torch.cuda.memory_allocated()
    n_params = sum(t.numel() for t in tree_leaves(trainer.state["params"]))
    samples = _seeded_samples(cfg.vocab_size, MOE_TRAIN, SEED + 220)
    # the router losses of the policy on this batch, in the trainer's mode
    tokens = torch.from_numpy(trainer.build_batch(samples)["tokens"]).to(DEVICE)
    with torch.no_grad():
        _, aux = api.apply(trainer.state["params"], {"tokens": tokens},
                           return_features=True, moe_mode="dense")
    aux = {k: float(v) for k, v in aux.items()}
    del tokens
    flash = fa.flash_attention
    flash.launches_fwd = flash.launches_bwd = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        metrics = trainer.train_on_samples(samples)
        torch.cuda.synchronize()
        fits = True
    except torch.cuda.OutOfMemoryError as exc:
        metrics, fits = {"error": str(exc).splitlines()[0]}, False
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = (flash.launches_fwd, flash.launches_bwd)
    # a forward per layer for the proximal pass, a forward and a backward
    # per layer for the one train step
    want = (2 * cfg.num_layers, cfg.num_layers)
    emit("train_moe", arch=MOE_ARCH, gpu=gpu, dtype=cfg.dtype, layers=cfg.num_layers,
         d_model=cfg.d_model, experts=cfg.num_experts, moe_mode="dense",
         pg_variant="decoupled_ppo", batch=[len(samples), seq], params=n_params,
         state_bytes=state_bytes, fits=fits, metrics=metrics,
         loss=metrics.get("loss"), grad_norm=metrics.get("grad_norm"),
         load_balance_loss=metrics.get("load_balance_loss"),
         policy_router_losses=aux, wall_s=wall, peak_memory_bytes=peak,
         device_memory_bytes=torch.cuda.get_device_properties(0).total_memory,
         flash_launches=list(launches), expected_flash_launches=list(want))
    if not fits:
        return
    if launches != want:
        raise AssertionError(f"train_moe: flash launches {launches}, expected {want}")
    if not all(np.isfinite(metrics[k]) for k in ("loss", "grad_norm", "load_balance_loss")) \
            or not metrics["grad_norm"] > 0 or not aux["router_z_loss"] > 0:
        raise AssertionError(f"train_moe: metrics {metrics}, router losses {aux}")
    rows[2].setdefault("moe_launches", {})["train_moe"] = launches[0]
    rows[3].setdefault("moe_launches", {})["train_moe"] = launches[1]
    del trainer
    _free_device()


# ---------------------------------------------------------------------------
# the critic, checkpoints and the example twins (slice 11)
# ---------------------------------------------------------------------------

CRITIC_STEPS = 8            # critic steps on one fixed batch: the value loss must fall
CRITIC_OPT = dict(learning_rate=1e-4, warmup_steps=1)
# the checkpoint round trip's trainer: launch/train.py's rl_100m preset
CKPT = dict(preset="rl_100m", samples=16, group=4, prompt=16, response=16)
CKPT_TOL = dict(rtol=1e-5, atol=1e-6)       # the trainer parity tests' tolerances
EXAMPLES = [("quickstart", []), ("rlvr_async_train", ["--steps", "2"]),
            ("agentic_alfworld_sim", ["--steps", "1"])]


def _flash_counts() -> tuple:
    from repro_torch.kernels import flash_attention as fa
    return fa.flash_attention.launches_fwd, fa.flash_attention.launches_bwd


def _zero_flash() -> None:
    from repro_torch.kernels import flash_attention as fa
    fa.flash_attention.launches_fwd = fa.flash_attention.launches_bwd = 0


def phase_train_critic(rows: list, gpu: str) -> dict:
    """PPO with GAE and a value head (``TrainerConfig(adv_estimator="gae")``)
    on full-width, full-depth Qwen3-1.7B in bf16, as ``phase_train`` runs
    GRPO: 3 rounds of engine rollouts, ``train_on_samples`` on them
    (``ppo``, a reference policy with ``kl_beta``, two minibatches) and a
    weight sync back to the engine, with exact paged and flash launches;
    then ``CRITIC_STEPS`` critic steps on one fixed batch (rewards 1, 0, 1,
    0), whose value loss must fall."""
    import numpy as np
    torch = _torch()
    from repro_torch.algos import LossConfig
    from repro_torch.configs import get_config
    from repro_torch.core.llm_proxy import LLMProxy
    from repro_torch.kernels.paged_decode_attention import paged_decode_attention as pda
    from repro_torch.models import get_api
    from repro_torch.rollout import PagedDecodeEngine
    from repro_torch.train import (HostTrainer, OptConfig, TrainerConfig,
                                   make_critic_train_step, make_logprob_fn)

    _free_device()
    cfg = get_config(TRAIN_ARCH)
    api = get_api(cfg, device=DEVICE)
    torch.cuda.reset_peak_memory_stats()
    tcfg = TrainerConfig(max_seq_len=TRAIN["max_seq_len"], group_size=TRAIN["group"],
                         minibatches=2, adv_estimator="gae")
    trainer = HostTrainer(api, SEED, LossConfig(pg_variant="ppo", kl_beta=1e-3),
                          OptConfig(learning_rate=3e-3, warmup_steps=5), tcfg,
                          ref_params=api.init(SEED + 1))
    if set(trainer.state) != {"params", "value", "opt", "vopt"}:
        raise AssertionError(f"train_critic: state {sorted(trainer.state)}")
    eng = PagedDecodeEngine(api, trainer.get_weights(), num_slots=TRAIN["slots"],
                            max_total_len=TRAIN["max_seq_len"], page_size=16,
                            prefill_chunk=128, temperature=1.0, eos_id=-1, seed=SEED,
                            device=DEVICE)
    _warm(eng)
    proxy = LLMProxy(eng, name="chip_smoke_train_critic")
    proxy.start()
    # prox and ref passes, then a forward and a backward per minibatch step
    want = (cfg.num_layers * (tcfg.minibatches + 2), cfg.num_layers * tcfg.minibatches)
    paged_total, flash_total = 0, [0, 0]
    try:
        for round_ in range(TRAIN["rounds"]):
            decode0 = eng.total_decode_steps
            pda.launches = 0
            results = _rollouts(proxy, _train_tasks(cfg.vocab_size, round_), round_)
            paged, decode_steps = pda.launches, eng.total_decode_steps - decode0
            if paged != cfg.num_layers * decode_steps or not paged:
                raise AssertionError(f"train_critic: {paged} paged launches for "
                                     f"{decode_steps} decode steps x {cfg.num_layers}")
            samples = _to_samples(results, cfg.vocab_size)
            _zero_flash()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = trainer.train_on_samples(samples)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            launches = _flash_counts()
            if launches != want:
                raise AssertionError(f"train_critic: flash launches {launches}, "
                                     f"expected {want}")
            if not all(np.isfinite(v) for v in metrics.values()):
                raise AssertionError(f"train_critic: non-finite metrics {metrics}")
            proxy.suspend()
            proxy.update_weights(trainer.get_weights())
            proxy.resume()
            paged_total += paged
            flash_total = [flash_total[0] + launches[0], flash_total[1] + launches[1]]
            emit("train_critic", gpu=gpu, arch=TRAIN_ARCH, dtype=cfg.dtype,
                 layers=cfg.num_layers, round=round_, samples=len(samples),
                 decode_steps=decode_steps, paged_launches=paged,
                 loss=metrics["loss"], value_loss=metrics["value_loss"],
                 explained_value=metrics["explained_value"],
                 grad_norm=metrics["grad_norm"], kl=metrics["kl"],
                 reward_mean=metrics["reward_mean"], train_on_samples_s=train_s,
                 flash_launches_fwd=launches[0], flash_launches_bwd=launches[1],
                 max_memory_allocated=torch.cuda.max_memory_allocated())
    finally:
        proxy.stop()
    eng.audit_pages()
    if eng.params is not trainer.get_weights():
        raise AssertionError("train_critic: the engine does not hold the trainer's tree")
    del eng, proxy

    # the value head fits the terminal rewards of one fixed batch
    lp_fn = make_logprob_fn(api)
    batch = _train_batch(cfg.vocab_size, np.random.default_rng(SEED + 40),
                         logprobs=lambda t: lp_fn(trainer.state["params"], {"tokens": t}))
    batch["rewards"] = batch["is_positive"].clone()
    step = make_critic_train_step(api, trainer.loss_cfg, OptConfig(**CRITIC_OPT))
    _zero_flash()
    state, vlosses, times = trainer.state, [], []
    for _ in range(CRITIC_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        vlosses.append(float(m["value_loss"]))
        times.append(time.perf_counter() - t0)
        if not np.isfinite(float(m["loss"])):
            raise AssertionError(f"train_critic: non-finite loss {float(m['loss'])}")
    trainer.state = state
    fixed = _flash_counts()
    emit("train_critic_fixed_batch", gpu=gpu, steps=CRITIC_STEPS, batch=list(batch["tokens"].shape),
         rewards=batch["rewards"].tolist(), opt=CRITIC_OPT, value_loss=vlosses,
         step_s=times, flash_launches=list(fixed))
    if fixed != (CRITIC_STEPS * cfg.num_layers, CRITIC_STEPS * cfg.num_layers):
        raise AssertionError(f"train_critic: fixed-batch flash launches {fixed}")
    if not vlosses[-1] < vlosses[0]:
        raise AssertionError(f"train_critic: the value loss did not fall {vlosses}")
    for row, n in ((rows[0], paged_total), (rows[2], flash_total[0]),
                   (rows[3], flash_total[1])):
        row.setdefault("critic_launches", {})["train_critic"] = n
    rows[2]["critic_launches"]["train_critic_per_train_on_samples"] = want[0]
    rows[3]["critic_launches"]["train_critic_per_train_on_samples"] = want[1]
    return {"trainer": trainer, "cfg": cfg}


def _ckpt_samples(vocab: int, seed: int) -> list:
    """``CKPT["samples"]`` samples in groups of ``CKPT["group"]``, seeded
    tokens, rewards 0 / 1."""
    import numpy as np
    from repro_torch.core.types import Sample
    rng = np.random.default_rng(seed)
    out = []
    for g in range(CKPT["samples"] // CKPT["group"]):
        prompt = rng.integers(3, vocab, CKPT["prompt"]).astype(np.int32)
        for j in range(CKPT["group"]):
            r = rng.integers(3, vocab, CKPT["response"]).astype(np.int32)
            out.append(Sample(sample_id=len(out), prompt_id=g, replica_idx=j,
                              prompt_tokens=prompt, response_tokens=r,
                              logprobs=(-rng.random(len(r)) * 3).astype(np.float32),
                              reward=float(j % 2), group_id=g))
    return out


def _bits_equal(a, b) -> bool:
    torch = _torch()
    if not isinstance(a, torch.Tensor):
        return type(a) is type(b) and a == b
    if a.dtype != b.dtype or a.shape != b.shape or a.device != b.device:
        return False
    flat = (lambda t: t.contiguous().reshape(-1).view(torch.uint8))
    return torch.equal(flat(a), flat(b))


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def phase_checkpoint(shared: dict, gpu: str) -> None:
    """(a) The critic trainer state of ``launch/train.py``'s rl_100m after
    one ``train_on_samples``, through ``save_checkpoint`` and ``load_tree``
    into a fresh trainer's state: every leaf bit-identical, and one more
    ``train_on_samples`` from either state gives the same metrics.  (b)
    ``save_tree`` / ``load_tree`` of ``train_critic``'s full-width bf16
    params, bit-identical.  Bytes on disk, save and load seconds; the
    directory is deleted afterwards."""
    import shutil
    import numpy as np
    torch = _torch()
    from repro_torch.algos import LossConfig
    from repro_torch.checkpoint import latest_checkpoint, load_tree, save_checkpoint, save_tree
    from repro_torch.launch.train import build_model_cfg
    from repro_torch.models import get_api
    from repro_torch.train import HostTrainer, OptConfig, TrainerConfig
    from repro_torch.train.optimizer import tree_leaves

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke",
                        "checkpoint")
    shutil.rmtree(root, ignore_errors=True)
    try:
        cfg = build_model_cfg(TRAIN_ARCH, CKPT["preset"])
        api = get_api(cfg, device=DEVICE)
        seq = CKPT["prompt"] + CKPT["response"]

        def trainer(seed):
            return HostTrainer(api, seed, LossConfig(pg_variant="ppo"),
                               OptConfig(learning_rate=3e-3, warmup_steps=5),
                               TrainerConfig(max_seq_len=seq, group_size=CKPT["group"],
                                             adv_estimator="gae"))
        first = trainer(SEED)
        first.train_on_samples(_ckpt_samples(cfg.vocab_size, SEED + 50))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save_checkpoint(os.path.join(root, "critic"), first.state["opt"]["step"],
                               first.state, arch=TRAIN_ARCH, preset=CKPT["preset"])
        save_s = time.perf_counter() - t0
        fresh = trainer(SEED + 1)
        t0 = time.perf_counter()
        loaded = load_tree(latest_checkpoint(os.path.join(root, "critic")), fresh.state)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        want, got = tree_leaves(first.state), tree_leaves(loaded)
        same = sum(_bits_equal(a, b) for a, b in zip(want, got))
        if len(want) != len(got) or same != len(want):
            raise AssertionError(f"checkpoint: {same} of {len(want)} leaves came back "
                                 f"bit-identical ({len(got)} loaded)")
        fresh.state = loaded
        more = _ckpt_samples(cfg.vocab_size, SEED + 51)
        m_first, m_fresh = first.train_on_samples(more), fresh.train_on_samples(more)
        diff = {k: abs(m_first[k] - m_fresh[k]) for k in m_first}
        bad = {k: (m_first[k], m_fresh[k]) for k in m_first
               if not np.isclose(m_fresh[k], m_first[k], **CKPT_TOL)}
        emit("checkpoint", gpu=gpu, case="critic_state", arch=TRAIN_ARCH,
             preset=CKPT["preset"], path=os.path.relpath(path, root), leaves=len(want),
             bit_identical_leaves=same, bytes_on_disk=_dir_bytes(path), save_s=save_s,
             load_s=load_s, next_step_metrics=m_first, next_step_abs_diff=diff)
        if bad:
            raise AssertionError(f"checkpoint: the reloaded state trains differently {bad}")
        del first, fresh, loaded, want, got
        _free_device()

        # (b) train_critic's full-width bf16 params
        params = shared["trainer"].state["params"]
        path = os.path.join(root, "params")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_tree(path, params, meta={"arch": TRAIN_ARCH})
        save_s = time.perf_counter() - t0
        nbytes = _dir_bytes(path)
        t0 = time.perf_counter()
        loaded = load_tree(path, params)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        want, got = tree_leaves(params), tree_leaves(loaded)
        same = sum(_bits_equal(a, b) for a, b in zip(want, got))
        tensor_bytes = sum(t.numel() * t.element_size() for t in want)
        emit("checkpoint", gpu=gpu, case="params_bf16", arch=TRAIN_ARCH,
             dtype=shared["cfg"].dtype, leaves=len(want), bit_identical_leaves=same,
             tensor_bytes=tensor_bytes, bytes_on_disk=nbytes, save_s=save_s, load_s=load_s,
             save_bytes_per_s=nbytes / save_s, load_bytes_per_s=nbytes / load_s)
        if same != len(want) or len(got) != len(want):
            raise AssertionError(f"checkpoint: {same} of {len(want)} param leaves came "
                                 "back bit-identical")
        del loaded, got
    finally:
        shutil.rmtree(root, ignore_errors=True)
    _free_device()


def phase_pipeline_critic(rows: list, gpu: str) -> None:
    """``build_rlvr_pipeline`` with ``PIPE``'s settings and
    ``adv_estimator="gae"`` at alpha = 1, 2 steps: wall per step,
    staleness, exact paged and flash launches, page audits
    (``_run_pipeline``, at ``pipeline_rlvr``'s kernel shapes)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.pipeline import PipelineSettings, build_rlvr_pipeline

    _free_device()
    _torch().cuda.reset_peak_memory_stats()
    pipe = build_rlvr_pipeline(get_config(TRAIN_ARCH),
                               PipelineSettings(async_generation_ratio=1,
                                                adv_estimator="gae", **PIPE),
                               reward_fn=_pipeline_reward, device=DEVICE)
    if set(pipe.trainer.state) != {"params", "value", "opt", "vopt"}:
        raise AssertionError(f"pipeline_critic: trainer state {sorted(pipe.trainer.state)}")
    run = _run_pipeline("pipeline_critic", pipe, 2, gpu, shapes_of="pipeline_rlvr",
                        adv_estimator="gae")
    for row, n in ((rows[0], run["paged_launches"]), (rows[2], run["flash_launches"][0]),
                   (rows[3], run["flash_launches"][1])):
        row.setdefault("critic_launches", {})["pipeline_critic"] = n
    del pipe
    _free_device()


def phase_examples(gpu: str) -> None:
    """The three example twins (``examples/torch/``) as a user runs them,
    on the card, side by side in subprocesses (output to files under
    ``build/chip_smoke/``): each must exit 0."""
    root = os.path.dirname(os.path.abspath(__file__))
    logs = os.path.join(root, "build", "chip_smoke", "examples")
    os.makedirs(logs, exist_ok=True)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)              # each twin finds src/ on its own
    procs = []
    t0 = time.perf_counter()
    try:
        for name, args in EXAMPLES:
            out = open(os.path.join(logs, name + ".out"), "w")
            err = open(os.path.join(logs, name + ".err"), "w")
            procs.append((name, args, out, err, subprocess.Popen(
                [sys.executable, os.path.join("examples", "torch", name + ".py"), *args],
                cwd=root, env=env, stdout=out, stderr=err)))
        deadline = time.monotonic() + 300
        rcs = [p.wait(timeout=max(1.0, deadline - time.monotonic()))
               for *_, p in procs]
    finally:
        for *_, out, err, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            out.close()
            err.close()
    seconds = time.perf_counter() - t0
    for (name, args, *_), rc in zip(procs, rcs):
        with open(os.path.join(logs, name + ".out")) as f:
            stdout = f.read()
        with open(os.path.join(logs, name + ".err")) as f:
            stderr = f.read()
        emit("examples", gpu=gpu, example=f"examples/torch/{name}.py", args=args, exit=rc,
             seconds_all=seconds, last_lines=stdout.strip().splitlines()[-6:])
        if rc != 0:
            raise AssertionError(f"examples: {name} exit {rc}\n{stdout[-2000:]}\n"
                                 f"{stderr[-4000:]}")


# ---------------------------------------------------------------------------
# the VLM (PaliGemma-3B) and enc-dec audio (Seamless-M4T-medium) families
# (slice 12)
# ---------------------------------------------------------------------------

VLM_ARCH = "paligemma-3b"
AUDIO_ARCH = "seamless-m4t-medium"
VLM_PATCHES_SEED = SEED + 240
VLM_MODEL = dict(prompts=(40, 100, 180, 250), max_new=16, rows=(48, 32), steps=16)
VLM_TRAIN = dict(groups=2, group=4, prompt=128, response=128, rounds=2)   # 8 x 256
AUDIO_MODEL = dict(batch=4, tokens=64, prompt=32, steps=32, max_len=1024)
AUDIO_DECODE = dict(batch=16, prompt=64, steps=64, max_len=1024, profile_steps=8)
AUDIO_TRAIN = dict(groups=4, group=4, prompt=128, response=128, rounds=2)  # 16 x 256
# the card's 80 GB less what the allocator and the context keep: a step whose
# peak passes this is reported as not fitting
PEAK_LIMIT_BYTES = 76e9


def _slice12_configs():
    from repro_torch.configs import get_config
    return get_config(VLM_ARCH), get_config(AUDIO_ARCH)


def _slice12_shapes() -> dict:
    """What this slice's phases give the kernels.  "flash": label ->
    (B, H, KV, S, D, dtype, causal); "decode": label -> (B, H, KV, S, D,
    dtype), S the cache's slots (a VLM's widened by its image tokens)."""
    vlm, audio = _slice12_configs()
    p = vlm.num_image_tokens
    text = VLM_TRAIN["prompt"] + VLM_TRAIN["response"]
    vh, vkv, vd = vlm.num_heads, vlm.num_kv_heads, vlm.resolved_head_dim
    ah, akv, ad = audio.num_heads, audio.num_kv_heads, audio.resolved_head_dim
    t = audio.encoder_frames
    n_vlm = VLM_TRAIN["groups"] * VLM_TRAIN["group"]
    n_audio = AUDIO_TRAIN["groups"] * AUDIO_TRAIN["group"]
    return {
        "flash": {
            # train_vlm: 8 samples, 256 image + 256 text positions
            "train_vlm": (n_vlm, vh, vkv, p + text, vd, "bfloat16", True),
            # pipeline_vlm's train step: 16 samples of max_seq_len 64
            "pipeline_vlm": (PIPE["rollout_batch_size"], vh, vkv, p + PIPE["max_seq_len"],
                             vd, "bfloat16", True),
            # train_audio: the encoder over 1024 frames (non-causal) and
            # the decoder over 256 tokens (causal)
            "train_audio_encoder": (n_audio, ah, akv, t, ad, "bfloat16", False),
            "train_audio_decoder": (n_audio, ah, akv, AUDIO_TRAIN["prompt"]
                                    + AUDIO_TRAIN["response"], ad, "bfloat16", True),
            # model_audio's fp32 apply
            "model_audio_encoder": (AUDIO_MODEL["batch"], ah, akv, t, ad, "float32", False),
            "model_audio_decoder": (AUDIO_MODEL["batch"], ah, akv, AUDIO_MODEL["tokens"],
                                    ad, "float32", True),
            # decode_audio's prefill encodes 16 x 1024 frames
            "decode_audio_encoder": (AUDIO_DECODE["batch"], ah, akv, t, ad, "bfloat16",
                                     False),
        },
        "decode": {
            "serve_vlm": (SERVE_SLOT["num_slots"], vh, vkv, SERVE_SLOT["max_total_len"] + p,
                          vd, "bfloat16"),
            "model_vlm": (len(VLM_MODEL["prompts"]), vh, vkv, 512 + p, vd, "float32"),
            "model_vlm_prefix": (len(VLM_MODEL["rows"]), vh, vkv, 64 + p, vd, "float32"),
            "pipeline_vlm": (-(-PIPE["num_slots"] // PIPE["num_rollout_replicas"]), vh, vkv,
                             PIPE["max_seq_len"] + p, vd, "bfloat16"),
            "decode_audio": (AUDIO_DECODE["batch"], ah, akv, AUDIO_DECODE["max_len"], ad,
                             "bfloat16"),
            "model_audio": (AUDIO_MODEL["batch"], ah, akv, AUDIO_MODEL["max_len"], ad,
                            "float32"),
        },
    }


def _flash_repeat_check(label: str, case, causal=False, window=None, softcap=None) -> None:
    """The backward once more on ``_flash_case``'s inputs (made with the same
    ``causal``, ``window`` and ``softcap``): dQ, dK and dV must come out
    bit-identical (the kernels use no atomics)."""
    torch = _torch()
    from repro_torch.kernels import flash_attention as fa
    q, k, v, do, o, lse, grads, _ = case
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, window=window,
                                   softcap=softcap)
    torch.cuda.synchronize()
    same = {name: _bits_equal(x, y) for name, x, y in zip(("dq", "dk", "dv"), grads, again)}
    emit("kernels", kernel="flash_attention_bwd", case=label, check="bitwise_repeat",
         route=fa.route(q.dtype, causal, q.shape[-1]), bit_identical=same)
    if not all(same.values()):
        raise AssertionError(f"flash_attention_bwd {label}: a second run differs: {same}")


def phase_vlm_audio_kernels(rows: list, gpu: str) -> None:
    """The kernels at this slice's shapes against their plain versions:
    flash forward and backward with ``causal=False`` at Seamless' encoder
    shape (B=16, H=KV=16, S=1024, D=64) and at an odd S=300, G=4, D=64,
    bf16 and fp32; dense decode attention at PaliGemma's serve shape
    (B=16, H=8 over KV=1, D=256, S=1024 + 256 image slots) and Seamless'
    (B=16, H=KV=16, D=64, S=1024), each with a length-0 row and a full row,
    bf16 and fp32; and every shape the phases below give either kernel
    (``_slice12_shapes``).  The first eight cases, PaliGemma's train step
    (causal, G=8, D=256, S=512) and Seamless' decoder (causal, S=256) are
    timed into the rows' ``vlm_audio_shapes``.  Every ``causal=False``
    backward and every bf16 one (bf16: the wgmma route; fp32: 3xTF32) runs
    twice and must give the same bits."""
    torch = _torch()
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.ref import decode_attention_ref

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 250)
    shapes = _slice12_shapes()
    vlm, audio = _slice12_configs()
    flash_cases = [
        ("seamless_encoder_noncausal_bf16", 16, 16, 16, 1024, 64, "bfloat16", False),
        ("seamless_encoder_noncausal_fp32", 16, 16, 16, 1024, 64, "float32", False),
        ("odd_noncausal_bf16", 2, 16, 4, 300, 64, "bfloat16", False),
        ("odd_noncausal_fp32", 2, 16, 4, 300, 64, "float32", False),
    ] + [(label, *shape) for label, shape in shapes["flash"].items()]
    timed_flash = ("seamless_encoder_noncausal_bf16", "seamless_encoder_noncausal_fp32",
                   "odd_noncausal_bf16", "odd_noncausal_fp32", "train_vlm",
                   "train_audio_decoder")
    for label, b, h, kv, s, d, dtype, causal in flash_cases:
        case = _flash_case(gen, label, b, h, kv, s, d, getattr(torch, dtype), None, None,
                           causal=causal)
        if not causal or dtype == "bfloat16":
            _flash_repeat_check(label, case, causal)
        if label not in timed_flash:
            del case
            continue
        for row, backward in ((rows[2], False), (rows[3], True)):
            ms, plain, lib, err, bound_ms, bound_by, detail = _flash_times(case, backward,
                                                                           causal)
            row.setdefault("vlm_audio_shapes", {})[label] = {
                "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bound_ms,
                "bound_by": bound_by, "bound_detail": detail, "library_ms": lib,
                "library_call": f"SDPA(is_causal={causal}, enable_gqa=True)"
                                + (" backward alone" if backward else ""),
                "shape": _flash_shape(case[0], case[1], causal)}
        del case

    def decode_case(b, h, kv, s, d, dtype):
        q = torch.randn(b, h, d, generator=gen, device=DEVICE).to(dtype)
        k = torch.randn(b, s, kv, d, generator=gen, device=DEVICE).to(dtype)
        v = torch.randn(b, s, kv, d, generator=gen, device=DEVICE).to(dtype)
        lengths = torch.randint(1, s + 1, (b,), generator=gen, device=DEVICE,
                                dtype=torch.int32)
        lengths[:2] = torch.tensor([0, s], dtype=torch.int32, device=DEVICE)
        return q, k, v, lengths

    s_vlm = SERVE_SLOT["max_total_len"] + vlm.num_image_tokens
    decode_cases = [
        ("paligemma_serve_bf16", 16, vlm.num_heads, vlm.num_kv_heads, s_vlm,
         vlm.resolved_head_dim, "bfloat16"),
        ("paligemma_serve_fp32", 16, vlm.num_heads, vlm.num_kv_heads, s_vlm,
         vlm.resolved_head_dim, "float32"),
        ("seamless_serve_bf16", 16, audio.num_heads, audio.num_kv_heads, 1024,
         audio.resolved_head_dim, "bfloat16"),
        ("seamless_serve_fp32", 16, audio.num_heads, audio.num_kv_heads, 1024,
         audio.resolved_head_dim, "float32"),
    ] + [(label, *shape) for label, shape in shapes["decode"].items()]
    for label, b, h, kv, s, d, dtype in decode_cases:
        q, k, v, lengths = decode_case(b, h, kv, s, d, getattr(torch, dtype))
        out = decode_attention(q, k, v, lengths)
        torch.cuda.synchronize()
        err = _check_close(label, "decode_attention", [out],
                           [decode_attention_ref(q, k, v, lengths)], TOL[dtype])
        if label.endswith(("_serve_bf16", "_serve_fp32")):
            rows[4].setdefault("vlm_audio_shapes", {})[label] = _decode_times(
                q, k, v, lengths, err, "lengths 0, S and ragged")
        del q, k, v, out
    for row in rows[2:5]:
        emit("kernels", kernel=row["name"], case="vlm_audio_shapes", gpu=gpu,
             vlm_audio_shapes=row["vlm_audio_shapes"])
    _free_device()


def _logits_gate(got, want) -> tuple:
    """(ok, max abs diff, scale): fp32 logits of the kernel path against the
    plain path, within ``TOL["float32"]``'s rtol and its atol times the
    largest plain logit (the flash rows' gradient gate)."""
    torch = _torch()
    scale = want.abs().max().item()
    diff = (got - want).abs().max().item()
    tol = TOL["float32"]
    ok = torch.allclose(got, want, rtol=tol["rtol"], atol=tol["atol"] * scale)
    return ok, diff, scale


def phase_model_vlm(rows: list, gpu: str) -> None:
    """fp32 PaliGemma-3B at full width and depth (18 layers, 12.1 GB): two
    slot ``DecodeEngine``s on one set of weights, ``attn_impl="kernel"``
    and ``"ref"``, greedy tokens (text only, as the reference's engine
    serves a VLM; a divergence tolerated only at a top-2 gap below
    ``DENSE_TOP2_TOL``) and exact decode-attention launches; then
    ``api.prefill`` with 256 seeded patches (two rows, one right-padded)
    and 16 ``decode_step``s at ``pos = t + 256``, kernel against ref on the
    same tokens: logits within the fp32 gate (``_logits_gate``)."""
    import dataclasses
    import numpy as np
    torch = _torch()
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.models import get_api

    _free_device()
    cfg = dataclasses.replace(_slice12_configs()[0], dtype="float32")
    api = get_api(cfg, device=DEVICE)
    params = api.init(SEED)
    rng = np.random.default_rng(SEED + 241)
    prompts = [rng.integers(3, cfg.vocab_size, n).astype(np.int32)
               for n in VLM_MODEL["prompts"]]
    results, steps, launches = {}, [], {}
    for impl in ("kernel", "ref"):
        decode_attention.launches = 0
        results[impl] = _slot_greedy(api, params, prompts, VLM_MODEL["max_new"],
                                     steps_out=steps, attn_impl=impl)
        launches[impl] = decode_attention.launches
    divergences = []
    for rid, prompt in enumerate(prompts):
        a, b = results["kernel"][rid][0], results["ref"][rid][0]
        if a != b:
            step = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
            divergences.append({"request": rid, "step": step,
                                "top2_gap": _top2_gap(api, params, list(prompt) + a[:step])})
    want_engine = cfg.num_layers * steps[0]
    emit("model_vlm", arch=VLM_ARCH, gpu=gpu, dtype="float32", check="slot_kernel_vs_ref",
         layers=cfg.num_layers, requests=len(prompts), max_new_tokens=VLM_MODEL["max_new"],
         cache_slots=512 + cfg.num_image_tokens, tokens_identical=not divergences,
         divergences=divergences, decode_steps=steps,
         decode_attention_launches=launches, expected_launches=want_engine)
    bad = [dv for dv in divergences if not dv["top2_gap"] < DENSE_TOP2_TOL]
    if bad or launches != {"kernel": want_engine, "ref": 0} or not steps[0]:
        raise AssertionError(f"model_vlm: divergences {bad}, launches {launches}, "
                             f"expected {want_engine}")

    # prefill with the image prefix, then decode at t + P, kernel vs ref
    p = cfg.num_image_tokens
    n_rows, width = len(VLM_MODEL["rows"]), max(VLM_MODEL["rows"])
    tokens = torch.from_numpy(rng.integers(3, cfg.vocab_size, (n_rows, width))
                              .astype(np.int32)).to(DEVICE)
    valid = torch.zeros((n_rows, width), dtype=torch.bool, device=DEVICE)
    for i, n in enumerate(VLM_MODEL["rows"]):
        valid[i, :n] = True
    gen = torch.Generator(device=DEVICE).manual_seed(VLM_PATCHES_SEED)
    patches = torch.randn(n_rows, p, cfg.d_model, generator=gen, device=DEVICE)
    lengths = valid.sum(dim=1).to(torch.int32)
    logits, feed = {}, []
    decode_attention.launches = 0
    with torch.no_grad():
        for impl in ("ref", "kernel"):
            cache = api.init_cache(n_rows, 64)
            first, cache = api.prefill(params, {"tokens": tokens, "valid": valid,
                                                "patches": patches}, cache, attn_impl=impl)
            out = [first]
            for t in range(VLM_MODEL["steps"]):
                if impl == "ref":
                    feed.append(out[-1].argmax(-1).to(torch.int32))
                step, cache = api.decode_step(params, feed[t], lengths + t + p, cache,
                                              attn_impl=impl)
                out.append(step)
            logits[impl] = torch.stack(out)
            del cache
    kernel_launches = decode_attention.launches
    ok, diff, scale = _logits_gate(logits["kernel"], logits["ref"])
    finite = bool(torch.isfinite(logits["kernel"]).all())
    emit("model_vlm", arch=VLM_ARCH, gpu=gpu, dtype="float32",
         check="prefix_prefill_decode_kernel_vs_ref", image_tokens=p,
         text_lengths=list(VLM_MODEL["rows"]), decode_steps=VLM_MODEL["steps"],
         logits_shape=list(logits["kernel"].shape), max_abs_diff=diff, logit_scale=scale,
         gate={"rtol": TOL["float32"]["rtol"], "atol": f"{TOL['float32']['atol']} x scale"},
         ok=ok and finite, decode_attention_launches=kernel_launches,
         expected_launches=cfg.num_layers * VLM_MODEL["steps"])
    if not (ok and finite) or kernel_launches != cfg.num_layers * VLM_MODEL["steps"]:
        raise AssertionError(f"model_vlm: prefix decode logits differ by {diff} (scale "
                             f"{scale}), {kernel_launches} launches")
    rows[4].setdefault("vlm_audio_launches", {})["model_vlm"] = want_engine + kernel_launches
    del api, params, logits
    _free_device()


def phase_serve_vlm(rows: list, gpu: str) -> None:
    """bf16 PaliGemma-3B at full width and depth behind ``LLMProxy`` over
    the slot ``DecodeEngine`` (16 slots, ``max_total_len`` 1024, a cache
    of 1024 + 256 slots), the ``serve`` task mix, text only: exactly 18
    decode-attention launches per decode step; then ``profile_vlm``."""
    _free_device()
    api, params = phase_serve_slot(rows[4].setdefault("vlm_audio_launches", {}), VLM_ARCH,
                                   "decode_attention", phase="serve_vlm", gpu=gpu,
                                   launches_key="serve_vlm")
    del api, params
    _free_device()


def _seeded_patches(trainer) -> None:
    """Make ``trainer.build_batch`` put seeded N(0, 1) patches (the stubbed
    vision frontend's output, from ``VLM_PATCHES_SEED``) where the
    reference's ``build_batch`` puts zeros.  Zero patches stay exactly zero
    through every layer, and each norm scales their residual gradient by
    rsqrt(eps) = 1000: at PaliGemma's 18 layers it overflows, inf x 0 makes
    the gradient NaN, and every later step runs on NaN weights, in the JAX
    package as here (``tests/test_torch_vlm.py`` pins it)."""
    import numpy as np
    zero_build = trainer.build_batch
    rng = np.random.default_rng(VLM_PATCHES_SEED)

    def build_batch(samples):
        batch = zero_build(samples)
        batch["patches"] = rng.standard_normal(batch["patches"].shape, dtype=np.float32)
        return batch

    trainer.build_batch = build_batch


def phase_train_vlm(rows: list, gpu: str) -> None:
    """``HostTrainer`` on bf16 PaliGemma-3B at full width and depth
    (3.03 B parameters: bf16 weights and grads, fp32 master, m and v),
    ``decoupled_ppo``, no reference policy, on 8 samples x 256 text
    tokens behind 256 seeded image positions (S = 512, ``_seeded_patches``).
    First the train step's loss and gradient (``make_loss_and_grad``, no
    optimizer) on one batch and the initial weights, three ways: bf16
    through the flash kernels, bf16 through plain ``attend``, and plain
    ``attend`` in fp32 on the same weights widened (the witness).  The two
    bf16 routes differ by their rounding, which 18 random-weight layers
    amplify, so each is held against the witness: the kernel route's loss,
    gradient norm and mean ratio within ``TOL["bfloat16"]``'s rtol of it,
    18 flash launches each way on the kernel route, none on the others.
    Then 2 rounds of ``train_on_samples``: exact flash launches
    (18 forward per forward pass, 18 backward per backward: a proximal pass
    and one step per round), every metric finite, ``train_on_samples`` s,
    trained tokens/s, peak memory."""
    import dataclasses
    import types
    import numpy as np
    torch = _torch()
    from repro_torch.algos import LossConfig
    from repro_torch.models import get_api
    from repro_torch.train import HostTrainer, OptConfig, TrainerConfig
    from repro_torch.train.optimizer import global_norm, tree_leaves, tree_map
    from repro_torch.train.trainer import make_loss_and_grad

    _free_device()
    cfg = _slice12_configs()[0]
    api = get_api(cfg, device=DEVICE)
    text = VLM_TRAIN["prompt"] + VLM_TRAIN["response"]
    loss_cfg = LossConfig(pg_variant="decoupled_ppo")
    opt_cfg = OptConfig(learning_rate=1e-5, warmup_steps=1)
    tcfg = TrainerConfig(max_seq_len=text, group_size=VLM_TRAIN["group"])

    # the loss and gradient three ways, before the trainer's optimizer state
    # exists (the fp32 route's activations and gradients need its room)
    params = api.init(SEED)
    batcher = types.SimpleNamespace(api=api, tcfg=tcfg)
    batcher.build_batch = lambda samples: HostTrainer.build_batch(batcher, samples)
    _seeded_patches(batcher)
    samples = _seeded_samples(cfg.vocab_size, VLM_TRAIN, SEED + 242)
    batch = {k: torch.from_numpy(v).to(DEVICE)
             for k, v in batcher.build_batch(samples).items()}
    api32 = get_api(dataclasses.replace(cfg, dtype="float32"), device=DEVICE)
    routes = {}
    for name, route_api, impl in (("kernel", api, "kernel"), ("ref", api, "ref"),
                                  ("fp32_ref", api32, "ref")):
        p, b = params, batch
        if route_api is api32:   # the same weights and patches the bf16 routes see
            p = tree_map(lambda x: x.float(), params)
            b = dict(batch, patches=batch["patches"].to(torch.bfloat16).float())
        _zero_flash()
        loss, metrics, grads = make_loss_and_grad(route_api, loss_cfg, attn_impl=impl)(
            p, b)
        routes[name] = dict(loss=float(loss), grad_norm=float(global_norm(grads)),
                            ratio_mean=float(metrics["ratio_mean"]),
                            flash_launches=list(_flash_counts()))
        del p, b, grads, metrics, loss
        torch.cuda.empty_cache()
    del params, batch
    _free_device()
    rtol = TOL["bfloat16"]["rtol"]
    witness = routes["fp32_ref"]
    rel = {route: {k: abs(routes[route][k] - witness[k]) / abs(witness[k])
                   for k in ("loss", "grad_norm", "ratio_mean")}
           for route in ("kernel", "ref")}
    emit("train_vlm", arch=VLM_ARCH, gpu=gpu, dtype=cfg.dtype, check="kernel_vs_ref",
         batch=[len(samples), text], image_tokens=cfg.num_image_tokens, routes=routes,
         rel_err_to_fp32=rel, rtol=rtol)
    if not all(v <= rtol for v in rel["kernel"].values()) or \
            routes["kernel"]["flash_launches"] != [cfg.num_layers] * 2 or \
            routes["ref"]["flash_launches"] != [0, 0] or \
            routes["fp32_ref"]["flash_launches"] != [0, 0]:
        raise AssertionError(f"train_vlm, kernel vs ref: {routes}, rel {rel}")

    torch.cuda.reset_peak_memory_stats()
    trainer = HostTrainer(api, SEED, loss_cfg, opt_cfg, tcfg, attn_impl="kernel")
    _seeded_patches(trainer)
    torch.cuda.synchronize()
    state_bytes = torch.cuda.memory_allocated()
    n_params = sum(t.numel() for t in tree_leaves(trainer.state["params"]))

    want = (2 * cfg.num_layers, cfg.num_layers)
    rounds = []
    for r in range(VLM_TRAIN["rounds"]):
        samples = _seeded_samples(cfg.vocab_size, VLM_TRAIN, SEED + 242 + r)
        _zero_flash()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = trainer.train_on_samples(samples)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _flash_counts()
        rounds.append(dict(round=r, train_on_samples_s=wall,
                           trained_tokens_per_s=len(samples) * text / wall,
                           flash_launches=list(launches), loss=metrics["loss"],
                           grad_norm=metrics["grad_norm"], ratio_mean=metrics["ratio_mean"]))
        if launches != want or not np.isfinite(list(metrics.values())).all():
            raise AssertionError(f"train_vlm round {r}: flash launches {launches} (expected "
                                 f"{want}), metrics {metrics}")
    peak = torch.cuda.max_memory_allocated()
    emit("train_vlm", arch=VLM_ARCH, gpu=gpu, dtype=cfg.dtype, layers=cfg.num_layers,
         params=n_params, state_bytes=state_bytes, pg_variant="decoupled_ppo",
         batch=[VLM_TRAIN["groups"] * VLM_TRAIN["group"], text],
         image_tokens=cfg.num_image_tokens, flash_seq=cfg.num_image_tokens + text,
         patches="seeded N(0, 1) in place of build_batch's zeros", rounds=rounds,
         expected_flash_launches_per_round=list(want),
         peak_memory_bytes=peak, fits_76gb=peak <= PEAK_LIMIT_BYTES)
    if peak > PEAK_LIMIT_BYTES:
        raise AssertionError(f"train_vlm: peak {peak} bytes over {PEAK_LIMIT_BYTES}")
    rows[2].setdefault("vlm_audio_launches", {})["train_vlm"] = (
        cfg.num_layers + sum(x["flash_launches"][0] for x in rounds))
    rows[3].setdefault("vlm_audio_launches", {})["train_vlm"] = (
        cfg.num_layers + sum(x["flash_launches"][1] for x in rounds))
    del trainer
    _free_device()


def phase_pipeline_vlm(rows: list, gpu: str) -> None:
    """``build_rlvr_pipeline(paligemma-3b)`` with ``PIPE``'s settings at
    alpha = 1, 2 steps: ``auto`` picks the slot engine (two replicas of 8
    slots, text-only rollouts), the trainer the flash kernels on a seeded
    image prefix (``_seeded_patches``) + 64 tokens.  Exact decode-attention
    launches (layers x decode steps) and flash launches per
    ``train_on_samples``, staleness <= 1, versions, every step's loss
    finite, the engines hold the trainer's final tree; peak memory."""
    import numpy as np
    torch = _torch()
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.launch.pipeline import PipelineSettings, build_rlvr_pipeline
    from repro_torch.rollout import DecodeEngine

    _free_device()
    cfg = _slice12_configs()[0]
    torch.cuda.reset_peak_memory_stats()
    s = PipelineSettings(async_generation_ratio=1, **PIPE)
    pipe = build_rlvr_pipeline(cfg, s, reward_fn=_pipeline_reward, device=DEVICE)
    _seeded_patches(pipe.trainer)
    if not all(type(e) is DecodeEngine for e in pipe.engines):
        raise AssertionError(f"pipeline_vlm: engines {[type(e).__name__ for e in pipe.engines]}")
    want_shape = _slice12_shapes()["decode"]["pipeline_vlm"]
    shapes = {(e.num_slots, cfg.num_heads, cfg.num_kv_heads, e.cache.k.shape[2],
               cfg.resolved_head_dim, cfg.dtype) for e in pipe.engines}
    if shapes != {want_shape}:
        raise AssertionError(f"pipeline_vlm: decode shapes {shapes}, checked {want_shape}")
    flash = fa.flash_attention
    per_train, train = [], pipe.controller.train_fn

    def counted(samples):
        f0, b0 = flash.launches_fwd, flash.launches_bwd
        metrics = train(samples)
        per_train.append((flash.launches_fwd - f0, flash.launches_bwd - b0))
        return metrics

    pipe.controller.train_fn = counted
    steps = 2
    decode_attention.launches = 0
    _zero_flash()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = pipe.run(steps, timeout=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    decode_launches = decode_attention.launches
    decode_steps = [e.total_decode_steps for e in pipe.engines]
    want_train = _flash_per_train(cfg.num_layers, s)
    stale = max(st.staleness_max for st in stats)
    final = pipe.trainer.get_weights()
    peak = torch.cuda.max_memory_allocated()
    step_wall = [st.wait_time + st.train_time + st.sync_time for st in stats]
    emit("pipeline_vlm", gpu=gpu, arch=VLM_ARCH, dtype=cfg.dtype, layers=cfg.num_layers,
         alpha=1, weight_sync=s.weight_sync, engine="DecodeEngine",
         replicas=len(pipe.engines), slots_per_replica=pipe.engines[0].num_slots,
         cache_slots=pipe.engines[0].cache.k.shape[2], batch=s.rollout_batch_size,
         steps=steps, wall_s=wall, wall_per_step_s=wall / steps, step_wall_s=step_wall,
         per_step=[dict(step=st.step, wait_s=st.wait_time, train_s=st.train_time,
                        sync_s=st.sync_time, staleness_max=st.staleness_max,
                        reward_mean=st.reward_mean, loss=st.loss) for st in stats],
         decode_steps_per_replica=decode_steps, decode_attention_launches=decode_launches,
         flash_launches_per_train_on_samples=per_train,
         expected_flash_per_train=list(want_train), staleness_max=stale,
         peak_memory_bytes=peak, fits_76gb=peak <= PEAK_LIMIT_BYTES)
    if decode_launches != cfg.num_layers * sum(decode_steps) or not decode_launches:
        raise AssertionError(f"pipeline_vlm: {decode_launches} decode launches for decode "
                             f"steps {decode_steps} x {cfg.num_layers} layers")
    if per_train != [want_train] * steps:
        raise AssertionError(f"pipeline_vlm: flash per train {per_train}, expected "
                             f"{want_train} x {steps}")
    if len(stats) != steps or stale > 1 or pipe.buffer.version != steps:
        raise AssertionError(f"pipeline_vlm: {len(stats)} steps, staleness {stale}, "
                             f"version {pipe.buffer.version}")
    if not all(e.params is final for e in pipe.engines) or \
            not np.isfinite([st.loss for st in stats]).all():
        raise AssertionError("pipeline_vlm: an engine does not hold the final tree, or "
                             f"a loss is not finite: {[st.loss for st in stats]}")
    if pipe.router is None or pipe.router.replicas_alive != len(pipe.engines):
        raise AssertionError("pipeline_vlm: a replica is down")
    if peak > PEAK_LIMIT_BYTES:
        raise AssertionError(f"pipeline_vlm: peak {peak} bytes over {PEAK_LIMIT_BYTES}")
    rows[4].setdefault("vlm_audio_launches", {})["pipeline_vlm"] = decode_launches
    rows[2].setdefault("vlm_audio_launches", {})["pipeline_vlm"] = sum(
        x[0] for x in per_train)
    rows[3].setdefault("vlm_audio_launches", {})["pipeline_vlm"] = sum(
        x[1] for x in per_train)
    del pipe
    _free_device()


def _audio_greedy(api, params, frames, prompt, steps, impl, max_len):
    """Prefill ``prompt`` (B, S) over ``frames`` into a cache of
    ``max_len``, then ``steps`` greedy ``decode_step``s: (tokens (B, steps
    + 1), the top-2 logit gap behind each of them (steps + 1, B))."""
    torch = _torch()
    b, s = prompt.shape
    cache = api.init_cache(b, max_len)
    with torch.no_grad():
        logits, cache = api.prefill(params, {"frames": frames, "tokens": prompt}, cache,
                                    attn_impl=impl)
        toks, gaps = [], []
        for t in range(steps + 1):
            top = torch.topk(logits, 2, dim=-1).values
            gaps.append(top[:, 0] - top[:, 1])
            toks.append(logits.argmax(-1).to(torch.int32))
            if t == steps:
                break
            pos = torch.full((b,), s + t, dtype=torch.int32, device=DEVICE)
            logits, cache = api.decode_step(params, toks[-1], pos, cache, attn_impl=impl)
    return torch.stack(toks, dim=1), torch.stack(gaps)


def phase_model_audio(rows: list, gpu: str) -> None:
    """fp32 Seamless-M4T-medium at full width and depth (12 + 12 layers,
    0.98 B parameters) on seeded frames (B=4, T=1024): ``apply`` kernel
    against ref (the encoder's flash with ``causal=False``, the decoder's
    causal; exactly 24 forward launches), logits within the fp32 gate;
    then a 32-token prefill and 32 greedy ``decode_step``s each way, greedy
    tokens identical but at a top-2 gap below ``DENSE_TOP2_TOL`` (exactly
    12 non-causal flash launches in the kernel prefill, 12 decode-attention
    launches per step)."""
    import dataclasses
    import numpy as np
    torch = _torch()
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.models import get_api
    from repro_torch.train.optimizer import tree_leaves

    _free_device()
    cfg = dataclasses.replace(_slice12_configs()[1], dtype="float32")
    api = get_api(cfg, device=DEVICE)
    params = api.init(SEED)
    n_params = sum(t.numel() for t in tree_leaves(params))
    rng = np.random.default_rng(SEED + 243)
    b = AUDIO_MODEL["batch"]
    frames = torch.from_numpy(rng.standard_normal((b, cfg.encoder_frames, cfg.d_model),
                                                  dtype=np.float32)).to(DEVICE)
    tokens = torch.from_numpy(rng.integers(3, cfg.vocab_size, (b, AUDIO_MODEL["tokens"]))
                              .astype(np.int32)).to(DEVICE)
    out, launches = {}, {}
    with torch.no_grad():
        for impl in ("kernel", "ref"):
            _zero_flash()
            out[impl], _ = api.apply(params, {"frames": frames, "tokens": tokens},
                                     attn_impl=impl)
            launches[impl] = _flash_counts()
    ok, diff, scale = _logits_gate(out["kernel"], out["ref"])
    want_apply = (cfg.num_encoder_layers + cfg.num_layers, 0)
    emit("model_audio", arch=AUDIO_ARCH, gpu=gpu, dtype="float32", check="apply_kernel_vs_ref",
         encoder_layers=cfg.num_encoder_layers, decoder_layers=cfg.num_layers,
         params=n_params, frames=list(frames.shape), tokens=list(tokens.shape),
         max_abs_diff=diff, logit_scale=scale, ok=ok,
         finite=bool(torch.isfinite(out["kernel"]).all()),
         flash_launches={k: list(v) for k, v in launches.items()},
         expected_kernel_flash_launches=list(want_apply))
    if not ok or launches != {"kernel": want_apply, "ref": (0, 0)}:
        raise AssertionError(f"model_audio apply: diff {diff} (scale {scale}), flash "
                             f"launches {launches}")
    del out

    prompt = tokens[:, :AUDIO_MODEL["prompt"]]
    steps = AUDIO_MODEL["steps"]
    toks, gaps, counts = {}, {}, {}
    for impl in ("kernel", "ref"):
        _zero_flash()
        decode_attention.launches = 0
        toks[impl], gaps[impl] = _audio_greedy(api, params, frames, prompt, steps, impl,
                                               AUDIO_MODEL["max_len"])
        counts[impl] = (_flash_counts()[0], decode_attention.launches)
    divergences = []
    for row in range(b):
        a, r = toks["kernel"][row].tolist(), toks["ref"][row].tolist()
        if a != r:
            step = next(i for i, (x, y) in enumerate(zip(a, r)) if x != y)
            divergences.append({"row": row, "step": step,
                                "top2_gap": float(gaps["ref"][step, row])})
    want = {"kernel": (cfg.num_encoder_layers, cfg.num_layers * steps), "ref": (0, 0)}
    emit("model_audio", arch=AUDIO_ARCH, gpu=gpu, dtype="float32",
         check="greedy_kernel_vs_ref", prompt_tokens=AUDIO_MODEL["prompt"],
         decode_steps=steps, cache_len=AUDIO_MODEL["max_len"],
         tokens_identical=not divergences, divergences=divergences,
         min_top2_gap=float(gaps["ref"].min()),
         launches={k: {"flash_fwd": v[0], "decode_attention": v[1]}
                   for k, v in counts.items()},
         expected={k: {"flash_fwd": v[0], "decode_attention": v[1]} for k, v in want.items()})
    bad = [dv for dv in divergences if not dv["top2_gap"] < DENSE_TOP2_TOL]
    if bad or counts != want:
        raise AssertionError(f"model_audio greedy: divergences {bad}, launches {counts}")
    rows[2].setdefault("vlm_audio_launches", {})["model_audio"] = (
        launches["kernel"][0] + counts["kernel"][0])
    rows[4].setdefault("vlm_audio_launches", {})["model_audio"] = counts["kernel"][1]
    del api, params, frames
    _free_device()


def phase_decode_audio(rows: list, gpu: str) -> None:
    """bf16 Seamless-M4T-medium, full depth: 16 rows of seeded frames
    (T=1024) and 64-token prompts through ``api.prefill``, then 64 greedy
    ``api.decode_step``s (the reference has no engine for the family: the
    api is its path).  Exactly 12 decode-attention launches per step and 12
    non-causal flash launches in the prefill; decoded tokens/s; then a
    profiled window of 8 more steps: host wall, device busy, idle share,
    launches per step."""
    import numpy as np
    torch = _torch()
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.models import get_api

    _free_device()
    cfg = _slice12_configs()[1]
    api = get_api(cfg, device=DEVICE)
    params = api.init(SEED)
    rng = np.random.default_rng(SEED + 244)
    b, s, steps = AUDIO_DECODE["batch"], AUDIO_DECODE["prompt"], AUDIO_DECODE["steps"]
    frames = torch.from_numpy(rng.standard_normal((b, cfg.encoder_frames, cfg.d_model),
                                                  dtype=np.float32)).to(DEVICE)
    prompt = torch.from_numpy(rng.integers(3, cfg.vocab_size, (b, s))
                              .astype(np.int32)).to(DEVICE)
    # warm-up outside the count: one short prefill and step (cuBLAS, the kernels' load)
    _audio_greedy(api, params, frames[:1], prompt[:1, :8], 1, "kernel", 64)
    cache = api.init_cache(b, AUDIO_DECODE["max_len"])
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in (cache.self_kv.k, cache.self_kv.v, cache.cross_k, cache.cross_v))
    _zero_flash()
    decode_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, cache = api.prefill(params, {"frames": frames, "tokens": prompt}, cache,
                                    attn_impl="kernel")
        token = logits.argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        decoded = [token]
        for t in range(steps):
            pos = torch.full((b,), s + t, dtype=torch.int32, device=DEVICE)
            logits, cache = api.decode_step(params, token, pos, cache, attn_impl="kernel")
            token = logits.argmax(-1).to(torch.int32)
            decoded.append(token)
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    flash_fwd, launches = _flash_counts()[0], decode_attention.launches
    toks = torch.stack(decoded, dim=1)
    ok = bool(((toks >= 0) & (toks < cfg.vocab_size)).all()) and \
        bool(torch.isfinite(logits).all())

    state = {"pos": s + steps, "token": token}

    def one_step():
        pos = torch.full((b,), state["pos"], dtype=torch.int32, device=DEVICE)
        with torch.no_grad():
            out, _ = api.decode_step(params, state["token"], pos, cache, attn_impl="kernel")
        state["token"] = out.argmax(-1).to(torch.int32)
        state["pos"] += 1

    n = AUDIO_DECODE["profile_steps"]
    w0 = time.perf_counter()
    for _ in range(n):
        one_step()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - w0) / n
    busy_ms, kernel_ms, per_step, profiled_ms, top = _device_busy(one_step, n,
                                                                  kernel="decode_kernel")
    emit("decode_audio", arch=AUDIO_ARCH, gpu=gpu, dtype=cfg.dtype,
         encoder_layers=cfg.num_encoder_layers, decoder_layers=cfg.num_layers,
         batch=b, frames=cfg.encoder_frames, prompt_tokens=s, decode_steps=steps,
         cache_bytes=cache_bytes, prefill_s=t1 - t0, decode_s=t2 - t1,
         decode_tokens_per_s=b * steps / (t2 - t1), mean_step_ms=1e3 * (t2 - t1) / steps,
         decode_attention_launches=launches, expected_launches=cfg.num_layers * steps,
         prefill_flash_launches=flash_fwd, expected_flash=cfg.num_encoder_layers,
         tokens_ok=ok)
    emit("profile_audio", window=f"decode-only steps, {b} rows", steps=n,
         host_wall_ms_per_step=wall_ms, profiled_wall_ms_per_step=profiled_ms,
         device_busy_ms_per_step=busy_ms, device_idle_share=max(0.0, 1 - busy_ms / wall_ms),
         kernel="decode_kernel", kernel_ms_per_step=kernel_ms, launches_per_step=per_step,
         top_kernels_ms_per_step=top, arch=AUDIO_ARCH, gpu=gpu)
    if launches != cfg.num_layers * steps or flash_fwd != cfg.num_encoder_layers or not ok:
        raise AssertionError(f"decode_audio: {launches} decode launches (expected "
                             f"{cfg.num_layers * steps}), {flash_fwd} flash, tokens ok {ok}")
    if not kernel_ms > 0:
        raise AssertionError("decode_audio: the profiler saw no decode_kernel time")
    rows[4].setdefault("vlm_audio_launches", {})["decode_audio"] = launches
    rows[2].setdefault("vlm_audio_launches", {})["decode_audio"] = flash_fwd
    del api, params, cache, frames
    _free_device()


def phase_train_audio(rows: list, gpu: str) -> None:
    """``HostTrainer`` on bf16 Seamless-M4T-medium at full width and depth,
    ``decoupled_ppo``: 2 rounds of 16 samples x 256 tokens with the
    reference's zero frames (T=1024).  Exactly 24 flash forward launches
    per forward pass (12 non-causal in the encoder, 12 causal in the
    decoder) and 24 backward per backward pass; ``train_on_samples`` s,
    trained tokens/s, peak memory."""
    import numpy as np
    torch = _torch()
    from repro_torch.algos import LossConfig
    from repro_torch.models import get_api
    from repro_torch.train import HostTrainer, OptConfig, TrainerConfig
    from repro_torch.train.optimizer import tree_leaves

    _free_device()
    cfg = _slice12_configs()[1]
    api = get_api(cfg, device=DEVICE)
    seq = AUDIO_TRAIN["prompt"] + AUDIO_TRAIN["response"]
    torch.cuda.reset_peak_memory_stats()
    trainer = HostTrainer(api, SEED, LossConfig(pg_variant="decoupled_ppo"),
                          OptConfig(learning_rate=1e-5, warmup_steps=1),
                          TrainerConfig(max_seq_len=seq, group_size=AUDIO_TRAIN["group"]),
                          attn_impl="kernel")
    n_params = sum(t.numel() for t in tree_leaves(trainer.state["params"]))
    per_pass = cfg.num_encoder_layers + cfg.num_layers
    want = (2 * per_pass, per_pass)
    rounds = []
    for r in range(AUDIO_TRAIN["rounds"]):
        samples = _seeded_samples(cfg.vocab_size, AUDIO_TRAIN, SEED + 245 + r)
        _zero_flash()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = trainer.train_on_samples(samples)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _flash_counts()
        rounds.append(dict(round=r, train_on_samples_s=wall,
                           trained_tokens_per_s=len(samples) * seq / wall,
                           flash_launches=list(launches), loss=metrics["loss"],
                           grad_norm=metrics["grad_norm"]))
        if launches != want or not all(np.isfinite([metrics["loss"], metrics["grad_norm"]])):
            raise AssertionError(f"train_audio round {r}: flash launches {launches} "
                                 f"(expected {want}), metrics {metrics}")
    peak = torch.cuda.max_memory_allocated()
    emit("train_audio", arch=AUDIO_ARCH, gpu=gpu, dtype=cfg.dtype,
         encoder_layers=cfg.num_encoder_layers, decoder_layers=cfg.num_layers,
         params=n_params, pg_variant="decoupled_ppo",
         batch=[AUDIO_TRAIN["groups"] * AUDIO_TRAIN["group"], seq],
         frames=cfg.encoder_frames, rounds=rounds,
         expected_flash_launches_per_round=list(want), peak_memory_bytes=peak)
    rows[2].setdefault("vlm_audio_launches", {})["train_audio"] = sum(
        x["flash_launches"][0] for x in rounds)
    rows[3].setdefault("vlm_audio_launches", {})["train_audio"] = sum(
        x["flash_launches"][1] for x in rounds)
    del trainer
    _free_device()


# ---------------------------------------------------------------------------
# fp32 apply at every group (slice 15: the fp32 flash route's redesign)
# ---------------------------------------------------------------------------

# the archs whose fp32 group the first fp32 flash route refused, and their
# batch: (rows, tokens); RecurrentGemma-9B's sequence is longer than its
# window of 2,048, PaliGemma-3B's 256 image positions go before its tokens
FP32_APPLY = {VLM_ARCH: (2, 256), HYBRID_ARCH: (1, 2304), MOE_ARCH: (2, 256),
              DBRX_ARCH: (2, 256)}


def _attention_depth(cfg) -> int:
    """The fewest layers that include an attention layer: 1, or through the
    hybrid's first attention layer."""
    from repro_torch.models import transformer
    kinds = [kind for kind, _ in transformer.layer_kinds(cfg)]
    return kinds.index("attn") + 1


def phase_model_fp32_flash(rows: list, gpu: str) -> None:
    """fp32 ``api.apply`` with ``attn_impl="kernel"`` against ``"ref"`` at the
    four archs whose group the first fp32 flash route refused (PaliGemma-3B
    8 x 256 with seeded patches, RecurrentGemma-9B 16 x 256 over 2,304
    tokens and its window of 2,048, Qwen3-MoE-235B-A22B 16 x 128,
    DBRX-132B 6 x 128), each at full width, cut in depth to the fewest
    layers that include an attention layer (``_attention_depth``), weights
    from ``SEED``: logits within rtol 2e-5 and atol 2e-5 x max |logit|
    (``_logits_gate``), and exactly one flash forward per attention layer
    on the kernel path, none on the plain one."""
    import dataclasses

    import numpy as np
    torch = _torch()
    from repro_torch.configs import get_config
    from repro_torch.models import get_api, transformer

    out_rows = {}
    for arch, (n, t) in FP32_APPLY.items():
        _free_device()
        full = get_config(arch)
        cfg = dataclasses.replace(full, num_layers=_attention_depth(full), dtype="float32")
        n_attn = sum(kind == "attn" for kind, _ in transformer.layer_kinds(cfg))
        api = get_api(cfg, device=DEVICE)
        params = api.init(SEED)
        rng = np.random.default_rng(SEED + 260)
        batch = {"tokens": torch.from_numpy(rng.integers(3, cfg.vocab_size, (n, t))
                                            .astype(np.int32)).to(DEVICE)}
        if cfg.family == "vlm":
            gen = torch.Generator(device=DEVICE).manual_seed(VLM_PATCHES_SEED)
            batch["patches"] = torch.randn(n, cfg.num_image_tokens, cfg.d_model,
                                           generator=gen, device=DEVICE)
        logits, launches = {}, {}
        with torch.no_grad():
            for impl in ("kernel", "ref"):
                _zero_flash()
                logits[impl], _ = api.apply(params, batch, attn_impl=impl)
                torch.cuda.synchronize()
                launches[impl] = _flash_counts()
        ok, diff, scale = _logits_gate(logits["kernel"], logits["ref"])
        group = cfg.num_heads // cfg.num_kv_heads
        record = {"layers": cfg.num_layers, "attention_layers": n_attn,
                  "group": [group, cfg.resolved_head_dim], "window": cfg.sliding_window,
                  "batch": [n, logits["ref"].shape[1]], "max_abs_diff": diff,
                  "logit_scale": scale, "ok": ok,
                  "finite": bool(torch.isfinite(logits["kernel"]).all()),
                  "flash_launches": {k: list(v) for k, v in launches.items()}}
        emit("model_fp32_flash", arch=arch, gpu=gpu, dtype="float32",
             check="apply_kernel_vs_ref", **record)
        out_rows[arch] = record
        del logits, params, api
        if not (ok and record["finite"]) or launches != {"kernel": (n_attn, 0),
                                                         "ref": (0, 0)}:
            raise AssertionError(f"model_fp32_flash {arch}: diff {diff} (scale {scale}), "
                                 f"flash launches {launches}, expected ({n_attn}, 0)")
    rows[2]["fp32_apply"] = out_rows
    _free_device()


# ---------------------------------------------------------------------------
# the concurrency analysis and the sharding plan / dry-run (slice 13)
# ---------------------------------------------------------------------------

DRYRUN_TIMEOUT_S = 300
# the in-process plan held against the card: Qwen3-4B's decode step at the
# serve shape, on a 1x1 mesh
DRYRUN_CARD = dict(arch=ARCH, batch=SERVE["num_slots"], seq_len=SERVE["max_total_len"])
# the one (arch, shape) whose partitioned temp and peak bytes may be null:
# RWKV-6's train step, whose plain WKV scan is not traced at full length
DRYRUN_TEMP_EXCUSED = ("rwkv6-3b", "train_4k")
# the caching allocator's blocks: a request is rounded up to 512 bytes, and
# a block it splits from a cached segment keeps the segment's remainder when
# that is too small to split off (< 512 bytes in the small-block pool, up to
# 1 MiB in the large one, for requests over 1 MiB)
ALLOC_ROUND = 512
ALLOC_LARGE = 1 << 20
# the sanitized pipeline: Qwen3-1.7B at full width, 4 of its 28 layers,
# bf16, two replicas of 8 slots, alpha = 1, 2 RL steps
SANITIZE_LAYERS = 4
SANITIZE_STEPS = 2
SANITIZE_HOLD_S = 0.05


def _dryrun_clis(runs: dict) -> dict:
    """``python -m repro_torch.launch.dryrun`` once per ``{log name:
    args}``, as a user runs it, all started together (stdout and stderr to
    files under ``build/chip_smoke/``); each exit code must be 0.  Returns
    ``{log name: (stdout, seconds)}``."""
    root = os.path.dirname(os.path.abspath(__file__))
    logs = os.path.join(root, "build", "chip_smoke")
    os.makedirs(logs, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    procs, out = {}, {}
    t0 = time.perf_counter()
    try:
        for name, args in runs.items():
            with open(os.path.join(logs, name + ".out"), "w") as so, \
                    open(os.path.join(logs, name + ".err"), "w") as se:
                procs[name] = subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.dryrun", *args],
                    cwd=root, env=env, stdout=so, stderr=se)
        deadline = time.monotonic() + DRYRUN_TIMEOUT_S
        while len(out) < len(procs):
            if time.monotonic() > deadline:
                raise TimeoutError(f"dryrun: not done in {DRYRUN_TIMEOUT_S} s")
            for name, proc in procs.items():
                rc = proc.poll()
                if name in out or rc is None:
                    continue
                with open(os.path.join(logs, name + ".out")) as f:
                    stdout = f.read()
                if rc != 0:
                    with open(os.path.join(logs, name + ".err")) as f:
                        raise AssertionError(f"dryrun {runs[name]}: exit {rc}\n"
                                             f"{stdout[-3000:]}\n{f.read()[-3000:]}")
                out[name] = (stdout, time.perf_counter() - t0)
            time.sleep(0.1)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def phase_dryrun(gpu: str) -> None:
    """The dry-run as a user runs it — every arch x shape x mesh (16x16 and
    2x16x16 over the fake process group; the combos whose step ran on
    DTensors there, and DTensor's refusals of the others, counted by
    reason), and beside it the pools — and the 1x1
    plan of Qwen3-4B's decode step at the serve shape held against the
    card: the params and cache it plans, materialised, must request
    exactly its ``argument_bytes`` of the caching allocator and be
    allocated that within the allocator's rounding (``ALLOC_ROUND``,
    ``ALLOC_LARGE``), and one decode step's peak is printed against its
    ``peak_bytes``."""
    import dataclasses
    import glob

    torch = _torch()
    from repro_torch.configs import InputShape, get_config
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.kernels import decode_attention as da
    from repro_torch.launch import dryrun
    from repro_torch.models import get_api

    runs = _dryrun_clis({"dryrun_all": ["--all", "--mesh", "both"],
                         "dryrun_pools": ["--pools"]})
    stdout, seconds = runs["dryrun_all"]
    summary = next(line for line in stdout.splitlines() if line.startswith("=== dry-run"))
    ok, skipped, failed, nulls = map(int, re.match(
        r"=== dry-run: (\d+) ok, (\d+) skipped .*?, (\d+) failed; (\d+) numbers null",
        summary).groups())
    counts = dict(ok=ok, skipped=skipped, failed=failed, nulls=nulls)
    recs = []
    for path in glob.glob(os.path.join(dryrun.OUT_DIR, "*__*__*.json")):
        with open(path) as f:
            rec = json.load(f)
        if rec["mesh"] in ("single", "multi"):
            recs.append(rec)
    if failed or ok != sum(r["status"] == "ok" for r in recs):
        raise AssertionError(f"dryrun: {counts}, {len(recs)} records")
    largest = {}
    for rec in recs:
        if rec["status"] != "ok":
            continue
        mem = rec["memory"]
        cur = largest.setdefault(rec["shape"], {"peak_bytes": None, "argument_bytes": 0,
                                                "peak_null": 0, "of": 0})
        cur["of"] += 1
        if mem["peak_bytes"] is None:
            cur["peak_null"] += 1
        else:
            cur["peak_bytes"] = max(cur["peak_bytes"] or 0, mem["peak_bytes"])
        if mem["argument_bytes"] > cur["argument_bytes"]:
            cur.update(argument_bytes=mem["argument_bytes"],
                       argument_at=f"{rec['arch']} {rec['mesh']}")
    # the partitioned runs (DTensors over the fake group): every record the
    # reference fills is filled — temp, peak, collectives, bytes accessed —
    # but RWKV-6's train temp (its null names what is missing)
    partitioned, missing, null_reasons = {}, [], {}
    for rec in recs:
        if rec["status"] != "ok":
            continue
        for why in rec["nulls"].values():
            null_reasons[why] = null_reasons.get(why, 0) + 1
        excused = ({"temp_bytes", "peak_bytes"}
                   if (rec["arch"], rec["shape"]) == DRYRUN_TEMP_EXCUSED else set())
        values = {"temp_bytes": rec["memory"]["temp_bytes"],
                  "peak_bytes": rec["memory"]["peak_bytes"],
                  "collectives": rec["collectives"], "bytes_accessed": rec["bytes_accessed"]}
        missing += [f"{rec['arch']} {rec['shape']} {rec['mesh']} {k}"
                    for k, v in values.items() if v is None and k not in excused]
        coll = rec["collectives"] or {}
        partitioned[f"{rec['arch']} {rec['shape']} {rec['mesh']}"] = [
            rec["memory"]["peak_bytes"], sum(coll.get(k, 0) for k in dryrun._COLLECTIVES),
            coll.get("count"), rec["partitioned_s"]]
    if missing:
        raise AssertionError(f"dryrun: null where the reference has a number: {missing}")
    emit("dryrun", gpu=gpu, command="python -m repro_torch.launch.dryrun --all --mesh both",
         seconds=seconds, summary=summary, **counts, torch=torch.__version__,
         largest_per_device_by_shape=largest, nulls_by_reason=null_reasons,
         partitioned_fields="[peak_bytes, collective bytes, collectives, seconds]",
         partitioned=partitioned)

    with open(os.path.join(dryrun.OUT_DIR, "pools__qwen3-8b.json")) as f:
        pools = json.load(f)
    if pools["status"] != "ok":
        raise AssertionError(f"dryrun pools: {pools}")
    emit("dryrun_pools", gpu=gpu, seconds=runs["dryrun_pools"][1], **pools)

    # the 1x1 plan, held against the card
    cfg = get_config(DRYRUN_CARD["arch"])
    shape = InputShape("serve", DRYRUN_CARD["seq_len"], DRYRUN_CARD["batch"], "decode")
    t0 = time.perf_counter()
    plan = dryrun.run_combo(cfg.arch_id, "serve", "host", shape=shape, save=False,
                            verbose=False)
    plan_s = time.perf_counter() - t0
    if plan["status"] != "ok":
        raise AssertionError(f"dryrun 1x1 plan: {plan.get('error')}\n{plan.get('traceback')}")
    _free_device()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    requested = torch.cuda.memory_stats()["requested_bytes.all.current"]
    api = get_api(cfg, device=DEVICE)
    params = api.init(SEED)
    cache = api.init_cache(shape.global_batch, shape.seq_len)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 130)
    token = torch.randint(0, cfg.vocab_size, (shape.global_batch,), generator=gen,
                          device=DEVICE, dtype=torch.int32)
    pos = torch.full((shape.global_batch,), shape.seq_len - 1, dtype=torch.int32,
                     device=DEVICE)
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - base
    requested = torch.cuda.memory_stats()["requested_bytes.all.current"] - requested
    tensors = tree_leaves(params) + _tensors(cache) + [token, pos]
    large = sum(t.nbytes > ALLOC_LARGE for t in tensors)
    bound = ALLOC_ROUND * (len(tensors) - large) + (ALLOC_LARGE + ALLOC_ROUND) * large
    want = plan["memory"]["argument_bytes"]
    if requested != want or not 0 <= grown - want <= bound:
        raise AssertionError(f"dryrun: requested {requested} bytes, allocated {grown}, "
                             f"plan {want}, bound {bound}")
    torch.cuda.reset_peak_memory_stats()
    da.decode_attention.launches = 0
    with torch.no_grad():
        logits, _ = api.decode_step(params, token, pos, cache, attn_impl=plan["attn_impl"])
    torch.cuda.synchronize()
    launches = da.decode_attention.launches
    peak = torch.cuda.max_memory_allocated() - base
    if tuple(logits.shape) != (shape.global_batch, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError("dryrun: the planned decode step's logits")
    if plan["attn_impl"] == "kernel" and launches != cfg.num_layers:
        raise AssertionError(f"dryrun: {launches} decode launches, {cfg.num_layers} layers")
    emit("dryrun_card", gpu=gpu, arch=cfg.arch_id, shape=dataclasses.asdict(shape),
         mesh="1x1", plan_s=plan_s, attn_impl=plan["attn_impl"],
         plan_argument_bytes=want, requested_bytes=requested, allocated_bytes=grown,
         tensors=len(tensors), large_tensors=large,
         bound=(f"requested == argument_bytes; allocated - argument_bytes in [0, "
                f"{ALLOC_ROUND} x small + {ALLOC_LARGE + ALLOC_ROUND} x large = {bound}]"),
         plan_temp_bytes=plan["memory"]["temp_bytes"],
         plan_peak_bytes=plan["memory"]["peak_bytes"], max_allocated_bytes=peak,
         max_allocated_over_plan_peak=peak / plan["memory"]["peak_bytes"],
         decode_launches=launches, plan_flops=plan["flops"])
    del api, params, cache, logits
    _free_device()


def phase_sanitize(gpu: str) -> None:
    """``build_rlvr_pipeline`` built under the port's runtime lock sanitizer
    (tracked locks from ``sanitizer.enable(True)`` to the end of the build;
    ``enable(False)`` after it, so no other phase gets tracked locks) on
    full-width Qwen3-1.7B cut to 4 of its 28 layers, bf16, two replicas of 8
    slots, alpha = 1, run for 2 RL steps: the tracked locks, the lock-order
    edges, the inversions (none allowed), every hold longer than 50 ms
    (``REPRO_SANITIZE_HOLD_S``=0.05) by lock, and the runtime edges the
    static graph of ``python -m repro_torch.analysis.concheck`` lacks."""
    import dataclasses

    torch = _torch()
    from repro_torch.analysis import sanitizer
    from repro_torch.configs import get_config
    from repro_torch.launch.pipeline import PipelineSettings, build_rlvr_pipeline

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), num_layers=SANITIZE_LAYERS)
    _free_device()
    sanitizer.reset()
    threshold = sanitizer.REGISTRY.hold_threshold_s
    sanitizer.REGISTRY.hold_threshold_s = SANITIZE_HOLD_S
    sanitizer.enable(True)
    try:
        pipe = build_rlvr_pipeline(cfg, PipelineSettings(async_generation_ratio=1, **PIPE),
                                   reward_fn=_pipeline_reward, device=DEVICE)
    finally:
        sanitizer.enable(False)
    try:
        t0 = time.perf_counter()
        stats = pipe.run(SANITIZE_STEPS)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    finally:
        sanitizer.REGISTRY.hold_threshold_s = threshold
    del pipe
    rep = sanitizer.report()
    graph = sanitizer.graph_json()
    holds = {}
    for h in rep["long_holds"]:
        cur = holds.setdefault(h["lock"], {"count": 0, "longest_ms": 0.0})
        cur["count"] += 1
        cur["longest_ms"] = max(cur["longest_ms"], h["held_s"] * 1e3)

    root = os.path.dirname(os.path.abspath(__file__))
    static_path = os.path.join(root, "build", "chip_smoke", "concheck_graph.json")
    os.makedirs(os.path.dirname(static_path), exist_ok=True)
    cc = subprocess.run([sys.executable, "-m", "repro_torch.analysis.concheck",
                         "--graph-out", static_path], cwd=root, capture_output=True,
                        text=True, timeout=120,
                        env=dict(os.environ, PYTHONPATH=os.path.join(root, "src")))
    if cc.returncode != 0:
        raise AssertionError(f"concheck exit {cc.returncode}\n{cc.stdout[-3000:]}")
    with open(static_path) as f:
        static = json.load(f)
    static_edges = {(e["from"], e["to"]) for e in static["edges"]}
    missing = sorted(f"{e['from']} -> {e['to']}" for e in graph["edges"]
                     if (e["from"], e["to"]) not in static_edges)
    emit("sanitize", gpu=gpu, arch=cfg.arch_id, layers=cfg.num_layers, steps=len(stats),
         run_s=run_s, tracked_locks=sorted(set(graph["nodes"]) | set(rep["max_hold_s"])),
         acquisitions=rep["acquisitions"],
         edges=rep["edges"], inversions=rep["inversions"],
         hold_threshold_s=SANITIZE_HOLD_S, long_holds=holds,
         max_hold_ms={k: v * 1e3 for k, v in rep["max_hold_s"].items()},
         static_graph={"locks": len(static["nodes"]), "edges": len(static["edges"])},
         runtime_edges_not_in_static_graph=missing)
    if len(stats) != SANITIZE_STEPS:
        raise AssertionError(f"sanitize: {len(stats)} steps of {SANITIZE_STEPS}")
    if rep["inversions"]:
        raise AssertionError(f"sanitize: lock-order inversions {rep['inversions']}")
    if not rep["max_hold_s"]:
        raise AssertionError("sanitize: no lock was tracked")
    sanitizer.reset()
    _free_device()


def _device_us(evt) -> float:
    for name in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _device_busy(fn, iters: int, kernel="paged_decode_kernel"):
    """Per call of ``fn`` (run ``iters`` times under ``torch.profiler``):
    (device busy ms, ms of the CUDA kernels whose name holds ``kernel`` —
    for a tuple of names, {name: ms} —, launches, host wall ms, the ten
    kernels that took the most device ms as [name, ms])."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        _torch().cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / iters
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3 / iters
    by_name = {k: sum(_device_us(e) for e in kernels if k in e.name) / 1e3 / iters
               for k in ((kernel,) if isinstance(kernel, str) else kernel)}
    kernel_ms = by_name[kernel] if isinstance(kernel, str) else by_name
    launches = sum(1 for e in events
                   if e.name in ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx"))
    names: dict = {}
    for e in kernels:
        names[e.name] = names.get(e.name, 0.0) + _device_us(e) / 1e3 / iters
    top = [[n[:80], ms] for n, ms in sorted(names.items(), key=lambda kv: -kv[1])[:10]]
    return busy_ms, kernel_ms, launches / iters, wall_ms, top


def _profile_decode(eng, steps: int = 8, phase: str = "profile",
                    kernel: str = "paged_decode_kernel", **fields) -> float:
    """Where a decode step's time goes, on a serving engine after its run:
    16 slots decoding, host wall per step (unprofiled, synchronised) against
    the device's busy time per step (``torch.profiler``, same steps), and
    the device ms of the path's kernel (``kernel``: a substring of its CUDA
    name, or a tuple of them) per step; the ten kernels that took the most
    device time per step."""
    import numpy as np
    torch = _torch()

    rng = np.random.default_rng(SEED + 3)
    for rid in range(eng.num_slots):
        eng.add_request(10_000 + rid, rng.integers(3, eng.api.cfg.vocab_size, 64), 40)
    while any(getattr(st, "phase", "decode") != "decode" for st in eng.slots.values()):
        eng.step()

    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    busy_ms, kernel_ms, launches, profiled_wall_ms, top = _device_busy(eng.step, steps,
                                                                       kernel)
    emit(phase, window="decode-only steps, 16 slots", steps=steps,
         host_wall_ms_per_step=wall_ms, profiled_wall_ms_per_step=profiled_wall_ms,
         device_busy_ms_per_step=busy_ms,
         device_idle_share=max(0.0, 1 - busy_ms / wall_ms), kernel=kernel,
         kernel_ms_per_step=kernel_ms, launches_per_step=launches,
         top_kernels_ms_per_step=top, **fields)
    seen = kernel_ms.values() if isinstance(kernel_ms, dict) else [kernel_ms]
    if not all(ms > 0 for ms in seen):
        raise AssertionError(f"{phase}: the profiler saw no {kernel} time ({kernel_ms})")
    return busy_ms


def main() -> int:
    try:
        torch = _torch()
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 3
    sys.path.insert(0, src)
    wall = []

    def timed(name, fn, *args, **kwargs):
        """``fn(*args, **kwargs)``, its wall seconds printed on a line of
        their own."""
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            wall.append((name, time.perf_counter() - t0))
            emit("wall", name=name, seconds=wall[-1][1])

    t_start = time.perf_counter()
    try:
        gpu = timed("env", phase_env)
        timed("build", phase_build)
        rows = timed("kernels", phase_kernels)
        rows += timed("flash_kernels", phase_flash_kernels)
        rows += timed("slot_kernels", phase_slot_kernels)
        scan_row, decode_extra = timed("hybrid_kernels", phase_hybrid_kernels)
        rows[4].update(decode_extra)
        timed("split_kernels", phase_split_kernels)
        rows.append(scan_row)
        timed("model", phase_model)
        timed("model_danube", phase_model_danube)
        timed("model_slot", phase_model_slot)
        shared = timed("serve", phase_serve, rows[0])
        timed("serve_quant", phase_serve_quant, rows[1], shared)
        api, params = timed("serve_slot", phase_serve_slot, rows[4], ARCH, "decode_attention")
        timed("passk", phase_passk, api, params)
        del api, params
        timed("serve_rwkv", phase_serve_slot, rows[5], RWKV_ARCH, "rwkv6_scan")
        torch.cuda.empty_cache()
        timed("model_hybrid", phase_model_hybrid)
        timed("serve_hybrid", phase_serve_hybrid, scan_row, rows[4])
        timed("train_model", phase_train_model)
        shared = timed("train", phase_train)
        for row, key in ((rows[2], "flash_launches_fwd"), (rows[3], "flash_launches_bwd")):
            row["launches"] = sum(st[key] for st in shared["steps"])
            row["launches_per_train_on_samples"] = shared["steps"][0][key]
        timed("profile_train", phase_profile_train, shared)
        del shared
        rlvr = timed("pipeline_rlvr", phase_pipeline_rlvr, gpu)
        runs = {"rlvr_alpha1": rlvr[1], "rlvr_alpha0": rlvr[0],
                "agentic": timed("pipeline_agentic", phase_pipeline_agentic, gpu)}
        # the slice-9 paths' own counts, beside each row's earlier path
        for row, count in ((rows[0], lambda r: r["paged_launches"]),
                           (rows[2], lambda r: r["flash_launches"][0]),
                           (rows[3], lambda r: r["flash_launches"][1])):
            row["pipeline_launches"] = {k: count(r) for k, r in runs.items()}
        timed("train_cli", phase_train_cli, gpu)
        # slice 10: the MoE family
        timed("moe_kernels", phase_moe_kernels, rows, gpu)
        timed("model_moe", phase_model_moe, rows, gpu)
        timed("serve_moe", phase_serve_moe, rows, gpu)
        timed("train_moe", phase_train_moe, rows, gpu)
        # slice 11: the critic, checkpoints and the example twins
        shared = timed("train_critic", phase_train_critic, rows, gpu)
        timed("checkpoint", phase_checkpoint, shared, gpu)
        del shared
        timed("pipeline_critic", phase_pipeline_critic, rows, gpu)
        timed("examples", phase_examples, gpu)
        # slice 12: the VLM and enc-dec audio families
        timed("vlm_audio_kernels", phase_vlm_audio_kernels, rows, gpu)
        timed("model_vlm", phase_model_vlm, rows, gpu)
        timed("serve_vlm", phase_serve_vlm, rows, gpu)
        timed("train_vlm", phase_train_vlm, rows, gpu)
        timed("pipeline_vlm", phase_pipeline_vlm, rows, gpu)
        timed("model_audio", phase_model_audio, rows, gpu)
        timed("decode_audio", phase_decode_audio, rows, gpu)
        timed("train_audio", phase_train_audio, rows, gpu)
        # slice 15: fp32 apply through the redesigned fp32 flash route
        timed("model_fp32_flash", phase_model_fp32_flash, rows, gpu)
        # slice 13: the sharding plan / dry-run and the lock sanitizer
        timed("dryrun", phase_dryrun, gpu)
        timed("sanitize", phase_sanitize, gpu)
        emit("wall_total", seconds=time.perf_counter() - t_start, phases=len(wall),
             slowest=sorted(wall, key=lambda x: -x[1])[:5])
    except Exception:  # noqa: BLE001 - report any phase failure, exit non-zero
        traceback.print_exc()
        return 1
    print(gpu, flush=True)   # the card's name and power limit, again near the end
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
