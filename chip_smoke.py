#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero and prints
no result):

1. ``env``: the card's name and power limit (``nvidia-smi``), torch and CUDA
   versions; TF32 is switched off for matmul and cuDNN.
2. ``build``: ``nvcc`` builds every kernel in ``src/repro_torch/csrc``.
3. ``kernels``: each kernel against its plain-torch version on the card, at
   the shapes the serving path gives it, plus a softcap case and a small odd
   shape; times of the kernel, the plain version, the bound and one PyTorch
   library call.
4. ``model``: full-width Qwen3-4B in fp32, the same requests through two
   engines sharing one set of weights, ``attn_impl="kernel"`` and ``"ref"``:
   greedy tokens must match.
5. ``serve``: the main path — full-width Qwen3-4B in bf16 behind
   ``LLMProxy`` over ``PagedDecodeEngine`` (prefix cache on, 16 slots),
   serving a seeded mix of rollout tasks.  Every callback must fire, the
   page audit must be clean, and the decode kernel must have launched
   num_layers times per decode step.

Then one line with every kernel's numbers, and last
``{"ok": true, "device": {...}}``.  Weights are random, drawn from a seed
on the card.  Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
import traceback

ARCH = "qwen3-4b"
SEED = 0
# H100 SXM published peaks (NVIDIA data sheet), used for the bound.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12          # the kernel's math is fp32 on the CUDA cores
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),    # reduction order only
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}   # bf16 inputs and output

# the serving configuration the main path runs
SERVE = dict(num_slots=16, max_total_len=1024, page_size=16, prefill_chunk=128)
MAX_NEW = 64
DEVICE = "cuda"


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

def _paged_inputs(gen, b, h, kv, d, page_size, p, dtype):
    """Pool, ragged block tables (-1 tails) and lengths; row 0 fully masked."""
    torch = _torch()
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
    return q, kp, vp, tables, lengths


def _paged_bound(q, kp, tables, lengths):
    """(bound_ms, bound_by) from what these inputs need: each K/V tile the
    softmax can weigh is read once (a fully masked row averages V over its
    clamped entries), q read and the output written once."""
    b, h, d = q.shape
    page_size, kv = kp.shape[1], kp.shape[2]
    tile = page_size * kv * d * kp.element_size()
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
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _time_ms(fn, iters=30) -> float:
    """Mean device time of ``fn`` by CUDA events, L2 flushed before each
    launch (a decode step finds the pool cold)."""
    torch = _torch()
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=DEVICE)
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def phase_kernels() -> dict:
    torch = _torch()
    import torch.nn.functional as F
    from repro_torch.kernels.paged_decode_attention import paged_decode_attention
    from repro_torch.kernels.ref import paged_decode_attention_ref

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    h, kv, d = 32, 8, 128                                  # Qwen3-4B
    page_size = SERVE["page_size"]
    p = SERVE["max_total_len"] // page_size
    cases = [  # (label, b, h, kv, d, page, P, dtype, softcap)
        ("slice_bf16", SERVE["num_slots"], h, kv, d, page_size, p, torch.bfloat16, None),
        ("slice_fp32", SERVE["num_slots"], h, kv, d, page_size, p, torch.float32, None),
        ("softcap_fp32", SERVE["num_slots"], h, kv, d, page_size, p, torch.float32, 30.0),
        ("odd_bf16", 3, 12, 3, 64, 8, 5, torch.bfloat16, None),
        ("odd_fp32", 3, 12, 3, 64, 8, 5, torch.float32, None),
    ]
    main = None
    for label, b, hh, kvv, dd, ps, pp, dtype, softcap in cases:
        q, kp, vp, tables, lengths = _paged_inputs(gen, b, hh, kvv, dd, ps, pp, dtype)
        out = paged_decode_attention(q, kp, vp, tables, lengths, softcap=softcap)
        torch.cuda.synchronize()
        ref = paged_decode_attention_ref(q, kp, vp, tables, lengths, softcap=softcap)
        tol = TOL[str(dtype).split(".")[-1]]
        err = (out.float() - ref.float()).abs().max().item()
        ok = torch.allclose(out.float(), ref.float(), **tol)
        emit("kernels", case=label, shape=[b, hh, kvv, dd, ps, pp],
             dtype=str(dtype), softcap=softcap, max_abs_err=err, tol=tol, ok=ok)
        if not ok:
            raise AssertionError(f"paged_decode_attention {label}: max abs err {err}")
        if label == "slice_bf16":
            main = (q, kp, vp, tables, lengths, err)

    q, kp, vp, tables, lengths, err = main
    b, s = q.shape[0], tables.shape[1] * page_size
    kernel_ms = _time_ms(lambda: paged_decode_attention(q, kp, vp, tables, lengths))
    plain_ms = _time_ms(lambda: paged_decode_attention_ref(q, kp, vp, tables, lengths))
    # yardstick only (the port never calls it): SDPA over a dense view
    # gathered beforehand, the gather not timed
    idx = tables.long().clamp(min=0)
    kd = kp[idx].reshape(b, s, kv, d).transpose(1, 2).contiguous()
    vd = vp[idx].reshape(b, s, kv, d).transpose(1, 2).contiguous()
    pos = torch.arange(s, device=DEVICE)[None, :]
    mask = ((pos < lengths[:, None])
            & torch.repeat_interleave(tables >= 0, page_size, dim=1))[:, None, None, :]
    qd = q[:, :, None, :]
    library_ms = _time_ms(lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask, enable_gqa=True))
    bound_ms, bound_by = _paged_bound(q, kp, tables, lengths)
    row = {"name": "paged_decode_attention", "route": "cuda",
           "source": "src/repro_torch/csrc/paged_decode_attention.cu",
           "replaces": "src/repro/kernels/paged_decode_attention.py:146",
           "launches": None, "max_abs_err": err, "ms": kernel_ms,
           "kernel_ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": library_ms,
           "library_call": "F.scaled_dot_product_attention(enable_gqa=True) "
                           "on a dense view gathered beforehand (gather not timed)",
           "shape": "B=16 H=32 KV=8 D=128 page=16 P=64 bf16"}
    emit("kernels", **{k: v for k, v in row.items() if k != "launches"})
    return row


# ---------------------------------------------------------------------------
# model: kernel vs ref decode attention at full width, fp32
# ---------------------------------------------------------------------------

def _drain(engine, want: int, max_steps: int = 2000) -> dict:
    out = {}
    for _ in range(max_steps):
        for rid, toks, lps in engine.step():
            out[rid] = (toks.tolist(), lps.tolist())
        engine.audit_pages()
        if len(out) >= want:
            return out
    raise AssertionError(f"engine stalled: {len(out)}/{want} finished")


def _top2_gap(api, params, tokens) -> float:
    """Gap between the two largest next-token logits after ``tokens``
    (dense plain forward, fp32)."""
    torch = _torch()
    with torch.no_grad():
        logits, _ = api.apply(params, {"tokens": torch.tensor([tokens], device=DEVICE)})
    top = torch.topk(logits[0, -1], 2).values
    return float(top[0] - top[1])


def phase_model() -> None:
    import dataclasses
    import numpy as np
    torch = _torch()
    from repro_torch.configs import get_config
    from repro_torch.models import get_api
    from repro_torch.rollout import PagedDecodeEngine

    cfg = dataclasses.replace(get_config(ARCH), dtype="float32")
    api = get_api(cfg, device=DEVICE)
    params = api.init(SEED)
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(3, cfg.vocab_size, n).astype(np.int32)
               for n in (40, 100, 180, 250)]
    max_new = 16

    # the first decode step's logits, kernel vs ref, on one shared pool
    ps, pp = 16, 32
    cache = api.init_paged_cache(1 + len(prompts) * pp, ps)
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
        eng = PagedDecodeEngine(api, params, num_slots=len(prompts), max_total_len=512,
                                page_size=ps, prefill_chunk=128, temperature=0.0,
                                eos_id=-1, attn_impl=impl, device=DEVICE)
        for rid, prompt in enumerate(prompts):
            eng.add_request(rid, prompt, max_new)
        with torch.no_grad():
            results[impl] = _drain(eng, len(prompts))
        del eng
    divergences = []
    for rid, prompt in enumerate(prompts):
        a, b = results["kernel"][rid][0], results["ref"][rid][0]
        if a != b:
            step = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
            gap = _top2_gap(api, params, list(prompt) + a[:step])
            divergences.append({"request": rid, "step": step, "top2_gap": gap})
    emit("model", arch=ARCH, dtype="float32", layers=cfg.num_layers,
         d_model=cfg.d_model, first_decode_logits_max_abs_diff=logit_diff,
         requests=len(prompts), max_new_tokens=max_new,
         tokens_identical=not divergences, divergences=divergences)
    bad = [dv for dv in divergences if not dv["top2_gap"] < 1e-4]
    if bad:
        raise AssertionError(f"kernel and ref greedy tokens diverge: {bad}")
    del params
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


def phase_serve(kernel_row: dict) -> None:
    import numpy as np
    torch = _torch()
    from repro_torch.configs import get_config
    from repro_torch.core.llm_proxy import LLMProxy
    from repro_torch.kernels.paged_decode_attention import paged_decode_attention
    from repro_torch.models import get_api
    from repro_torch.rollout import PagedDecodeEngine

    cfg = get_config(ARCH)
    api = get_api(cfg, device=DEVICE)
    params = api.init(SEED)
    eng = PagedDecodeEngine(api, params, prefix_cache=True, temperature=1.0,
                            eos_id=-1, seed=SEED, device=DEVICE, **SERVE)
    # warm-up outside the measured run: cuBLAS handles, the kernel's load
    warm = np.arange(3, 35, dtype=np.int32)
    eng.add_request(-1, warm, 4)
    _drain(eng, 1)

    tasks = _serve_tasks(cfg.vocab_size)
    want = sum(int(t.meta.get("num_return_sequences", 1)) for t in tasks)
    lock = threading.Lock()
    done = threading.Event()
    results, first_token_at, submitted_at = [], {}, {}

    def callback(res):
        with lock:
            results.append(res)
            if len(results) == want:
                done.set()

    def stream_cb_for(rid):
        def cb(delta):
            first_token_at.setdefault(rid, time.perf_counter())
        return cb

    steps0, decode0 = 0, eng.total_decode_steps
    tokens0 = eng.total_tokens_decoded
    paged_decode_attention.launches = 0
    proxy = LLMProxy(eng, name="chip_smoke_proxy")
    t0 = time.perf_counter()
    proxy.start()
    try:
        for t in tasks:
            submitted_at[t.task_id] = time.perf_counter()
            grouped = "num_return_sequences" in t.meta
            proxy.generate(t, version=0, callback=callback,
                           stream_cb=None if grouped else stream_cb_for(t.task_id))
        finished = done.wait(timeout=300)
        wall = time.perf_counter() - t0
    finally:
        proxy.stop()
    launches = paged_decode_attention.launches
    kernel_row["launches"] = launches
    if not finished:
        raise AssertionError(f"serve: {len(results)}/{want} callbacks fired")
    eng.audit_pages()
    decode_steps = eng.total_decode_steps - decode0
    for res in results:
        toks, lps = np.asarray(res.tokens), np.asarray(res.logprobs)
        if res.aborted or toks.shape != (MAX_NEW,) or not np.isfinite(lps).all() \
                or (lps > 0).any() or (toks < 0).any() or (toks >= cfg.vocab_size).any():
            raise AssertionError(f"serve: bad result for request {res.request_id}")
    if launches == 0 or launches != cfg.num_layers * decode_steps:
        raise AssertionError(f"serve: {launches} kernel launches for {decode_steps} "
                             f"decode steps x {cfg.num_layers} layers")
    ttft = sorted(first_token_at[r] - submitted_at[r] for r in first_token_at)
    decoded = eng.total_tokens_decoded - tokens0
    emit("serve", arch=ARCH, dtype=cfg.dtype, requests=want, callbacks=len(results),
         prompt_tokens=int(sum(len(t.prompt_tokens) for t in tasks)),
         prefill_tokens=eng.total_prefill_tokens, cache_hit_tokens=eng.cache_hit_tokens,
         groups_forked=eng.total_groups_forked, peak_pages_in_use=eng.peak_pages_in_use,
         wall_s=wall, engine_steps=proxy.steps_executed - steps0,
         decode_steps=decode_steps, decoded_tokens=decoded,
         decode_tokens_per_s=decoded / wall,
         mean_step_ms=1e3 * wall / max(1, proxy.steps_executed - steps0),
         ttft_s_median=ttft[len(ttft) // 2], ttft_s_max=ttft[-1],
         kernel_launches=launches, kernel_launches_per_decode_step=launches / decode_steps,
         audit_pages="clean")
    _profile_decode(eng)


def _device_us(evt) -> float:
    for name in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _profile_decode(eng, steps: int = 8) -> None:
    """Where a decode step's time goes, on the serve engine after the run:
    16 slots decoding, host wall per step (unprofiled, synchronised) against
    the device's busy time per step (``torch.profiler``, same steps)."""
    import numpy as np
    torch = _torch()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(SEED + 3)
    for rid in range(eng.num_slots):
        eng.add_request(10_000 + rid, rng.integers(3, eng.api.cfg.vocab_size, 64), 40)
    while any(st.phase != "decode" for st in eng.slots.values()):
        eng.step()

    def run():
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / steps

    wall_ms = run()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled_wall_ms = run()
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3 / steps
    paged_ms = sum(_device_us(e) for e in kernels
                   if "paged_decode_kernel" in e.name) / 1e3 / steps
    launches = sum(1 for e in events
                   if e.name in ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx"))
    emit("profile", window="decode-only steps, 16 slots", steps=steps,
         host_wall_ms_per_step=wall_ms, profiled_wall_ms_per_step=profiled_wall_ms,
         device_busy_ms_per_step=busy_ms,
         device_idle_share=max(0.0, 1 - busy_ms / wall_ms),
         paged_decode_ms_per_step=paged_ms,
         launches_per_step=launches / steps)


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
    try:
        phase_env()
        phase_build()
        row = phase_kernels()
        phase_model()
        phase_serve(row)
    except Exception:  # noqa: BLE001 - report any phase failure, exit non-zero
        traceback.print_exc()
        return 1
    print(json.dumps({"kernels": [row]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
