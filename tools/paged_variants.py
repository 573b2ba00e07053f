#!/usr/bin/env python3
"""Build the paged decode kernel's CUDA source and variants of it, check
each against the plain version and time each, with its routes and split
targets, against SDPA, on one card.

    python3 tools/paged_variants.py [--variants JSON] [--parent DIR]
        [--plans BLOCKS/ES,...] [--no-check] [--rounds N]

A variant is a name and text substitutions applied to a copy of
``src/repro_torch/csrc/paged_decode_attention.cu`` and ``decode_split.cuh``
(``{"name": {"old text": "new text"}}``); every
variant, and the source as it is ("base"), is compiled by ``nvcc`` in
parallel into ``build/repro_torch/pvar_<name>/``.  ``--parent DIR`` also
builds ``DIR/paged_decode_attention.cu`` (an older tree's source and
header, unpacked there) as "parent"; an int8 pool runs the CUDA-core route
there, as the older wrapper planned it.  Printed, one JSON line each: the
kernels' registers and spills (``-Xptxas -v``) and HMMA counts
(``cuobjdump -sass``) of the int8 bf16-q instances; with the check, cases
at G = 1 .. 16 and head_dim 64 / 120 / 128 / 256 (masked rows, -1 entries,
softcaps, one split and several) against ``kernels/ref.py`` at 2e-2; then,
at Qwen3-4B's (G=4), DBRX-132B's (G=6) and Qwen3-MoE-235B-A22B's (G=16)
serving shapes (B=16, page 16, P=64, D=128), the kernel's ms (CUDA events,
L2 flushed: ``chip_smoke._time_ms``) of each library, int8 pool on the
tensor cores and on the CUDA cores and bf16 pool, beside SDPA's on a
gathered bf16 view, in ``--rounds`` turns (base first and last).  With
``--plans``, each library's int8 tensor-core route is also timed at each
of those splits: a target of BLOCKS blocks per SM (``BLOCKS_PER_SM["tensor
cores, int8"]``) and a least split read at ES bytes an element
(``min_split_tiles``).  The card's name
and power limit come first.  Needs a CUDA card and the CUDA toolkit;
imports no JAX.
"""
import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import paged_decode_attention as pda  # noqa: E402
from repro_torch.kernels.ref import paged_decode_attention_ref  # noqa: E402

TOL = 2e-2
NAME = "paged_decode_attention"
# (label, B, H, KV, D, page, P, softcap, int8, q dtype)
CASES = [("serve_g4", 16, 32, 8, 128, 16, 64, None, True, "bf16"),
         ("g6", 8, 48, 8, 128, 16, 40, None, True, "bf16"),
         ("g16", 8, 64, 4, 128, 16, 64, 30.0, True, "bf16"),
         ("g16_one_split", 2, 32, 2, 128, 16, 3, None, True, "bf16"),
         ("g1", 4, 8, 8, 128, 16, 20, None, True, "bf16"),
         ("g3_d64", 16, 12, 4, 64, 16, 2, None, True, "bf16"),
         ("g5_d64_softcap", 3, 20, 4, 64, 8, 9, 30.0, True, "bf16"),
         ("g8_d120", 4, 64, 8, 120, 16, 8, 30.0, True, "bf16"),
         ("g4_d120", 4, 32, 8, 120, 16, 8, None, True, "bf16"),
         ("g16_d256", 2, 16, 1, 256, 16, 40, None, True, "bf16"),
         ("g2_d256_softcap", 3, 4, 2, 256, 16, 9, 30.0, True, "bf16"),
         ("g4_d56", 3, 8, 2, 56, 16, 9, None, True, "bf16"),
         ("g4_fp32q", 4, 32, 8, 128, 16, 8, 30.0, True, "fp32"),
         ("bf16_g4", 16, 32, 8, 128, 16, 64, None, False, "bf16"),
         ("bf16_g16", 4, 64, 4, 128, 16, 20, 30.0, False, "bf16")]
# (name, H, KV) at B=16, page 16, P=64, D=128
SHAPES = [("qwen3_4b_g4", 32, 8), ("dbrx_g6", 48, 8), ("qwen3_moe_g16", 64, 4)]


def _compile(name, subs, src=None):
    d = build.BUILD_DIR / f"pvar_{name}"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    src = Path(src or build.CSRC)
    for f in (f"{NAME}.cu", "decode_split.cuh"):
        text = (src / f).read_text()
        for old, new in subs.items():
            text = text.replace(old, new)
        (d / f).write_text(text)
    if subs and not any(old in (src / f).read_text() for old in subs
                        for f in (f"{NAME}.cu", "decode_split.cuh")):
        raise SystemExit(f"variant {name}: no substitution applies")
    out = d / "lib.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(d / f"{NAME}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True), out


_INT8_MMA = re.compile(r"paged_decode_kernelI13__nv_bfloat16aLb1ELi(\d+)ELi(\d+)ELb1E")


def _report(name, log, lib):
    regs, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn and _INT8_MMA.search(fn):
            regs.setdefault(fn, {})["spill"] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and fn and _INT8_MMA.search(fn):
            regs.setdefault(fn, {})["regs"] = int(m.group(1))
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True).stdout
    hmma, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1) if _INT8_MMA.search(m.group(1)) else None
            if fn:
                hmma[fn] = 0
        elif fn and "HMMA" in line:
            hmma[fn] += 1

    def short(k):
        m = _INT8_MMA.search(k)
        return f"int8_bf16q_mma_D{m.group(1)}_VB{m.group(2)}"

    print(json.dumps({"lib": name, "registers": {short(k): v for k, v in regs.items()},
                      "hmma": {short(k): v for k, v in hmma.items()}}), flush=True)


_BLOCKS = da.BLOCKS_PER_SM["tensor cores, int8"]
_PLAN = pda.plan
_MIN_TILES = pda.min_split_tiles


def _use(lib, blocks=None, cuda_cores=False, min_es=None):
    """Route the wrapper to ``lib``; ``blocks``: the tensor cores' split
    target; ``cuda_cores``: plan an int8 pool as the CUDA cores' route;
    ``min_es``: the element size an int8 split's least tile count is read
    at (``min_split_tiles``; 2 as planned)."""
    build.library = lambda _name: lib
    da.BLOCKS_PER_SM["tensor cores, int8"] = blocks or _BLOCKS
    pda.plan = _cuda_plan if cuda_cores else _PLAN
    pda.min_split_tiles = (_MIN_TILES if min_es is None else
                           lambda group, es, keys: _MIN_TILES(group, min_es, keys))


def _cuda_plan(pages_per_seq, page_size, rows, sms, group, q_dtype, pool_dtype, head_dim):
    """The older wrapper's plan: an int8 pool on the CUDA cores."""
    if pool_dtype != torch.int8:
        return _PLAN(pages_per_seq, page_size, rows, sms, group, q_dtype, pool_dtype, head_dim)
    tp = max(1, da.TILE // page_size)
    splits, per = da.split_plan(-(-pages_per_seq // tp), rows, sms,
                                da.min_split_tiles(group, 1, tp * page_size), "CUDA cores")
    return splits, per * tp, tp, False


def _check(label, b, h, kv, d, page, p, softcap, int8, qd):
    gen = torch.Generator(device="cuda").manual_seed(7)
    dtype = torch.bfloat16 if qd == "bf16" else torch.float32
    q, kp, vp, tables, lengths, scales = cs._paged_inputs(gen, b, h, kv, d, page, p, dtype,
                                                          int8=int8)
    if p > 2:
        tables[min(2, b - 1), 1] = -1          # a -1 entry inside a live range
    out = pda.paged_decode_attention(q, kp, vp, tables, lengths, softcap=softcap, **scales)
    torch.cuda.synchronize()
    want = paged_decode_attention_ref(q, kp, vp, tables, lengths, softcap=softcap, **scales)
    err = (out.float() - want.float()).abs().max().item()
    tol = TOL if qd == "bf16" else 2e-5
    ok = bool(torch.allclose(out.float(), want.float(), rtol=tol, atol=tol))
    splits, chunk, tp, mma = pda.plan(p, page, b * kv, da.sm_count(q.device), h // kv, dtype,
                                      kp.dtype, d)
    print(json.dumps({"case": label, "shape": [b, h, kv, d, page, p], "softcap": softcap,
                      "pool": "int8" if int8 else "bf16", "q": qd, "splits": splits,
                      "mma": mma, "max_abs_err": err, "ok": ok}), flush=True)
    return ok


def _sdpa_ms(q, kp, vp, tables, lengths, scales, page):
    b, h, d = q.shape
    kv = kp.shape[2]
    s = tables.shape[1] * page
    idx = tables.long().clamp(min=0)
    kd, vd = kp[idx].reshape(b, s, kv, d), vp[idx].reshape(b, s, kv, d)
    if scales:
        kd = kd.float() * scales["k_scales"][idx].reshape(b, s, kv)[..., None]
        vd = vd.float() * scales["v_scales"][idx].reshape(b, s, kv)[..., None]
    kd = kd.to(q.dtype).transpose(1, 2).contiguous()
    vd = vd.to(q.dtype).transpose(1, 2).contiguous()
    pos = torch.arange(s, device="cuda")[None, :]
    mask = ((pos < lengths[:, None])
            & torch.repeat_interleave(tables >= 0, page, dim=1))[:, None, None, :]
    return cs._time_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None, :], kd, vd, attn_mask=mask, enable_gqa=True))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default="{}", help="JSON: name -> {old: new}")
    ap.add_argument("--parent", help="a directory holding an older paged_decode_attention.cu")
    ap.add_argument("--plans", default="",
                    help="BLOCKS/ES,...: split targets (blocks per SM) and the element "
                         "size of the least split, to time the int8 route at")
    ap.add_argument("--no-check", action="store_true", help="time only")
    ap.add_argument("--rounds", type=int, default=2, help="turns of the timed libraries")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("paged_variants: no CUDA card", file=sys.stderr)
        return 1
    gpu = cs.phase_env()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {name: _compile(name, subs)
             for name, subs in {"base": {}, **json.loads(args.variants)}.items()}
    if args.parent:
        procs["parent"] = _compile("parent", {}, Path(args.parent).resolve())
    libs = {}
    for name, (proc, out) in procs.items():
        log = proc.communicate()[0]
        (out.parent / "build.log").write_text(log)
        if proc.returncode:
            print("\n".join(line for line in log.splitlines() if "error" in line)[:6000])
            return 1
        print(json.dumps({"lib": name, "built_s": round(time.perf_counter() - t0, 1)}),
              flush=True)
        libs[name] = ctypes.CDLL(str(out))
        _report(name, log, out)
    ok = True
    for name, lib in libs.items():
        if name == "parent" or (args.no_check and name != "base"):
            continue
        _use(lib)
        print(json.dumps({"checking": name}), flush=True)
        ok = all([_check(*c) for c in CASES]) and ok
    plans = [tuple(int(v) for v in x.split("/")) for x in args.plans.split(",") if x]
    order = [n for n in libs if n != "base"]
    turns = (["base"] + order) * args.rounds + ["base"]
    gen = torch.Generator(device="cuda").manual_seed(1)
    for label, h, kv in SHAPES:
        inputs = {int8: cs._paged_inputs(gen, 16, h, kv, 128, 16, 64, torch.bfloat16,
                                         int8=int8) for int8 in (True, False)}
        sdpa = {int8: _sdpa_ms(*inputs[int8], 16) for int8 in (True, False)}
        times = {}
        for name in turns:
            runs = [("int8_cuda_cores", True, (None, None), True),
                    ("bf16", False, (None, None), False)]
            if name != "parent":
                runs.insert(0, ("int8_tensor_cores", True, (None, None), False))
                runs += [(f"int8_tensor_cores_plan{n}/{es}", True, (n, es), False)
                         for n, es in plans]
            for key, int8, (nblocks, min_es), cuda_cores in runs:
                _use(libs[name], nblocks, cuda_cores or name == "parent", min_es)
                q, kp, vp, tables, lengths, scales = inputs[int8]
                ms = cs._time_ms(lambda: pda.paged_decode_attention(q, kp, vp, tables,
                                                                    lengths, **scales))
                splits = pda.plan(64, 16, 16 * kv, da.sm_count(q.device), h // kv,
                                  torch.bfloat16, kp.dtype, 128)[0]
                times.setdefault(f"{name}:{key}", []).append(ms)
                print(json.dumps({"time": label, "lib": name, "run": key, "ms": ms,
                                  "splits": splits, "sdpa_ms": sdpa[int8],
                                  "x_sdpa": ms / sdpa[int8]}), flush=True)
        print(json.dumps({"times": label, "ms": times, "sdpa_ms_int8_view": sdpa[True],
                          "sdpa_ms_bf16": sdpa[False]}), flush=True)
    _use(libs["base"])
    print(gpu, flush=True)
    return 0 if ok else 2


if __name__ == "__main__":
    sys.exit(main())
