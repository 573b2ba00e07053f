#!/usr/bin/env python3
"""Build flash attention's CUDA source and variants of it, check each
against the plain versions and time each against SDPA, on one card.

    python3 tools/flash_variants.py [--variants JSON] [--no-check]
        [--parent DIR] [--shapes NAMES] [--breakdown]

A variant is a name and text substitutions applied to a copy of
``src/repro_torch/csrc/flash_attention*`` (for example
``{"fwd2": {"NWG = D <= 64 ? 3 : 2": "NWG = 2"}}``); every variant, and the
source as it is ("base"), is compiled by ``nvcc`` in parallel into
``build/repro_torch/var_<name>/``.  ``--parent DIR`` also builds
``DIR/flash_attention.cu`` (an older tree's source, unpacked there) as
"parent", called with its own route codes (bf16 causal and head_dim 256
on code 1, ``mma.sync``).  Printed, one JSON line each: the bf16 kernels'
registers and spills (``-Xptxas -v``) and HMMA / HGMMA counts
(``cuobjdump -sass``); with the check, bf16 cases, causal and not (ragged
S, G = 1 / 4 / 6 / 8 / 16, head_dim 32 / 64 / 120 / 128 / 256, windows,
softcaps), against ``kernels/ref.py`` at 2e-2 (gradients at 2e-2 x their
largest magnitude) and the backward repeated bit for bit; then, at the
timed shapes (``SHAPES``; ``--shapes`` picks some by name), each library's
forward and backward ms (CUDA events, L2 flushed: ``chip_smoke._time_ms``)
beside SDPA's, in turns (base first and last), and with ``--breakdown``
the device time of each kernel of a call (``torch.profiler``).  The card's
name and power limit come first.  Needs a CUDA card and the CUDA toolkit;
imports no JAX.
"""
import argparse
import ctypes
import json
import os
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
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels.ref import flash_attention_bwd_ref, flash_attention_ref  # noqa: E402

TOL = 2e-2
# (label, B, H, KV, S, D, window, softcap, causal)
CASES = [("s64", 1, 2, 1, 64, 64), ("s2", 1, 4, 1, 2, 64), ("s100", 1, 4, 2, 100, 64),
         ("seamless_b2", 2, 16, 16, 1024, 64), ("odd", 2, 16, 4, 300, 64),
         ("d128", 2, 8, 2, 256, 128), ("d120_window_softcap", 2, 8, 2, 300, 120, 128, 30.0),
         ("window", 1, 8, 2, 300, 64, 100, None), ("d32", 1, 4, 2, 200, 32),
         ("g8", 1, 16, 2, 130, 64), ("softcap", 2, 16, 4, 300, 64, None, 30.0),
         ("d256", 1, 8, 1, 300, 256), ("d256_softcap", 1, 4, 2, 130, 256, None, 30.0)]
CASES = [c + (None,) * (8 - len(c)) + (False,) for c in CASES] + [
    ("c_s37", 1, 4, 4, 37, 64, None, None, True),
    ("c_s64", 1, 2, 1, 64, 64, None, None, True),
    ("c_s65", 1, 2, 1, 65, 128, None, None, True),
    ("c_trainer_b2", 2, 16, 8, 512, 128, None, None, True),
    ("c_odd", 2, 16, 4, 300, 64, 128, 30.0, True),
    ("c_dbrx", 1, 48, 8, 300, 128, None, None, True),
    ("c_g16", 1, 64, 4, 200, 128, None, 30.0, True),
    ("c_d120", 2, 32, 8, 300, 120, 128, 30.0, True),
    ("c_d32", 1, 8, 2, 130, 32, None, None, True),
    ("c_paligemma", 2, 8, 1, 300, 256, None, None, True),
    ("c_d256_softcap", 1, 8, 1, 512, 256, None, 30.0, True),
    ("c_recurrentgemma", 1, 16, 1, 2100, 256, 2048, None, True),
    ("c_window", 1, 8, 2, 300, 64, 100, None, True)]
# (name, (B, H, KV, S, D), causal)
SHAPES = [("trainer", (8, 16, 8, 512, 128), True), ("paligemma", (8, 8, 1, 512, 256), True),
          ("seamless_decoder", (16, 16, 16, 256, 64), True),
          ("seamless", (16, 16, 16, 1024, 64), False), ("odd", (2, 16, 4, 300, 64), False),
          ("d128", (4, 16, 16, 1024, 128), False)]
# the parent tree's route codes: bf16 causal or head_dim past 128 on 1 (mma.sync)
_PARENT_ROUTES = {"fp32": 0, "mma_sync": 1, "wgmma": 2}


def _compile(name, subs, src=None):
    d = build.BUILD_DIR / f"var_{name}"
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(src or build.CSRC, d)
    for f in d.glob("flash_attention*"):
        text = f.read_text()
        for old, new in subs.items():
            if old not in text and f.suffix == ".cuh":
                raise SystemExit(f"variant {name}: {old!r} not in the source")
            text = text.replace(old, new)
        f.write_text(text)
    out = d / "lib.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(d / "flash_attention.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True), out


def _report(name, log, lib):
    regs, fn = {}, None
    for line in log.splitlines():
        m = (re.search(r"Compiling entry function '(\S+)'", line)
             or re.search(r"Function properties for (\S+)", line))
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn and ("sm90" in fn or "bf16" in fn):
            regs.setdefault(fn, {})["spill"] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and fn and ("sm90" in fn or "bf16" in fn):
            regs.setdefault(fn, {})["regs"] = int(m.group(1))
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True).stdout
    mma, local, top, fn = {}, {}, {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            mma[fn] = [0, 0]
            local[fn] = [0, 0]
        elif fn and "HGMMA" in line:
            mma[fn][1] += 1
        elif fn and "HMMA" in line:
            mma[fn][0] += 1
        elif fn and re.search(r"\b(STL|LDL)\b", line):
            local[fn][0 if "STL" in line else 1] += 1
        if fn:
            top[fn] = max([top.get(fn, 0)] + [int(r) for r in re.findall(r"\bR(\d+)\b", line)])
    def short(k):
        m = re.search(r"(flash_\w+?_kernel)((?:ILi\d+E)?(?:Li\d+E)*)", k)
        return m.group(1) + m.group(2) if m else k

    print(json.dumps({"lib": name, "registers": {short(k): v for k, v in regs.items()},
                      "hmma_hgmma": {short(k): v for k, v in mma.items()
                                     if "sm90" in k or "bf16" in k},
                      "local_st_ld": {short(k): v for k, v in local.items() if any(v)},
                      "top_register": {short(k): v + 1 for k, v in top.items()
                                       if "wgmma" in k or "bf16_kernel" in k},
                      "warnings": sorted({line.strip()[-300:] for line in log.splitlines()
                                          if re.search(r"\(C7\d+\)", line)})}),
          flush=True)


_ROUTE, _CODES = fa.route, fa._ROUTES


def _parent_route(dtype, causal, head_dim):
    if dtype == torch.float32:
        return "fp32"
    return "wgmma" if not causal and head_dim <= 128 else "mma_sync"


def _use(lib, parent=False):
    fa.build.library = lambda _name: lib
    fa.route, fa._ROUTES = (_parent_route, _PARENT_ROUTES) if parent else (_ROUTE, _CODES)


def _check(label, b, h, kv, s, d, window=None, softcap=None, causal=False):
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(b, s, n, d, generator=g, device="cuda").to(torch.bfloat16)
                   .transpose(1, 2) for n in (h, kv, kv, h))
    opts = dict(causal=causal, window=window, softcap=softcap)
    out = {"case": label, "shape": [b, h, kv, s, d, window, softcap, causal]}
    o, lse = fa.flash_attention_fwd(q, k, v, **opts)
    want_o, want_lse = flash_attention_ref(q, k, v, return_lse=True, **opts)
    out["o"] = (o.float() - want_o.float()).abs().max().item()
    ok = (torch.allclose(o.float(), want_o.float(), rtol=TOL, atol=TOL)
          and torch.allclose(lse, want_lse, rtol=TOL, atol=TOL))
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do, **opts)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, **opts)
    torch.cuda.synchronize()
    out["bitwise"] = all(torch.equal(x, y) for x, y in zip(grads, again))
    for name, x, w in zip(("dq", "dk", "dv"), grads, flash_attention_bwd_ref(q, k, v, o, lse,
                                                                              do, **opts)):
        scale = w.float().abs().max().item()
        out[name] = (x.float() - w.float()).abs().max().item() / scale
        ok = ok and torch.allclose(x.float(), w.float(), rtol=TOL, atol=TOL * scale)
    out["ok"] = bool(ok and out["bitwise"])
    print(json.dumps(out), flush=True)
    return out["ok"]


def _breakdown(fn, n=5):
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type.name == "CUDA":
            total = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
            out[re.sub(r"<.*", "", e.key).split("::")[-1][:40]] = round(total / n, 2)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default="{}", help="JSON: name -> {old: new}")
    ap.add_argument("--no-check", action="store_true", help="time only")
    ap.add_argument("--parent", help="a directory holding an older flash_attention.cu")
    ap.add_argument("--shapes", help="comma-separated names of SHAPES to time (default: all)")
    ap.add_argument("--breakdown", action="store_true", help="device time by kernel")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_variants: no CUDA card", file=sys.stderr)
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
        print(json.dumps({"lib": name, "built_s": round(time.perf_counter() - t0, 1)}), flush=True)
        libs[name] = ctypes.CDLL(str(out))
        _report(name, log, out)
    ok = True
    for name, lib in libs.items():
        if name == "parent" or (args.no_check and name != "base"):
            continue
        _use(lib)
        ok = all([_check(*c) for c in CASES]) and ok
    names = args.shapes.split(",") if args.shapes else [n for n, _, _ in SHAPES]
    for label, (b, h, kv, s, d), causal in SHAPES:
        if label not in names:
            continue
        g = torch.Generator(device="cuda").manual_seed(1)
        q, k, v, do = (torch.randn(b, s, n, d, generator=g, device="cuda").to(torch.bfloat16)
                       .transpose(1, 2) for n in (h, kv, kv, h))
        sdpa_f = cs._time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True))
        ql, kl, vl = (t.detach().requires_grad_(True) for t in (q, k, v))
        out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal, enable_gqa=True)
        sdpa_b = cs._time_ms(lambda: torch.autograd.grad(out, (ql, kl, vl), do,
                                                         retain_graph=True))
        for name in list(libs) + ["base"]:
            _use(libs[name], name == "parent")
            o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
            f = cs._time_ms(lambda: fa.flash_attention_fwd(q, k, v, causal=causal))
            bw = cs._time_ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal))
            print(json.dumps({"time": label, "causal": causal, "lib": name, "fwd_ms": f,
                              "bwd_ms": bw, "sdpa_fwd_ms": sdpa_f, "sdpa_bwd_ms": sdpa_b,
                              "fwd_x_sdpa": f / sdpa_f, "bwd_x_sdpa": bw / sdpa_b}), flush=True)
        if not args.breakdown:
            continue
        for name, lib in libs.items():
            _use(lib, name == "parent")
            o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
            print(json.dumps({"kernels_us": label, "lib": name,
                              "fwd": _breakdown(lambda: fa.flash_attention_fwd(q, k, v,
                                                                               causal=causal)),
                              "bwd": _breakdown(lambda: fa.flash_attention_bwd(
                                  q, k, v, o, lse, do, causal=causal))}), flush=True)
    _use(libs["base"])
    print(gpu, flush=True)
    return 0 if ok else 2


if __name__ == "__main__":
    sys.exit(main())
