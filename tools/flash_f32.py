#!/usr/bin/env python3
"""Build flash attention's fp32 route (and variants of it, and optionally a
parent checkout's), check each against the plain versions and time each
against SDPA's fp32 call, on one card.

    python3 tools/flash_f32.py [--parent DIR] [--variants JSON] [--no-check]
                               [--shapes NAME,...]

``--parent DIR``: a checkout (``git archive`` of another commit) whose
``src/repro_torch/csrc`` is built as the library "parent" and timed in
turns with this tree's (parent, base, base, parent); its fp32 route may
refuse a shape (then its times are null).  A variant is a name and text
substitutions applied to a copy of this tree's ``csrc`` (for example
``{"bk32": {"FWD_BK = D <= 64 ? 64 : 32": "FWD_BK = 32"}}``).  Every
library is compiled by ``nvcc`` in parallel into
``build/repro_torch/f32_<name>/``.  Printed, one JSON line each: the fp32
kernels' registers and spills (``-Xptxas -v``) and HMMA counts
(``cuobjdump -sass``); with the check, fp32 cases (causal and not, the
group sizes of PaliGemma-3B, RecurrentGemma-9B with its window of 2,048,
Qwen3-MoE-235B-A22B and DBRX-132B, ragged S, head_dim 120 and 256, windows,
a softcap, strided views) against ``kernels/ref.py`` at 2e-5 (gradients at
2e-5 x their largest magnitude) and the backward repeated bit for bit;
then, at ``SHAPES``, each library's forward and backward ms (CUDA events,
L2 flushed: ``chip_smoke._time_ms``) beside SDPA's fp32 call (TF32 off), and
the device time of each kernel of a call (``torch.profiler``) for this
tree's library.  The card's name and power limit come first.  Needs a CUDA
card and the CUDA toolkit; imports no JAX.
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
sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "tools")]

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from flash_variants import _breakdown, _use  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels.ref import flash_attention_bwd_ref, flash_attention_ref  # noqa: E402

TOL = 2e-5
# (label, B, H, KV, S, D, causal, window, softcap)
CASES = [("s2", 1, 2, 1, 2, 64, True, None, None),
         ("s100_nc", 1, 4, 2, 100, 64, False, None, None),
         ("seamless_b2_nc", 2, 16, 16, 1024, 64, False, None, None),
         ("odd_nc", 2, 16, 4, 300, 64, False, None, None),
         ("odd_window_softcap", 2, 16, 4, 300, 64, True, 128, 30.0),
         ("train_b2", 2, 16, 8, 512, 128, True, None, None),
         ("d120_window_softcap", 2, 32, 8, 300, 120, True, 128, 30.0),
         ("d120_nc", 1, 8, 2, 200, 120, False, 64, None),
         ("d256", 1, 2, 1, 77, 256, True, None, None),
         ("d32_softcap_nc", 1, 4, 1, 77, 32, False, None, 5.0),
         ("paligemma_g8", 1, 8, 1, 512, 256, True, None, None),
         ("paligemma_g8_nc", 1, 8, 1, 300, 256, False, None, None),
         ("recurrentgemma_g16_window", 1, 16, 1, 2100, 256, True, 2048, None),
         ("qwen3moe_g16", 1, 64, 4, 512, 128, True, None, None),
         ("qwen3moe_g16_nc", 1, 64, 4, 200, 128, False, None, None),
         ("dbrx_g6", 1, 48, 8, 512, 128, True, None, None),
         ("dbrx_g6_nc", 1, 48, 8, 300, 128, False, None, 30.0)]
# (label, B, H, KV, S, D, causal, window)
SHAPES = [("seamless", 16, 16, 16, 1024, 64, False, None),
          ("odd", 2, 16, 4, 300, 64, False, None),
          ("train", 8, 16, 8, 512, 128, True, None),
          ("paligemma", 1, 8, 1, 512, 256, True, None),
          ("paligemma_b8", 8, 8, 1, 512, 256, True, None),
          ("recurrentgemma", 1, 16, 1, 2048, 256, True, 2048),
          ("qwen3moe", 1, 64, 4, 512, 128, True, None),
          ("dbrx", 1, 48, 8, 512, 128, True, None)]


def _compile(name, csrc, subs):
    d = build.BUILD_DIR / f"f32_{name}"
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(csrc, d)
    for f in d.glob("flash_attention*"):
        text = f.read_text()
        for old, new in subs.items():
            if old not in text and f.suffix == ".cu":
                raise SystemExit(f"variant {name}: {old!r} not in the source")
            text = text.replace(old, new)
        f.write_text(text)
    out = d / "lib.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(d / "flash_attention.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True), out


def _short(fn):
    m = re.search(r"(flash_\w+?_kernel)(?:I\w*?Li(\d+)E)?", fn)
    return (m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")) if m else fn


def _report(name, log, lib):
    regs, fn = {}, None
    for line in log.splitlines():
        m = (re.search(r"Compiling entry function '(\S+)'", line)
             or re.search(r"Function properties for (\S+)", line))
        if m:
            fn = m.group(1)
        if not fn or not re.search(r"f32(_pair)?_kernel", fn):
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            regs.setdefault(_short(fn), {})["spill"] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            regs.setdefault(_short(fn), {})["regs"] = int(m.group(1))
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True).stdout
    mma, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            if re.search(r"f32(_pair)?_kernel", fn):
                mma[_short(fn)] = 0
        elif fn and re.search(r"f32(_pair)?_kernel", fn) and "HMMA" in line:
            mma[_short(fn)] += 1
    print(json.dumps({"lib": name, "registers": regs, "hmma": mma}), flush=True)


def _inputs(seed, b, h, kv, s, d):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(b, s, n, d, generator=g, device="cuda").transpose(1, 2)
                 for n in (h, kv, kv, h))


def _check(label, b, h, kv, s, d, causal, window, softcap):
    q, k, v, do = _inputs(0, b, h, kv, s, d)
    opts = dict(causal=causal, window=window, softcap=softcap)
    out = {"case": label, "shape": [b, h, kv, s, d], **opts}
    o, lse = fa.flash_attention_fwd(q, k, v, **opts)
    want_o, want_lse = flash_attention_ref(q, k, v, return_lse=True, **opts)
    out["o"] = (o - want_o).abs().max().item()
    out["lse"] = (lse - want_lse).abs().max().item()
    ok = (torch.allclose(o, want_o, rtol=TOL, atol=TOL)
          and torch.allclose(lse, want_lse, rtol=TOL, atol=TOL))
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do, **opts)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, **opts)
    torch.cuda.synchronize()
    out["bitwise"] = all(torch.equal(x, y) for x, y in zip(grads, again))
    for name, x, w in zip(("dq", "dk", "dv"), grads,
                          flash_attention_bwd_ref(q, k, v, o, lse, do, **opts)):
        scale = w.abs().max().item()
        out[name] = (x - w).abs().max().item() / scale
        ok = ok and torch.allclose(x, w, rtol=TOL, atol=TOL * scale)
    out["ok"] = bool(ok and out["bitwise"])
    print(json.dumps(out), flush=True)
    return out["ok"]


def _times(q, k, v, do, causal, window):
    try:
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, window=window)
        f = cs._time_ms(lambda: fa.flash_attention_fwd(q, k, v, causal=causal, window=window))
        bw = cs._time_ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                                        window=window))
        return f, bw
    except RuntimeError as e:   # a parent's fp32 route refusing the group
        return str(e)[:80], None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout whose src/repro_torch/csrc is the parent")
    ap.add_argument("--variants", default="{}", help="JSON: name -> {old: new}")
    ap.add_argument("--no-check", action="store_true", help="time only")
    ap.add_argument("--shapes", default=",".join(s[0] for s in SHAPES))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_f32: no CUDA card", file=sys.stderr)
        return 1
    gpu = cs.phase_env()   # TF32 off for matmul and cuDNN: SDPA's fp32 call stays fp32
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    srcs = {"base": (build.CSRC, {})}
    srcs.update({name: (build.CSRC, subs) for name, subs in json.loads(args.variants).items()})
    if args.parent:
        srcs["parent"] = (Path(args.parent).resolve() / "src/repro_torch/csrc", {})
    procs = {name: _compile(name, csrc, subs) for name, (csrc, subs) in srcs.items()}
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
        if name != "parent":
            _report(name, log, out)
    ok = True
    if not args.no_check:
        for name, lib in libs.items():
            if name == "parent":
                continue
            _use(lib)
            print(json.dumps({"checking": name}), flush=True)
            ok = all([_check(*c) for c in CASES]) and ok
    order = (["parent"] if "parent" in libs else []) + [n for n in libs if n != "parent"]
    order += order[::-1]
    wanted = set(args.shapes.split(","))
    for label, b, h, kv, s, d, causal, window in SHAPES:
        if label not in wanted:
            continue
        q, k, v, do = _inputs(1, b, h, kv, s, d)
        sdpa_f = cs._time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True))
        ql, kl, vl = (t.detach().requires_grad_(True) for t in (q, k, v))
        out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal, enable_gqa=True)
        sdpa_b = cs._time_ms(lambda: torch.autograd.grad(out, (ql, kl, vl), do,
                                                         retain_graph=True))
        del out, ql, kl, vl
        for name in order:
            _use(libs[name])
            f, bw = _times(q, k, v, do, causal, window)
            print(json.dumps({"time": label, "lib": name, "fwd_ms": f, "bwd_ms": bw,
                              "sdpa_fwd_ms": sdpa_f, "sdpa_bwd_ms": sdpa_b}), flush=True)
        for name in libs:
            if name == "parent":
                continue
            _use(libs[name])
            o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, window=window)
            print(json.dumps({"kernels_us": label, "lib": name,
                              "fwd": _breakdown(lambda: fa.flash_attention_fwd(
                                  q, k, v, causal=causal, window=window)),
                              "bwd": _breakdown(lambda: fa.flash_attention_bwd(
                                  q, k, v, o, lse, do, causal=causal, window=window))}),
                  flush=True)
        del q, k, v, do
        torch.cuda.empty_cache()
    print(gpu, flush=True)
    return 0 if ok else 2


if __name__ == "__main__":
    sys.exit(main())
