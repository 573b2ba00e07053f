#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card it is started on.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

It reads the cell from ``BENCHMARK.json``, its configuration, traffic mix
and limits from their files under ``bench/``, builds the port's kernels
(once per checkout, into ``build/repro_torch/``), runs the traffic kind's
driver (``bench/drivers/<kind>.py``): set-up, the measured window, then the
reference check.  It prints each number compared beside its limit as the
last lines of standard error, and as the last line of standard output one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones, each
read by ``bench/metrics/<name>.py``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``.

It exits non-zero and prints no result without a CUDA card (or with fewer
than the cell's chips), and when ``jax``, ``jaxlib``, ``flax`` or the JAX
package ``repro`` is loaded once the window has closed.
"""
import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole: ``repro_torch`` is not ``repro``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit_w():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=60, check=True).stdout
        return float(out.splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def result(bench: dict, record, kind: str, chips: int, power_w) -> dict:
    """The result line: ``checks`` last, ``breakdown`` and the device's busy
    and window seconds only from a traced run."""
    from bench.lib import cell
    trace = record.ctx.trace
    dev = {"platform": "gpu", "kind": kind, "count": chips,
           "memory_peak_bytes": record.memory_peak_bytes, "power_limit_w": power_w}
    out = {"correct": record.correct, "attempted": record.attempted, "failed": record.failed,
           "metrics": cell.metrics_of(bench, record, trace), "device": dev}
    if trace:
        dev["busy_s"] = record.tracer.busy_s()
        dev["window_s"] = record.tracer.window_s
        out["breakdown"] = record.tracer.breakdown()
    out["checks"] = record.checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the caching allocator's expandable segments: the trainer's large
    # short-lived temporaries (the proximal pass's fp32 logits) otherwise
    # fragment the card's memory between the rollout's allocations
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    build = os.path.join(ROOT, "build")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    for path in (os.path.join(ROOT, "src"), ROOT):
        if path not in sys.path:
            sys.path.insert(0, path)

    import torch
    from bench.lib import cell

    bench = cell.benchmark(ROOT)
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}.get(args.workload)
    if chips is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    ctx = cell.context(args.workload, args.seed, args.seconds, bool(args.trace), device,
                       PROCESS_START, bench)

    from repro_torch.kernels import build as kernels
    kernels.build_all()
    driver = importlib.import_module(f"bench.drivers.{ctx.mix['kind']}")
    record = driver.run(ctx)

    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    out = result(bench, record, torch.cuda.get_device_name(0), chips, power_limit_w())
    for name, value in record.readings.items():
        if name not in record.checks:
            print(f"reading {name} {value!r} (not compared)", file=sys.stderr)
    for name, c in record.checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
