#!/usr/bin/env python3
"""Readings that set a cell's limits, on the card, at the cell's own size.

    python3 bench/control.py --workload <name> --seeds 1,2,3 --mode sound|control|<fault>
                             [--seconds S]

Each seed runs in this process, one after the other, and prints one JSON
line: the numbers compared (``checks``) and whether they held.  The modes:

* ``sound``: the cell as ``run.py`` runs it (a short window): the lower
  readings.
* ``control``: the nearest precision below the configuration's bf16.
  Where the cell serves tokens, the program's own fp8 path
  (``rollout_quant="fp8"``: e4m3 weights with a scale per column,
  quantized at every sync).
  For the train step alone, which has no such path, the reference in the
  program's place, computing every product in float8 e4m3.
* ``int8``: the program's int8 rollout path (``rollout_quant="int8"``), a
  second step down that a later change could take.
* a fault of ``bench/lib/faults.py``, planted under the timed path.

``run.py`` never runs any of these.  The train cell needs no window for
its numbers and skips it.  The RL cell measures no rate here, but its
window has to run long enough (``--seconds``) for step 2 to end, so that
samples decoded after the first weight sync are compared.
"""
import argparse
import importlib
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)


def train_control(ctx) -> dict:
    """The fp8 reference against the fp32 reference on the first calls the
    train cell makes."""
    from bench.drivers import train
    from bench.lib import check, traffic, weights
    from bench.reference import grpo
    s = train.reference_settings(ctx)
    batches = traffic.train_batches(ctx.mix, ctx.cfg["vocab_size"], ctx.seed)
    calls = [next(batches) for _ in range(-(-ctx.mix["check_steps"] // ctx.mix["minibatches"]))]
    for i, batch in enumerate(calls):
        train.to_samples(batch, i * ctx.mix["prompts"])
    w = weights.stacked(ctx.cfg, ctx.seed, ctx.device)
    low = grpo.follow(ctx.cfg, w, calls, s, steps=ctx.mix["check_steps"], precision="fp8")
    probe = check.FollowerReadings(low)
    del low
    ref = grpo.follow(ctx.cfg, w, calls, s, steps=ctx.mix["check_steps"])
    return check.train_gaps(probe, ref)


def readings(workload: str, seed: int, mode: str, seconds: float, device) -> dict:
    """The numbers compared, each beside its limit, of one run in ``mode``."""
    import torch
    from bench.lib import cell
    ctx = cell.context(workload, seed, seconds, False, device, time.perf_counter())
    kind = ctx.mix["kind"]
    ctx.overrides["readings_only"] = True
    if mode == "control" and kind == "train":
        out = {k: {"value": v, "limit": ctx.limits[k]}
               for k, v in train_control(ctx).items() if k in ctx.limits}
    else:
        if mode in ("control", "int8"):
            ctx.overrides["rollout_quant"] = "fp8" if mode == "control" else "int8"
        elif mode != "sound":
            ctx.overrides["fault"] = mode
        rec = importlib.import_module(f"bench.drivers.{kind}").run(ctx)
        out = dict(rec.checks, synced_samples={"value": rec.readings.get("synced_samples"),
                                               "limit": None})
    cell.free_device(device)
    torch.cuda.reset_peak_memory_stats(device)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"    # as run.py
    for path in (os.path.join(ROOT, "src"), ROOT):
        if path not in sys.path:
            sys.path.insert(0, path)
    import torch
    from bench.lib import faults

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    if args.mode not in ("sound", "control", "int8") + faults.FAULTS:
        print(f"unknown mode {args.mode!r}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build
    build.build_all()
    device = torch.device("cuda", 0)
    for seed in (int(x) for x in args.seeds.split(",")):
        t = time.perf_counter()
        checks = readings(args.workload, seed, args.mode, args.seconds, device)
        print(json.dumps({"workload": args.workload, "mode": args.mode, "seed": seed,
                          "correct": all(c["value"] <= c["limit"] for c in checks.values()
                                         if c["limit"] is not None),
                          "checks": checks, "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
