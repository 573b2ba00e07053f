"""End-to-end RLVR training: the paper's launch entry point.

Runs the full asynchronous architecture — rollout engines + LLMProxy (a
ProxyRouter over ``--rollout-replicas`` of them) + SampleBuffer(alpha) +
RolloutProducer + AsyncController + HostTrainer — on a synthetic
verifiable-math task.  Model size is a preset: `demo` (~3M params,
CPU-friendly), `rl_100m` (~100M, the by-the-book e2e scale).  Runs on the
CUDA card unless ``--device`` names another device:

  PYTHONPATH=src python -m repro_torch.launch.train \
      --steps 60 --async-ratio 2 --pg-variant tis --group-size 4
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 2

Set --async-ratio 0 for the synchronous baseline (same code path, suspend
after get_batch — the paper's switch).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

from repro_torch.configs import REGISTRY
from repro_torch.data.dataset import VOCAB
from repro_torch.launch.pipeline import PipelineSettings, build_rlvr_pipeline

PRESETS = {
    # name: (d_model, layers, heads, kv, d_ff)  -- vocab = arithmetic VOCAB
    "demo": (128, 2, 4, 2, 512),
    "rl_10m": (256, 4, 4, 2, 1024),
    "rl_100m": (768, 12, 12, 4, 2048),
}


def build_model_cfg(arch: str, preset: str):
    d, l, h, kv, ff = PRESETS[preset]
    base = REGISTRY[arch].smoke()
    return dataclasses.replace(
        base, num_layers=l, d_model=d, num_heads=h, num_kv_heads=kv,
        head_dim=d // h, d_ff=ff, vocab_size=VOCAB,
        num_experts=min(base.num_experts, 4) if base.is_moe else 0,
        moe_d_ff=min(ff // 2, 512) if base.is_moe else 0)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b", choices=sorted(REGISTRY))
    ap.add_argument("--preset", default="demo", choices=sorted(PRESETS))
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--async-ratio", type=float, default=2.0)
    ap.add_argument("--pg-variant", default="ppo",
                    choices=["ppo", "decoupled_ppo", "tis", "cispo", "topr",
                             "weighted_topr"])
    ap.add_argument("--rollout-batch-size", type=int, default=16)
    ap.add_argument("--group-size", type=int, default=4)
    ap.add_argument("--num-slots", type=int, default=16)
    ap.add_argument("--rollout-replicas", type=int, default=1,
                    help="rollout fleet size: >=2 shards --num-slots across "
                         "N proxy/engine replicas behind a ProxyRouter "
                         "(queue scheduling)")
    ap.add_argument("--autoscale-max", type=int, default=0,
                    help="arm load-triggered elasticity: let the fleet grow "
                         "up to this many replicas under queue pressure and "
                         "drain idle ones back down (0 = off)")
    ap.add_argument("--health-probe-interval", type=float, default=0.0,
                    help="run the fleet heartbeat monitor at this period in "
                         "seconds: crashed replicas are detected and their "
                         "in-flight work failed over (0 = dispatch-time "
                         "detection only)")
    ap.add_argument("--slo", action="store_true",
                    help="arm the SLO layer: priority-aware admission, "
                         "preemption, and the deadline/stall watchdog")
    ap.add_argument("--slo-queue-limit", type=int, default=0,
                    help="fleet-wide pending bound per priority class; "
                         "overflow is resolved as a typed Rejected result "
                         "(0 = unbounded)")
    ap.add_argument("--slo-stall-timeout", type=float, default=0.0,
                    help="seconds without decode progress before an active "
                         "request is force-resolved timed_out (0 = off)")
    ap.add_argument("--slo-defer-after", type=int, default=0,
                    help="long-tail watchdog: park a decode that reached "
                         "this many tokens while work queues, so tails "
                         "never block batch completion (0 = off)")
    ap.add_argument("--rollout-quant", default="off",
                    choices=["off", "int8", "fp8"],
                    help="quantize rollout-engine weights at every weight "
                         "sync (trainer stays full precision); pair with "
                         "--tis-clip to absorb the engine mismatch")
    ap.add_argument("--kv-quant", default="off", choices=["off", "int8"],
                    help="store paged-engine KV pages as int8 with "
                         "per-(page,slot,kv-head) scales (~1.8x effective "
                         "KV capacity)")
    ap.add_argument("--tis-clip", type=float, default=0.0,
                    help="truncated-IS cap on the train/rollout engine "
                         "mismatch ratio (FlashRL); 0 = off, typical "
                         "quantized setting: 2.0")
    ap.add_argument("--cache-aware", dest="cache_aware", default=True,
                    action="store_true",
                    help="fleet-global prefix index: route to the replica "
                         "holding a prompt's longest cached prefix when "
                         "loads allow, pull pages across otherwise (default)")
    ap.add_argument("--no-cache-aware", dest="cache_aware",
                    action="store_false",
                    help="disable cache-aware routing (pure least-loaded)")
    ap.add_argument("--cache-affinity-slack", type=int, default=256,
                    help="load band (tokens over the fleet minimum) within "
                         "which the prefix-holding replica wins placement")
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="write step stats JSON here")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA card; "
                         "'cpu' runs the plain versions of the kernels)")
    args = ap.parse_args()

    cfg = build_model_cfg(args.arch, args.preset)
    settings = PipelineSettings(
        async_generation_ratio=args.async_ratio,
        pg_variant=args.pg_variant,
        rollout_batch_size=args.rollout_batch_size,
        num_return_sequences_in_group=args.group_size,
        num_slots=args.num_slots,
        num_rollout_replicas=args.rollout_replicas,
        autoscale_max_replicas=args.autoscale_max,
        health_probe_interval=args.health_probe_interval,
        slo_enabled=args.slo,
        slo_queue_limit_per_class=args.slo_queue_limit,
        slo_stall_timeout=args.slo_stall_timeout,
        slo_defer_after_tokens=args.slo_defer_after,
        rollout_quant=args.rollout_quant,
        kv_quant=args.kv_quant,
        tis_clip=args.tis_clip,
        cache_aware_routing=args.cache_aware,
        cache_affinity_slack=args.cache_affinity_slack,
        max_new_tokens=args.max_new_tokens,
        max_seq_len=32,
        learning_rate=args.lr,
        seed=args.seed,
    )
    try:
        pipe = build_rlvr_pipeline(cfg, settings, device=args.device)
    except ValueError as exc:       # e.g. the enc-dec, which no engine serves
        raise SystemExit(f"[train] arch={args.arch}: {exc}") from exc
    mode = "sync" if args.async_ratio == 0 else f"async(alpha={args.async_ratio})"
    print(f"[train] arch={args.arch} preset={args.preset} {mode} "
          f"variant={args.pg_variant} B={args.rollout_batch_size} "
          f"G={args.group_size}")
    if args.rollout_quant != "off" or args.kv_quant != "off":
        print(f"[train] quant: rollout={args.rollout_quant} "
              f"kv={args.kv_quant} tis_clip={args.tis_clip or 'off'}")

    t0 = time.time()
    stats = pipe.run(args.steps)
    wall = time.time() - t0

    rewards = [s.reward_mean for s in stats]
    k = max(1, len(rewards) // 5)
    print(f"[train] {len(stats)} steps in {wall:.1f}s "
          f"({wall / max(len(stats), 1):.2f}s/step)")
    print(f"[train] reward first-{k}: {sum(rewards[:k]) / k:.3f}  "
          f"last-{k}: {sum(rewards[-k:]) / k:.3f}")
    print(f"[train] staleness max: {max(s.staleness_max for s in stats)}  "
          f"samples produced/consumed: {pipe.buffer.total_produced}/"
          f"{pipe.buffer.total_consumed}")
    if pipe.router is not None:
        r = pipe.router
        print(f"[train] fleet: replicas={r.num_replicas} "
              f"alive={r.replicas_alive} added={r.replicas_added} "
              f"failed={r.replicas_failed} failovers={r.failovers} "
              f"lost_tokens={r.lost_tokens} migrations={r.migrations}")
        print(f"[train] fleet cache: cache_routed={r.cache_routed} "
              f"cache_pulls={r.cache_pulls} "
              f"pages_transferred={r.pages_transferred} "
              f"transfer_bytes={r.transfer_bytes}")
    if args.slo and stats:
        last = stats[-1]
        print(f"[train] slo: deadline_misses={last.deadline_misses} "
              f"preemptions={last.preemptions} rejected={last.rejected} "
              f"queue_depth_by_class={last.queue_depth_by_class}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump([dataclasses.asdict(s) for s in stats], f, indent=1)


if __name__ == "__main__":
    main()
