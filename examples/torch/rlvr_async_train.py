"""End-to-end RLVR driver, the PyTorch/CUDA port: async GRPO-style training
on the verifiable arithmetic task, comparing sync (alpha=0) vs async
(alpha=2).

The twin of ``examples/rlvr_async_train.py`` on ``repro_torch``.  The async
mode runs on the handle-based client API end to end: the RolloutProducer
consumes GenerationHandles (abort→resume continuation and budget clamping
live in the RolloutClient), and the controller uses the OVERLAPPED weight
sync — params are staged per-proxy between engine steps, so rollout never
suspends (pass --weight-sync blocking for the 3-phase barrier).
``--preset rl_100m --steps 300`` runs the by-the-book ~100M-parameter
configuration.  Runs on the CUDA card unless ``--device`` names another
device:

  python examples/torch/rlvr_async_train.py [--steps 60] [--device cpu]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "src"))

import numpy as np

from repro_torch.data.dataset import ArithmeticTask
from repro_torch.launch.pipeline import PipelineSettings, build_rlvr_pipeline
from repro_torch.launch.train import PRESETS, build_model_cfg


def run_mode(alpha, steps, preset, seed=0, weight_sync="overlapped",
             replicas=1, device="cuda"):
    model = build_model_cfg("qwen3-4b", preset)
    task = ArithmeticTask(max_operand=4, ops=("+",), seed=seed)
    settings = PipelineSettings(
        async_generation_ratio=alpha, pg_variant="tis",
        rollout_batch_size=16, num_return_sequences_in_group=8,
        num_slots=16, max_new_tokens=4, max_seq_len=16,
        weight_sync=weight_sync, learning_rate=5e-3, seed=seed,
        # --replicas N shards the 16 slots across N proxy/engine replicas
        # behind a ProxyRouter (queue scheduling + co-located groups);
        # N=1 is the plain single-proxy path.
        num_rollout_replicas=replicas)
    pipe = build_rlvr_pipeline(model, settings, task=task, device=device)
    t0 = time.time()
    stats = pipe.run(num_steps=steps, timeout=1800)
    wall = time.time() - t0
    rewards = [s.reward_mean for s in stats]
    return rewards, wall, max(s.staleness_max for s in stats)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--preset", default="demo", choices=sorted(PRESETS))
    ap.add_argument("--weight-sync", default="overlapped",
                    choices=["overlapped", "blocking"])
    ap.add_argument("--replicas", type=int, default=1,
                    help="rollout fleet size (num_rollout_replicas)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    for name, alpha in (("sync (alpha=0)", 0), ("async (alpha=2)", 2)):
        rewards, wall, stale = run_mode(alpha, args.steps, args.preset,
                                        weight_sync=args.weight_sync,
                                        replicas=args.replicas, device=args.device)
        k = max(2, len(rewards) // 5)
        print(f"{name:16s}: {wall:6.1f}s  reward {np.mean(rewards[:k]):.3f} "
              f"-> {np.mean(rewards[-k:]):.3f}  max_staleness={stale}")


if __name__ == "__main__":
    main()
