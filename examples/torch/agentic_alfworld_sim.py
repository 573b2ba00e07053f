"""Agentic post-training on a simulated ALFWorld-style environment, the
PyTorch/CUDA port, with the paper's §5.2 mechanisms: environment-level
asynchronous rollout (EnvManager pool sharing one rollout service) and
redundant environment rollout (num_env_groups x group_size >
rollout_batch_size, fail-slow envs injected).

The twin of ``examples/agentic_alfworld_sim.py`` on ``repro_torch``.  Each
EnvManager drives a first-class ``Session`` (the handle-based client API):
the session owns the conversation context, version-tags every turn, and a
turn interrupted by a weight sync transparently RESUMES — on the paged
engine the retained KV pages are re-attached, so trajectories survive
syncs with zero re-prefill instead of being thrown away.  Runs on the CUDA
card unless ``--device`` names another device:

  python examples/torch/agentic_alfworld_sim.py [--steps 4] [--device cpu]
"""
import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "src"))

from repro_torch.configs import REGISTRY
from repro_torch.envs.sim_envs import GridTargetEnv, LatencyEnv
from repro_torch.launch.pipeline import PipelineSettings, build_agentic_pipeline

ap = argparse.ArgumentParser()
ap.add_argument("--steps", type=int, default=4)
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
args = ap.parse_args()

model = dataclasses.replace(
    REGISTRY["qwen3-4b"].smoke(),
    num_layers=2, d_model=128, num_heads=4, head_dim=32, num_kv_heads=2,
    d_ff=256, vocab_size=256)

settings = PipelineSettings(
    async_generation_ratio=1,
    pg_variant="topr",                 # T+/T- split suits sparse env rewards
    rollout_batch_size=8,
    num_slots=8,
    max_new_tokens=4,
    max_seq_len=64,
    weight_sync="overlapped",          # rollout keeps stepping through syncs
    agentic_context="full",            # sessions resubmit the conversation;
                                       # the prefix cache makes each turn an
                                       # incremental prefill
    learning_rate=1e-3,
)


# redundant env rollout: 5 groups x 3 envs = 15 > batch 8; some envs are
# fail-slow (5x latency) — the pool stops at 8 trajectories, stragglers
# never gate the step.
def make_env(eid):
    if eid % 5 == 0:
        return LatencyEnv(eid, mu=0.05, sigma=0.02, p_fail_slow=0.5,
                          fail_slow_factor=5.0, max_steps=3)
    return GridTargetEnv(eid, max_steps=6, latency=0.01)


pipe = build_agentic_pipeline(model, settings, make_env=make_env,
                              num_env_groups=5, group_size=3,
                              max_env_steps=6, device=args.device)
t0 = time.time()
stats = pipe.run(num_steps=args.steps)
print(f"\n{args.steps} agentic steps in {time.time() - t0:.1f}s "
      f"({len(pipe.pool.managers)} concurrent envs, "
      f"{settings.num_slots} decode slots)")
for s in stats:
    print(f"step {s.step}: wait {s.wait_time:.2f}s train {s.train_time:.2f}s "
          f"stale_max {s.staleness_max} reward {s.reward_mean:.2f}")
print("env-level async: decode slots stayed busy while envs were stepping;")
print(f"proxy completed {pipe.proxy.requests_completed} requests over "
      f"{pipe.proxy.steps_executed} engine steps "
      f"(suspends: {pipe.proxy.suspend_count} — overlapped sync)")
print(f"session turns rode the prefix cache: {pipe.proxy.cache_stats}")
print(f"in-flight turns resumed across weight syncs: "
      f"{pipe.client.resumes} page re-attaches, "
      f"{pipe.client.reprefills} re-prefills")
