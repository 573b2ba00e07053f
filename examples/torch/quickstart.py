"""Quickstart, the PyTorch/CUDA port: the ROLL Flash public API in ~60 lines.

The twin of ``examples/quickstart.py`` on ``repro_torch``.  Part 1 drives
the handle-based rollout client directly (submit -> GenerationHandle ->
result/stream); part 2 builds the asynchronous training pipeline on a tiny
model and runs two steps (overlapped weight sync: rollout never stops while
the trainer swaps params).  Runs on the CUDA card unless ``--device``
names another device:

  python examples/torch/quickstart.py
  python examples/torch/quickstart.py --device cpu
"""
import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "src"))

import numpy as np

from repro_torch.configs import REGISTRY
from repro_torch.core import LLMProxy, RolloutClient, RolloutTask
from repro_torch.data.dataset import VOCAB
from repro_torch.launch.pipeline import (PipelineSettings, build_rlvr_pipeline,
                                         make_rollout_engine)
from repro_torch.models import get_api

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
device = ap.parse_args().device

# 1. a tiny architecture config (reduced variant)
model = dataclasses.replace(
    REGISTRY["qwen3-4b"].smoke(),
    num_layers=2, d_model=64, num_heads=4, head_dim=16, num_kv_heads=2,
    d_ff=128, vocab_size=VOCAB)

# ---------------------------------------------------------------- handles
# The rollout surface: a RolloutClient over an LLMProxy issues handles.
settings = PipelineSettings(num_slots=4, max_new_tokens=6, max_seq_len=32)
api = get_api(model, device=device)
engine = make_rollout_engine(api, api.init(0), settings)
proxy = LLMProxy(engine).start()
client = RolloutClient(proxy)

task = RolloutTask(task_id=0, prompt_id=0, replica_idx=0,
                   prompt_tokens=np.asarray([3, 1, 4, 1, 5], np.int32),
                   max_new_tokens=6)
handle = client.submit(task, stream=True)      # -> GenerationHandle
chunks = [list(c) for c in handle.stream()]    # incremental tokens
result = handle.result(timeout=60)             # resolves exactly once
print(f"handle: tokens={list(result.tokens)} streamed_chunks={len(chunks)} "
      f"legs={result.legs}")
proxy.stop()

# --------------------------------------------------------------- pipeline
# 2. the async architecture, configured like the paper's appendix-A YAML
settings = PipelineSettings(
    async_generation_ratio=2,      # the asynchronous ratio alpha (0 = Sync)
    pg_variant="tis",              # off-policy corrector
    rollout_batch_size=8,          # samples per training step
    num_return_sequences_in_group=2,
    num_slots=4,                   # decode slots (the rollout "GPUs")
    max_new_tokens=4,
    max_seq_len=32,
    weight_sync="overlapped",      # staged swap: rollout never suspends
    learning_rate=3e-3,
)

# 3. build + run: engine -> LLMProxy -> RolloutClient -> SampleBuffer(alpha)
#    -> RolloutProducer (handle consumer) -> AsyncController (train)
pipe = build_rlvr_pipeline(model, settings, device=device)
stats = pipe.run(num_steps=2)

print(f"\n{'step':>4} {'wait_s':>7} {'train_s':>8} {'sync_s':>7} "
      f"{'stale_max':>9} {'reward':>7}")
for s in stats:
    print(f"{s.step:>4} {s.wait_time:>7.2f} {s.train_time:>8.2f} "
          f"{s.sync_time:>7.3f} {s.staleness_max:>9} {s.reward_mean:>7.2f}")
print(f"\nbuffer: produced={pipe.buffer.total_produced} "
      f"consumed={pipe.buffer.total_consumed} capacity={pipe.buffer.capacity}")
print("overlapped sync: proxy never suspended:",
      pipe.proxy.suspend_count == 0)
print("staleness never exceeded alpha:",
      all(s.staleness_max <= settings.async_generation_ratio for s in stats))
