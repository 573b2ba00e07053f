"""Fixtures of the benchmark's tests: the repository's root and ``src`` on
the path, and tiny configurations of the cells that run on the CPU."""
import json
import os
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
for _p in (os.path.join(ROOT, "src"), ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)

# a Qwen3 at a test's size: the published configuration's keys, small widths
TINY = {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
        "num_key_value_heads": 2, "head_dim": 16, "intermediate_size": 128, "vocab_size": 512}

# each traffic kind's mix at a test's size
TINY_MIX = {
    "rlvr": dict(prompts=2, group=4, prompt_len=[8, 24], pool=8, max_new_tokens=8,
                 max_seq_len=32, slots=8, page_size=4, prefill_chunk=8, check_requests=3),
    "train": dict(prompts=2, group=4, prompt_len=[8, 24], response_len={"log_uniform": [2, 30]},
                  max_seq_len=48),
}


def tiny_context(workload: str, seed: int = 1234567890123, seconds: float = 2.0,
                 dtype: str = "bfloat16", **overrides):
    """A CPU context of ``workload`` at a test's size, with the cell's limits."""
    import torch
    from bench.lib import cell
    bench = cell.benchmark(ROOT)
    w = {x["name"]: x for x in bench["workloads"]}[workload]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(ROOT, entry["file"])) as f:
        cfg = dict(json.load(f), torch_dtype=dtype, **TINY)
    ctx = cell.context(workload, seed, seconds, False, torch.device("cpu"), time.perf_counter(),
                       bench, cfg_override=cfg)
    ctx.mix = dict(ctx.mix, **TINY_MIX[ctx.mix["kind"]])
    ctx.overrides.update(overrides)
    return ctx


@pytest.fixture
def tiny():
    return tiny_context
