"""The plain reference against the port, through the harness's own entries
(the drivers), at a tiny size in fp32 on the CPU: where both compute in
fp32 they agree to rounding, so every number compared is near zero."""
import importlib

import numpy as np
import pytest
import torch

from bench.lib import weights
from bench.reference.qwen3 import Qwen3
from bench.tests.conftest import tiny_context

FP32_GAP = 1e-4      # fp32 against fp32: reduction order only


def _run(workload, **kw):
    ctx = tiny_context(workload, dtype="float32", **kw)
    return importlib.import_module(f"bench.drivers.{ctx.mix['kind']}").run(ctx)


@pytest.mark.parametrize("workload", ["train_grpo.qwen3-1.7b", "rlvr_async.qwen3-1.7b"])
def test_reference_agrees_with_the_port_in_fp32(workload):
    rec = _run(workload)
    gaps = {k: c["value"] for k, c in rec.checks.items()}
    assert gaps and all(v <= FP32_GAP for v in gaps.values()), gaps


@pytest.mark.parametrize("tied", [True, False])
def test_reference_logprobs_match_the_ports_forward(tied):
    from bench.lib.cell import model_config
    from repro_torch.models import get_api
    ctx = tiny_context("train_grpo.qwen3-1.7b", dtype="float32")
    ctx.cfg["tie_word_embeddings"] = tied
    w = weights.stacked(ctx.cfg, 5, "cpu")
    api = get_api(model_config(ctx.cfg), device="cpu")
    tokens = torch.randint(3, 512, (1, 12), generator=torch.Generator().manual_seed(0))
    logits, _ = api.apply(weights.port_tree(w), {"tokens": tokens}, attn_impl="ref")
    want = torch.log_softmax(logits[0, 3:11].float(), -1).gather(1, tokens[0, 4:12, None])[:, 0]
    got = Qwen3(ctx.cfg, w).response_logprobs(tokens[0, :4], tokens[0, 4:])
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_fp8_control_rounds_the_weights():
    ctx = tiny_context("train_grpo.qwen3-1.7b", dtype="float32")
    w = weights.stacked(ctx.cfg, 5, "cpu")
    tokens = torch.arange(3, 15)
    exact = Qwen3(ctx.cfg, w).response_logprobs(tokens[:4], tokens[4:])
    low = Qwen3(ctx.cfg, w, precision="fp8").response_logprobs(tokens[:4], tokens[4:])
    assert 1e-4 < float((exact - low).abs().max()) < 1.0
