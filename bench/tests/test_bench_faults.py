"""Each fault a cell can have, planted under the timed path of a tiny run
on the CPU (the harness's look for a card skipped), turns ``correct``
false under the cell's own limits; the same run without a fault is
correct."""
import importlib

import pytest

from bench.tests.conftest import tiny_context

CASES = [
    ("train_grpo.qwen3-1.7b", "frozen_step"),
    ("train_grpo.qwen3-1.7b", "half_batch"),
    ("rlvr_async.qwen3-1.7b", "frozen_step"),
    ("rlvr_async.qwen3-1.7b", "half_batch"),
    ("rlvr_async.qwen3-1.7b", "altered_token"),
]


def _run(workload, **overrides):
    ctx = tiny_context(workload, **overrides)
    return importlib.import_module(f"bench.drivers.{ctx.mix['kind']}").run(ctx)


@pytest.mark.parametrize("workload, fault", CASES)
def test_a_planted_fault_is_not_correct(workload, fault):
    rec = _run(workload, fault=fault)
    assert not rec.correct, rec.checks


@pytest.mark.parametrize("workload", sorted({w for w, _ in CASES}))
def test_the_sound_run_is_correct(workload):
    rec = _run(workload)
    assert rec.correct, rec.checks


def test_a_skewed_sync_fails_the_served_tokens_decoded_after_it():
    # the tree swapped in is not the published one, so sync_mismatch fails
    # too; the served tokens' comparison has to fail by itself
    rec = _run("rlvr_async.qwen3-1.7b", fault="skewed_sync")
    assert rec.readings["synced_samples"] > 0
    assert rec.checks["logprob_gap"]["value"] > rec.checks["logprob_gap"]["limit"], rec.checks

