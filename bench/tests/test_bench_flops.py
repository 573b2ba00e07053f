"""Model FLOPs, the flash roofline's bytes and operations, against hand counts
at a tiny configuration (2 layers, d 64, 4 heads over 2 of 16, d_ff 128,
vocabulary 512)."""
import types

import pytest

from bench.lib import flops
from bench.tests.conftest import TINY

CFG = dict(TINY)


def test_matmul_params_by_hand():
    # a layer: q 64x64, k and v 64x32 each, o 64x64, gate, up and down 64x128
    per_layer = 64 * 64 + 2 * 64 * 32 + 64 * 64 + 3 * 64 * 128
    assert per_layer == 36864
    assert flops.matmul_params(CFG) == 2 * 36864 + 64 * 512 == 106496
    assert flops.head_params(CFG) == 32768


def test_causal_pairs_and_attention():
    assert flops.causal_pairs(4) == 10                 # 1 + 2 + 3 + 4
    assert flops.attention_flops(CFG, 10) == 4 * 2 * 4 * 16 * 10 == 5120


def test_forward_flops():
    assert flops.forward_flops(CFG, [4]) == 2 * 106496 * 4 + 5120 == 857088
    assert flops.forward_flops(CFG, [4, 4]) == 2 * 857088


def test_flash_bound_by_hand():
    f = flops.flash_bound(1, 4, 2, 4, 16, backward=False)
    qo, kv, lse = 1 * 4 * 4 * 16 * 2, 1 * 2 * 4 * 16 * 2, 4 * 1 * 4 * 4
    assert f["flops"] == 4 * 16 * 4 * 10 == 2560
    assert f["bytes"] == 2 * qo + 2 * kv + lse == 1600
    b = flops.flash_bound(1, 4, 2, 4, 16, backward=True)
    assert b["flops"] == 10 * 16 * 4 * 10 == 6400
    assert b["bytes"] == 3 * qo + 4 * kv + lse == 2624
    big = flops.flash_bound(16, 16, 8, 1024, 128, backward=False)
    assert big["bound_by"] == "operations"


def test_train_step_flops_counts_the_proximal_pass():
    from bench.drivers import train
    s = types.SimpleNamespace(pg_variant="decoupled_ppo", minibatches=2, ppo_epochs=1,
                              max_seq_len=4)
    assert train.step_flops(CFG, [4], s) == 4 * 857088          # prox + 3 x forward
    per = train.flash_per_step(CFG, 2, s)
    assert (per["fwd"], per["bwd"]) == (2 * 3, 2 * 2)            # layers x (prox + 2), x 2
    want = 2 * (flops.flash_bound(2, 4, 2, 4, 16, False)["seconds"]
                + 2 * (flops.flash_bound(1, 4, 2, 4, 16, False)["seconds"]
                       + flops.flash_bound(1, 4, 2, 4, 16, True)["seconds"]))
    assert per["seconds"] == pytest.approx(want)

