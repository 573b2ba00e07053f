"""The dry-run's partitioned step (``repro_torch.launch.dryrun.
partitioned_trace``): its extensions from a few depths and lengths held to
one run at the full depth and length, on a (2, 2) fake mesh at tiny size.
Each test makes its own fake process group and destroys it."""
import dataclasses

import pytest
import torch
from torch.distributed.device_mesh import DeviceMesh

from conftest import tiny
from repro_torch.configs import SHAPES
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_process_group
from repro_torch.models import ModelConfig

torch.set_num_threads(1)


def _mesh():
    return DeviceMesh("cpu", torch.arange(4).reshape(2, 2), mesh_dim_names=("data", "model"))


def _collectives(full):
    return ({k: full[k] for k in dryrun._COLLECTIVES + ("count",)},
            {"data": full["axis:data"], "model": full["axis:model"]})


@pytest.mark.parametrize("arch,layers", [
    ("qwen3-4b", {"num_layers": 13}), ("qwen3-moe-235b-a22b", {"num_layers": 13}),
    ("rwkv6-3b", {"num_layers": 7}), ("recurrentgemma-9b", {"num_layers": 21}),
    ("paligemma-3b", {"num_layers": 13}),
    ("seamless-m4t-medium", {"num_layers": 9, "num_encoder_layers": 9})])
def test_partitioned_extensions_equal_the_full_run(arch, layers):
    """``partitioned_trace`` on a (2, 2) fake mesh equals one run at the
    full depth, for each family's train, decode and prefill steps (the
    RWKV-6 train step aside: its lengths are extended, its temp null): the
    collectives extended from one unit (a train step: ``_TRAIN_UNITS``)
    and one unit deeper per stack; the temp bytes extended where
    ``_settled_temp`` shows them settled, else (here the hybrid's and the
    enc-dec's train steps, whose guard runs would cost more than the full
    depth) from a run at full depth."""
    cfg = ModelConfig(**dataclasses.asdict(tiny(arch, **layers)))
    hows = set()
    with fake_process_group(4):
        mesh = _mesh()
        for shape_name, seq, batch in (("train_4k", 16, 8), ("decode_32k", 16, 4),
                                       ("prefill_32k", 64, 4)):
            if arch == "rwkv6-3b" and shape_name == "train_4k":
                continue
            sh = dataclasses.replace(SHAPES[shape_name], seq_len=seq, global_batch=batch)
            part = dryrun.partitioned_trace(cfg, sh, mesh)
            full = dryrun._partitioned_once(cfg, sh, mesh)
            assert (part["collectives"], part["by_axis"]) == _collectives(full), shape_name
            assert part["temp_bytes"] == full["temp"], (shape_name, part["temp_how"])
            hows.add(part["temp_how"])
    # the extensions ran, not only full-depth fallbacks
    assert any(not h.startswith(dryrun._FULL_DEPTH) for h in hows), hows




def test_rwkv_train_collectives_extend_from_short_lengths():
    """RWKV-6's train step on the (2, 2) mesh: its collectives extended
    from ``_SERIAL_PART_LENGTHS`` (16 and 32 tokens at one and two layers,
    528 and 544 at one) equal one run at two layers and 608 tokens (two
    loss chunks); its temp bytes are null, with the reason."""
    cfg = ModelConfig(**dataclasses.asdict(tiny("rwkv6-3b", num_layers=2)))
    sh = dataclasses.replace(SHAPES["train_4k"], seq_len=608, global_batch=4)
    with fake_process_group(4):
        mesh = _mesh()
        part = dryrun.partitioned_trace(cfg, sh, mesh)
        full = dryrun._partitioned_once(cfg, sh, mesh)
    assert (part["collectives"], part["by_axis"]) == _collectives(full)
    assert part["collectives"]["count"] > 0
    assert part["temp_bytes"] is None and "WKV" in part["why_temp"]
