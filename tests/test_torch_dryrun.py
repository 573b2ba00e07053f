"""The port's dry-run (``repro_torch.launch.dryrun``) beyond the plan
itself: the kernels' abstract evaluation, the depth extension of a trace,
the command line and the pools.  Each test that needs a process group
makes its own fake one and destroys it."""
import dataclasses
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

from conftest import tiny
from repro_torch.configs import SHAPES
from repro_torch.kernels import build, decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rglru_scan as lru
from repro_torch.kernels import rwkv6_scan as wkv
from repro_torch.launch import dryrun
from repro_torch.models import ModelConfig

torch.set_num_threads(1)


def _flops(fn, *args):
    with FlopCounterMode(display=False) as counter:
        out = fn(*args)
    return counter.get_total_flops(), out


def test_abstract_kernels_give_shapes_and_the_plain_versions_flops():
    """Inside ``abstract_kernels`` a wrapper takes meta tensors and returns
    its outputs' shapes and dtypes, counting the products
    ``FlopCounterMode`` counts in its plain version on the same shapes;
    outside it a meta tensor is refused, and nothing is counted as a
    launch either way."""
    rng = np.random.default_rng(0)

    def pair(*shape, dtype=torch.float32):
        t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
        return t, torch.empty(shape, dtype=dtype, device="meta")

    (q, qm), (k, km), (v, vm) = pair(2, 4, 8, 16), pair(2, 2, 8, 16), pair(2, 2, 8, 16)
    (qd, qdm), (kd, kdm) = pair(2, 4, 16), pair(2, 24, 2, 16)
    lens = torch.tensor([5, 24])
    (r, rm), (u, um), (st, stm) = pair(2, 6, 2, 8), pair(2, 8), pair(2, 2, 8, 8)
    (a, am), (h0, h0m) = pair(2, 6, 12), pair(2, 12)
    launches = (fa.flash_attention.launches_fwd, da.decode_attention.launches,
                wkv.rwkv6_scan.launches, lru.rglru_scan.launches)
    with pytest.raises(ValueError, match="device"):
        fa.flash_attention_fwd(qm, km, vm)
    with build.abstract_kernels():
        cases = [
            (fa.flash_attention_fwd, (q, k, v), (qm, km, vm)),
            (lambda *x: fa.flash_attention_bwd(*x), (q, k, v) + tuple(fa.flash_attention_fwd(q, k, v))
             + (q,), None),
            (da.decode_attention, (qd, kd, kd, lens), (qdm, kdm, kdm, lens.to("meta"))),
            (wkv.rwkv6_scan, (r, r, r, r, u, st), (rm, rm, rm, rm, um, stm)),
            (lru.rglru_scan, (a, a, h0), (am, am, h0m)),
        ]
        for fn, real, meta in cases:
            if meta is None:                          # the backward's meta inputs
                meta = tuple(torch.empty(t.shape, dtype=t.dtype, device="meta") for t in real)
            want_flops, want = _flops(fn, *real)
            got_flops, got = _flops(fn, *meta)
            want = want if isinstance(want, tuple) else (want,)
            got = got if isinstance(got, tuple) else (got,)
            assert [(t.shape, t.dtype) for t in got] == [(t.shape, t.dtype) for t in want]
            assert all(t.device.type == "meta" for t in got)
            assert got_flops == want_flops, fn
    assert launches == (fa.flash_attention.launches_fwd, da.decode_attention.launches,
                        wkv.rwkv6_scan.launches, lru.rglru_scan.launches)


@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen3-moe-235b-a22b", "rwkv6-3b",
                                  "recurrentgemma-9b", "paligemma-3b",
                                  "seamless-m4t-medium"])
def test_extended_flops_equal_the_full_trace(arch):
    """``trace_step(extend=True)`` — the least depth and one unit deeper,
    and a prefill at 1, 2 and 3 query chunks, extended — gives exactly the
    FLOPs of the full trace: at depth 3 (the hybrid: 2 pattern groups and
    a tail), and for the prefill at 4 chunks (8,192 tokens)."""
    extra = {"num_encoder_layers": 3} if arch == "seamless-m4t-medium" else {}
    jcfg = tiny(arch, num_layers=7 if arch == "recurrentgemma-9b" else 3, **extra)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    for shape_name, seq in (("train_4k", 16), ("decode_32k", 16),
                            ("prefill_32k", 4 * dryrun._LENGTH_UNIT)):
        sh = dataclasses.replace(SHAPES[shape_name], seq_len=seq,
                                 global_batch=4 if shape_name == "train_4k" else 1)
        full = dryrun.trace_step(cfg, sh, memory=False)
        ext = dryrun.trace_step(cfg, sh, memory=False, extend=True)
        assert ext["flops_global"] == full["flops_global"] > 0, shape_name


def test_command_line_writes_one_record_per_combo(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "OUT_DIR", str(tmp_path))
    dryrun.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k", "--mesh", "both"])
    assert not dist.is_initialized()
    recs = {p.name: json.loads(p.read_text()) for p in tmp_path.glob("*.json")}
    assert set(recs) == {"qwen3-0.6b__decode_32k__single.json",
                         "qwen3-0.6b__decode_32k__multi.json"}
    single, multi = (recs[f"qwen3-0.6b__decode_32k__{m}.json"] for m in ("single", "multi"))
    assert single["status"] == multi["status"] == "ok"
    assert (single["devices"], multi["devices"]) == (256, 512)
    assert single["flops_global"] == multi["flops_global"]
    assert multi["memory"]["argument_bytes"] < single["memory"]["argument_bytes"]
    for key in ("arch", "shape", "mesh", "status", "lower_s", "compile_s", "devices",
                "flops", "bytes_accessed", "memory", "collectives"):
        assert key in single
    assert set(single["nulls"]) == {"compile_s", "bytes_accessed", "temp_bytes",
                                    "peak_bytes", "collectives"}
    # DTensor refuses the GQA head split (8 KV heads over a 16-way axis)
    assert single["nulls"]["collectives"].startswith("DTensor could not run")
    assert "models/attention.py" in single["nulls"]["collectives"]


def test_pools_plan_both_pools_and_sync_the_smoke_params(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "OUT_DIR", str(tmp_path))
    rec = dryrun.run_pools("qwen3-0.6b")
    assert not dist.is_initialized()
    assert rec["status"] == "ok"
    assert (rec["train_mesh"], rec["infer_mesh"]) == ("(8, 16)", "(16, 16)")
    assert rec["train_flops_dev"] > 0 and rec["serve_flops_dev"] > 0
    assert rec["weight_sync_bytes"] > 0
    assert rec["weight_sync_collectives"].get("all_gather_into_tensor", 0) > 0
    assert json.loads((tmp_path / "pools__qwen3-0.6b.json").read_text())["status"] == "ok"


def test_failed_combo_is_recorded_and_fails_the_command_line(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "OUT_DIR", str(tmp_path))

    def boom(*a, **kw):
        raise RuntimeError("planted")

    monkeypatch.setattr(dryrun, "plan_record", boom)
    with pytest.raises(SystemExit) as exc:
        dryrun.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k"])
    assert exc.value.code == 1
    rec = json.loads((tmp_path / "qwen3-0.6b__decode_32k__single.json").read_text())
    assert rec["status"] == "failed" and "planted" in rec["error"]
