"""The port's dry-run (``repro_torch.launch.dryrun``) beyond the plan
itself: the kernels' abstract evaluation, the depth extension of a trace,
the command line and the pools.  Each test that needs a process group
makes its own fake one and destroys it."""
import contextlib
import dataclasses
import json
import math

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
    and a prefill at 2, 3 and 4 query chunks, extended — gives exactly the
    FLOPs and the bytes accessed of the full trace: at depth 3 (the hybrid:
    2 pattern groups and a tail), and for the prefill, from 2, 3 and 4
    chunks, at 5 (10,240 tokens).  RWKV-6's train step, extended from ``_SERIAL_LENGTHS``
    (16, 32, 48, 515 and 516 tokens) in the tokens and the loss chunks,
    at 600 tokens (two loss chunks, the last of 87 positions)."""
    extra = {"num_encoder_layers": 3} if arch == "seamless-m4t-medium" else {}
    jcfg = tiny(arch, num_layers=7 if arch == "recurrentgemma-9b" else 3, **extra)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    cases = [("train_4k", 16), ("decode_32k", 16), ("prefill_32k", 5 * dryrun._LENGTH_UNIT)]
    if arch == "rwkv6-3b":
        cases[0] = ("train_4k", 600)
    for shape_name, seq in cases:
        sh = dataclasses.replace(SHAPES[shape_name], seq_len=seq,
                                 global_batch=4 if shape_name == "train_4k" else 1)
        full = dryrun.trace_step(cfg, sh, memory=False)
        ext = dryrun.trace_step(cfg, sh, memory=False, extend=True)
        assert ext["flops_global"] == full["flops_global"] > 0, shape_name
        assert ext["bytes_global"] == full["bytes_global"] > 0, shape_name


def test_bytes_accessed_of_a_matmul_and_a_kernel_call_equal_a_hand_count():
    """``_byte_counter`` over one matmul: (8, 16) @ (16, 32) bf16 reads 256 +
    1,024 bytes and writes 512 (the transpose's view reads nothing), 1,792;
    over the flash forward's abstract op on q, k, v (2, 4, 8, 16) fp32
    (4,096 bytes each), its outputs o (4,096) and lse (2, 4, 8) fp32
    (256): 16,640 bytes."""
    a = torch.empty((8, 16), dtype=torch.bfloat16, device="meta")
    w = torch.empty((32, 16), dtype=torch.bfloat16, device="meta")
    with dryrun._byte_counter() as counted:
        a @ w.t()
    assert counted.total == 8 * 16 * 2 + 16 * 32 * 2 + 8 * 32 * 2 == 1792
    q = torch.empty((2, 4, 8, 16), dtype=torch.float32, device="meta")
    with build.abstract_kernels(), dryrun._byte_counter() as counted:
        o, lse = fa.flash_attention_fwd(q, q, q)
    assert (tuple(o.shape), tuple(lse.shape)) == ((2, 4, 8, 16), (2, 4, 8))
    assert counted.total == 4 * 4096 + 2 * 4 * 8 * 4 == 16640


def _one_layer_mesh(shape):
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh("cpu", torch.arange(math.prod(shape)).reshape(shape),
                      mesh_dim_names=("data", "model"))


def test_partitioned_decode_issues_the_hand_counted_collectives():
    """A one-layer tiny dense decode step (vocab 64, d_model 64, 4 query and
    2 KV heads of 16, d_ff 128, bf16, untied head; batch 4, cache 16) on a
    (data 2, model 2) fake mesh issues exactly, in bytes of each local
    output:

    * data axis, all-gathers (FSDP): the embedding (32 vocab rows x 64) 4,096;
      the layer's wq 4,096, wk 2,048, wv 2,048, wo 4,096, wi_gate 8,192,
      wi_up 8,192, mlp wo 8,192; the head (64 x 32 vocab columns) 4,096:
      10 gathers, 45,056 bytes;
    * model axis: the new K and V rows (2 rows x 2 heads x 16) brought to
      the cache's slot split, 128 each; the decode kernel's query (2 x 4 x
      16), replicated where the cache splits its sequence, 256 (all-gathers,
      512); the embedding's partial sums (2 x 1 x 64) 256, the kernel's split
      outputs (2 x 4 x 16) 256, the attention's and the MLP's row-parallel
      outputs (2 x 1 x 64) 256 each (all-reduces, 1,024):

    12 all-gathers of 45,568 bytes and 4 all-reduces of 1,024, 16 in all."""
    cfg = ModelConfig(**dataclasses.asdict(tiny("qwen3-4b", num_layers=1)))
    sh = dataclasses.replace(SHAPES["decode_32k"], seq_len=16, global_batch=4)
    with _fake_group(4):
        got = dryrun._partitioned_once(cfg, sh, _one_layer_mesh((2, 2)))
    assert {k: got[k] for k in dryrun._COLLECTIVES + ("count",)} == {
        "all-gather": 45568, "all-reduce": 1024, "reduce-scatter": 0, "all-to-all": 0,
        "collective-permute": 0, "count": 16}
    assert (got["axis:data"], got["axis:model"]) == (45056, 1536)


@contextlib.contextmanager
def _fake_group(world):
    from repro_torch.launch.mesh import fake_process_group
    with fake_process_group(world):
        yield


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
    # every number the reference's record holds, but the compile time
    for rec in (single, multi):
        assert set(rec["nulls"]) == {"compile_s"}
        assert rec["memory"]["temp_bytes"] > 0 and rec["bytes_accessed"] > 0
        assert rec["memory"]["peak_bytes"] == (rec["memory"]["argument_bytes"]
                                               + rec["memory"]["temp_bytes"])
        assert rec["collectives"]["count"] > 0 and rec["collectives"]["all-gather"] > 0
        assert rec["bytes_accessed"] == rec["bytes_accessed_global"] / rec["devices"]
    # the 8 KV heads do not split 16 ways: the record says what was gathered
    assert "8 KV heads do not split 16 ways" in single["method"]["layout"]


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
