"""The port's sharding plan (``repro_torch.models.sharding``) held against
the JAX package's on the CPU, and the port's dry-run records.

* ``param_specs`` and ``cache_specs`` equal the reference's, leaf by leaf,
  for every registry arch at full width, on the production meshes (1x1,
  16x16, 2x16x16) and the pools' (8x16, 16x16).  The reference plans over
  ``jax.eval_shape`` trees and ``AbstractMesh``es (no devices); the port
  over meta-device trees and ``DeviceMesh``es on one fake process group of
  512 ranks, made and destroyed by this module.
* The unit-mesh dry-run records' per-device ``argument_bytes`` equal the
  reference's shard bytes summed from its shardings (the port's optimizer
  ``step`` is a host int: 4 bytes fewer for a train step), and for one
  decode combo the reference's compiled ``argument_size_in_bytes``.
"""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch
from torch.distributed.device_mesh import DeviceMesh

from conftest import tiny
from repro.configs import REGISTRY as JREGISTRY
from repro.models import get_api as jget_api
from repro.models import sharding as jshd
from repro_torch import convert
from repro_torch.configs import REGISTRY, SHAPES, shape_applicable
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (fake_process_group, make_host_mesh,
                                     make_production_mesh, split_rollout_train_pools)
from repro_torch.models import ModelConfig, get_api
from repro_torch.models import sharding as shd

torch.set_num_threads(1)

ARCHS = sorted(REGISTRY)
MESHES = ["1x1", "16x16", "2x16x16", "pool_train_8x16", "pool_infer_16x16"]


@pytest.fixture(scope="module")
def meshes():
    with fake_process_group(512):
        train, infer = split_rollout_train_pools(train_chips=128, infer_chips=256)
        yield {"1x1": make_host_mesh(), "16x16": make_production_mesh(),
               "2x16x16": make_production_mesh(multi_pod=True),
               "pool_train_8x16": train, "pool_infer_16x16": infer}


def _abstract_mesh(sizes: dict):
    from jax.sharding import AbstractMesh
    names, shape = tuple(sizes), tuple(sizes.values())
    try:  # jax >= 0.5: AbstractMesh(axis_sizes, axis_names)
        return AbstractMesh(shape, names)
    except TypeError:  # jax 0.4.x: AbstractMesh(((name, size), ...))
        return AbstractMesh(tuple(zip(names, shape)))


def _norm(spec) -> tuple:
    """A spec as a tuple, a one-axis tuple entry as its name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


def _ref_flat(tree):
    return {jshd._path_str(p): s for p, s in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}


class _Layers(list):
    """A stacked leaf's per-layer port specs."""


def _port_flat(spec_tree, cfg):
    """The port's spec tree in the reference's layout: stacked leaves as
    ``_Layers`` of their per-layer specs."""
    def walk(node, path, out):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,), out)
        elif isinstance(node, list) and not isinstance(node, _Layers):
            for i, v in enumerate(node):
                walk(v, path + (str(i),), out)
        else:
            out["/".join(path)] = node
        return out

    layout = convert.to_jax_layout(spec_tree, cfg, leaf=lambda s: s, stack=_Layers)
    return walk(layout, (), {})


def _assert_param_specs_equal(ref: dict, port: dict, where: str):
    assert set(ref) == set(port), where
    for path, rspec in ref.items():
        r, p = _norm(rspec), port[path]
        if isinstance(p, _Layers):
            # the stacked leaf's spec: the per-layer spec behind an
            # unsharded stacking axis (or replicated throughout)
            for layer in p:
                assert (r == () and layer == ()) or (r[0] is None and r[1:] == _norm(layer)), \
                    f"{where} {path}: reference {r}, port layer {layer}"
        else:
            assert r == _norm(p), f"{where} {path}: reference {r}, port {p}"


def _ref_cache_layers(jcache_specs, cfg):
    """The reference's cache specs as per-layer lists keyed by the port's
    stacks: (stack name, field) -> [per-layer spec]."""
    def per_layer(spec, stacked):
        spec = _norm(spec)
        if not stacked:
            return spec
        assert spec[0] is None
        return spec[1:]

    if cfg.family == "hybrid":
        out = {}
        pattern = cfg.block_pattern
        n_groups = cfg.num_layers // len(pattern)
        layers = [(jcache_specs[f"{i}_{kind}"], kind, g)
                  for g in range(n_groups) for i, kind in enumerate(pattern)]
        layers += [(st, kind, None) for st, kind in
                   zip(jcache_specs["tail"], pattern[:cfg.num_layers - n_groups * len(pattern)])]
        for st, kind, g in layers:
            stack = "kv" if kind == "attn" else "rglru"
            for field in st._fields:
                out.setdefault((stack, field), []).append(
                    per_layer(getattr(st, field), g is not None))
        return out
    if cfg.family == "audio":
        out = {("self_kv", f): getattr(jcache_specs["self"], f) for f in ("k", "v", "pos")}
        out.update({("", "cross_k"): jcache_specs["cross_k"],
                    ("", "cross_v"): jcache_specs["cross_v"]})
    else:
        out = {("", f): getattr(jcache_specs, f) for f in jcache_specs._fields}
    return {k: [per_layer(v, True)] for k, v in out.items()}


def _port_cache_layers(cache, specs, cfg):
    """The port's cache specs, per stack and field, each stacked spec
    without its layer axis, repeated per layer where the reference keeps
    one spec for the stack."""
    def fields(node, spec):
        return {f: (getattr(node, f), getattr(spec, f)) for f in node._fields
                if isinstance(getattr(node, f), torch.Tensor)}

    out = {}
    if cfg.family == "hybrid":
        for stack in ("kv", "rglru"):
            for f, (t, s) in fields(getattr(cache, stack), getattr(specs, stack)).items():
                assert s[0] is None
                out[(stack, f)] = [_norm(s[1:])] * t.shape[0]
        return out
    if cfg.family == "audio":
        for f, (t, s) in fields(cache.self_kv, specs.self_kv).items():
            out[("self_kv", f)] = [_norm(s[1:])]
        for f in ("cross_k", "cross_v"):
            out[("", f)] = [_norm(getattr(specs, f)[1:])]
        return out
    for f, (t, s) in fields(cache, specs).items():
        out[("", f)] = [_norm(s[1:])]
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_plan_equals_the_reference_leaf_by_leaf(arch, meshes):
    """Every param leaf's spec and every cache leaf's spec (each applicable
    decode / prefill shape's cache) equals the reference's on every mesh."""
    cfg = REGISTRY[arch]
    jcfg = JREGISTRY[arch]
    japi = jget_api(jcfg)
    jparams = jax.eval_shape(japi.init, jax.ShapeDtypeStruct((2,), np.uint32))
    api = get_api(cfg, device="meta")
    params = api.init(0)
    caches = []
    for shape in SHAPES.values():
        if shape.kind != "train" and shape_applicable(cfg, shape)[0]:
            caches.append((shape, jax.eval_shape(
                lambda b=shape.global_batch, s=shape.seq_len: japi.init_cache(b, s)),
                api.init_cache(shape.global_batch, shape.seq_len)))
    for name in MESHES:
        mesh = meshes[name]
        amesh = _abstract_mesh(shd.mesh_axis_sizes(mesh))
        where = f"{arch} on {name}"
        port = shd.param_specs(params, mesh, cfg)
        _assert_param_specs_equal(_ref_flat(jshd.param_specs(jparams, amesh)),
                                  _port_flat(port, cfg), where)
        for shape, jcache, cache in caches:
            ok = shd.shardable_batch(mesh, shape.global_batch)
            assert ok == jshd.shardable_batch(amesh, shape.global_batch)
            ref = _ref_cache_layers(jshd.cache_specs(jcache, amesh, shard_batch=ok), cfg)
            got = _port_cache_layers(cache, shd.cache_specs(cache, mesh, shard_batch=ok), cfg)
            assert set(ref) == set(got), where
            for key in ref:
                want = ref[key] * (len(got[key]) // len(ref[key]) if len(ref[key]) == 1 else 1)
                assert got[key] == want, f"{where} {shape.name} cache {key}"


def test_sharding_helpers_match_the_reference(meshes):
    """Batch axes, data specs and batch shardability on every mesh; the
    divisibility fallback; DTensor placements of a spec."""
    from torch.distributed.tensor import Replicate, Shard
    for name in MESHES:
        mesh = meshes[name]
        amesh = _abstract_mesh(shd.mesh_axis_sizes(mesh))
        assert shd.batch_axes(mesh) == jshd.batch_axes(amesh)
        for b in (1, 16, 32, 128, 256, 512):
            assert shd.shardable_batch(mesh, b) == jshd.shardable_batch(amesh, b)
        assert _norm(shd.data_spec(mesh, 3)) == _norm(tuple(jshd.data_spec(amesh, 3)))
    sizes = {"data": 16, "model": 16}
    assert shd._spec_for("blocks/attn/wq", (3, 120), sizes) == (None, None)
    assert shd._spec_for("blocks/attn/wq", (3, 128), sizes) == (None, "model")
    pod = {"pod": 2, "data": 16, "model": 16}
    assert shd._spec_for("blocks/attn/wq", (4, 64, 128), pod) == (None, ("data", "pod"), "model")
    assert shd._spec_for("blocks/attn/wq", (4, 48, 128), pod) == (None, "data", "model")
    multi = meshes["2x16x16"]
    assert shd.param_placements((None, ("data", "pod"), "model"), multi) == \
        (Shard(1), Shard(1), Shard(2))
    assert shd.param_placements((), multi) == (Replicate(),) * 3
    assert shd.local_shape((4, 64, 128), (None, ("data", "pod"), "model"), multi) == (4, 2, 8)


def test_activation_hook_is_a_noop_on_plain_tensors_and_redistributes_dtensors(meshes):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    x = torch.ones((2, 4, 8))
    shd.set_activation_sharding(None)
    assert shd.constrain_activation(x) is x
    shd.set_activation_sharding((("data",), "model", None))
    try:
        assert shd.constrain_activation(x) is x            # not a DTensor
        mesh = meshes["1x1"]
        d = distribute_tensor(x, mesh, (Replicate(), Replicate()))
        c = shd.constrain_activation(d)
        assert tuple(c.placements) == (Shard(0), Shard(1))
        assert shd.constrain_activation(c) is c
        assert shd.constrain_activation(d[0]) is d[0] or shd.constrain_activation(d[0]).ndim == 2
    finally:
        shd.set_activation_sharding(None)


UNIT_COMBOS = [("qwen3-4b", "train_4k"), ("qwen3-moe-235b-a22b", "decode_32k"),
               ("rwkv6-3b", "long_500k"), ("seamless-m4t-medium", "prefill_32k")]


def _tiny_combo(arch, shape_name, **shape_kw):
    jcfg = tiny(arch)
    sh = dataclasses.replace(SHAPES[shape_name], **{"seq_len": 64, "global_batch": 2,
                                                    **shape_kw})
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg)), sh


def _ref_shard_bytes(args, in_shard) -> int:
    leaves = jax.tree_util.tree_leaves(args)
    shardings = jax.tree_util.tree_leaves(
        in_shard, is_leaf=lambda x: isinstance(x, jax.sharding.Sharding))
    assert len(leaves) == len(shardings)
    return sum(math.prod(s.shard_shape(x.shape)) * x.dtype.itemsize
               for x, s in zip(leaves, shardings))


@pytest.mark.parametrize("arch,shape_name", UNIT_COMBOS)
def test_unit_mesh_argument_bytes_equal_the_reference(arch, shape_name, meshes):
    jax.devices()            # the backend exists before the reference's dry-run is imported
    from repro.configs import SHAPES as JSHAPES
    from repro.launch import dryrun as jdryrun

    jcfg, cfg, sh = _tiny_combo(arch, shape_name)
    jsh = dataclasses.replace(JSHAPES[shape_name], seq_len=64, global_batch=2)
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    fn, args, in_shard, out_shard, donate = jdryrun.build_combo(jcfg, jsh, jmesh)
    ref = _ref_shard_bytes(args, in_shard)
    rec = dryrun.run_combo(arch, shape_name, "host", mesh=meshes["1x1"], cfg=cfg,
                           shape=sh, save=False, verbose=False)
    assert rec["status"] == "ok", rec.get("error")
    step = 4 if sh.kind == "train" else 0          # the reference's int32 opt step
    assert rec["memory"]["argument_bytes"] == ref - step
    assert rec["memory"]["peak_bytes"] == (rec["memory"]["argument_bytes"]
                                           + rec["memory"]["temp_bytes"])
    assert rec["flops"] > 0 and rec["collectives"]["count"] == 0
    if arch == "qwen3-moe-235b-a22b":
        # an attention decode step reads every argument (XLA drops the ones
        # a step never reads from its count: a PPO step's ref_logprobs, an
        # RWKV-6 decode step's positions)
        with jmesh:
            compiled = jax.jit(fn, in_shardings=in_shard, out_shardings=out_shard,
                               donate_argnums=donate).lower(*args).compile()
        assert rec["memory"]["argument_bytes"] == \
            compiled.memory_analysis().argument_size_in_bytes - step


FAMILY_COMBOS = [("qwen3-4b", "train_4k"), ("qwen3-moe-235b-a22b", "train_4k"),
                 ("rwkv6-3b", "prefill_32k"), ("recurrentgemma-9b", "decode_32k"),
                 ("paligemma-3b", "train_4k"), ("seamless-m4t-medium", "decode_32k")]


@pytest.mark.parametrize("arch,shape_name", FAMILY_COMBOS)
def test_run_combo_on_a_fake_4x4_group(arch, shape_name, meshes):
    """One combo per family through ``run_combo`` on 16 ranks of the fake
    group (4 x 4) at tiny size: status ok, per-device arguments the shard
    bytes of a batch split four ways, FLOPs the global count / 16, and the
    numbers a 16-device mesh cannot give null with their reasons."""
    _, cfg, sh = _tiny_combo(arch, shape_name, global_batch=4)
    mesh = DeviceMesh("cpu", torch.arange(16).reshape(4, 4), mesh_dim_names=("data", "model"))
    rec = dryrun.run_combo(arch, shape_name, "4x4", mesh=mesh, cfg=cfg, shape=sh,
                           save=False, verbose=False)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["devices"] == 16
    assert rec["flops"] == rec["flops_global"] / 16 and rec["flops"] > 0
    unit = dryrun.run_combo(arch, shape_name, "host", mesh=meshes["1x1"], cfg=cfg, shape=sh,
                            save=False, verbose=False)
    assert unit["flops_global"] == rec["flops_global"]
    assert 0 < rec["memory"]["argument_bytes"] < unit["memory"]["argument_bytes"]
    # the partitioned run's numbers, or DTensor's refusal as their reason
    if rec["collectives"] is None:
        assert rec["memory"]["peak_bytes"] is None
        assert rec["nulls"]["collectives"] == rec["nulls"]["peak_bytes"]
        assert rec["nulls"]["collectives"].startswith(("DTensor could not run",
                                                       "DTensor's partitioned step"))
    else:
        assert rec["memory"]["peak_bytes"] == (rec["memory"]["argument_bytes"]
                                               + rec["memory"]["temp_bytes"])


@pytest.mark.parametrize("arch,shape_name,mesh_shape", [
    ("rwkv6-3b", "prefill_32k", (4, 1)), ("qwen3-4b", "decode_32k", (4, 4))])
def test_partitioned_trace_on_a_fake_group(arch, shape_name, mesh_shape, meshes):
    """The step on DTensors over the fake group, the reference's activation
    spec installed: on a data-only mesh it runs, and each device's temp
    bytes are below one device's on the unit mesh, with the collectives
    the batch split issues; where
    DTensor refuses an op, the numbers are null with its error and the
    port's line.  The activation spec is cleared after either."""
    _, cfg, sh = _tiny_combo(arch, shape_name, global_batch=4)
    mesh = DeviceMesh("cpu", torch.arange(16)[:math.prod(mesh_shape)].reshape(mesh_shape),
                      mesh_dim_names=("data", "model"))
    rec = dryrun.run_combo(arch, shape_name, "part", mesh=mesh, cfg=cfg, shape=sh,
                           save=False, verbose=False)
    assert rec["status"] == "ok", rec.get("traceback")
    assert shd._ACTIVATION_SPEC[0] is None
    if mesh_shape[1] > 1:
        assert rec["collectives"] is None and rec["memory"]["temp_bytes"] is None
        # the tiny config's 2 KV heads do not split over a 4-way model axis
        assert rec["nulls"]["collectives"].startswith("DTensor could not run")
        assert "at repro_torch/models/attention.py:" in rec["nulls"]["collectives"]
        return
    unit = dryrun.run_combo(arch, shape_name, "host", mesh=meshes["1x1"], cfg=cfg, shape=sh,
                            save=False, verbose=False)
    coll = rec["collectives"]
    assert 0 < rec["memory"]["temp_bytes"] < unit["memory"]["temp_bytes"]
    assert coll["count"] > 0 and coll["all-gather"] > 0


def test_partitioned_trace_over_its_budget_is_null_with_its_reason(meshes, monkeypatch):
    monkeypatch.setattr(dryrun, "PARTITIONED_BUDGET_S", 1e-3)
    _, cfg, sh = _tiny_combo("qwen3-4b", "train_4k", global_batch=4)
    mesh = DeviceMesh("cpu", torch.arange(4).reshape(4, 1), mesh_dim_names=("data", "model"))
    part = dryrun.partitioned_trace(cfg, sh, mesh)
    assert part["why"].startswith("DTensor's partitioned step did not finish within 0.001 s")


def test_rwkv_train_step_past_the_serial_budget_is_null_with_its_reason(meshes):
    rec = dryrun.run_combo("rwkv6-3b", "train_4k", "host", mesh=meshes["1x1"],
                           save=False, verbose=False,
                           trace=dryrun.trace_step(REGISTRY["rwkv6-3b"], SHAPES["train_4k"],
                                                   memory=False, extend=True))
    assert rec["status"] == "ok" and rec["flops"] is None
    assert "WKV" in rec["nulls"]["flops"]
    assert rec["memory"]["argument_bytes"] > 0 and rec["memory"]["output_bytes"] > 0


def test_skipped_combo_keeps_the_reference_reason():
    rec = dryrun.run_combo("qwen3-8b", "long_500k", "single", save=False, verbose=False)
    assert rec["status"] == "skipped" and "long_500k" in rec["reason"]


def test_input_shapes_equal_the_reference():
    """Every ``InputShape``, and the shapes and dtypes ``input_specs``
    gives (meta tensors here, ``ShapeDtypeStruct``s there) for every arch
    and shape; ``shape_applicable`` alike."""
    from repro.configs import shapes as jshapes
    from repro_torch.configs import shapes

    assert {k: dataclasses.asdict(v) for k, v in shapes.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jshapes.SHAPES.items()}
    for arch in ARCHS:
        for name in SHAPES:
            cfg, jcfg, sh, jsh = REGISTRY[arch], JREGISTRY[arch], SHAPES[name], jshapes.SHAPES[name]
            assert shapes.shape_applicable(cfg, sh) == jshapes.shape_applicable(jcfg, jsh)
            got, want = shapes.input_specs(cfg, sh), jshapes.input_specs(jcfg, jsh)
            assert list(got) == list(want), (arch, name)
            for k in want:
                assert got[k].device.type == "meta"
                assert tuple(got[k].shape) == tuple(want[k].shape), (arch, name, k)
                assert str(got[k].dtype).removeprefix("torch.") == str(want[k].dtype), \
                    (arch, name, k)
