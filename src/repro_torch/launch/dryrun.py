"""Multi-pod dry-run: plan and trace every (arch x input-shape x mesh).

The port of the JAX package's ``launch/dryrun.py``.  For each combination
it builds the reference's step (``build_combo``: the train step with
remat, prefill, or one decode step against a cache of ``seq_len``) over
abstract state — tensors on the ``meta`` device, nothing allocated — with
every argument sharded by the production rules (``models/sharding.py``)
over the reference's meshes (``launch/mesh.py``, built on torch's fake
process group), traces the step, and records per device:

  * ``memory.argument_bytes`` / ``memory.output_bytes`` — exact: each
    argument's (output's) shard bytes from its spec and shape.  The train
    state's optimizer ``step`` is a host int in the port (the reference
    holds it as a 4-byte device scalar).  Outputs the reference leaves to
    its partitioner (logits, metrics) are sharded by batch where it splits.
  * ``flops`` — ``torch.utils.flop_counter.FlopCounterMode`` over the
    meta trace of the whole (global) step, divided by the mesh's device
    count: the even split of the plan.  The counter counts matmul-class
    ops (mm, bmm, addmm, baddbmm, sdpa) and the port's kernels at their
    products (``kernels/build.py``'s abstract op), not elementwise work.
  * ``memory.temp_bytes`` / ``peak_bytes`` — from
    ``torch.distributed._tools.mem_tracker.MemTracker``: the peak of the
    bytes the step allocates (its outputs included), and arguments + temp.
    On a 1x1 mesh over the meta trace; on a larger one over the step run
    on DTensors over the fake group (``partitioned_trace``: every argument
    a DTensor of its spec's local shard, the reference's activation spec
    installed), where the tracker counts each device's local tensors.
  * ``collectives`` — none on a 1x1 mesh (zeros); on a larger one
    ``torch.distributed.tensor.debug.CommDebugMode``'s counts and bytes
    by kind over the same partitioned run.  Where DTensor's sharding
    propagation refuses an op of the step, or the run outlasts
    ``PARTITIONED_BUDGET_S``, the three are null and the reason is
    DTensor's error (or the budget) and the port's line it stopped at.

A number the port cannot obtain is null, with its reason under the
record's ``nulls``, and counted in the summary line; a combo that raises
is ``status="failed"`` and makes ``main`` exit 1.  ``run_pools`` plans
the decoupled trainer and rollout pools and runs a weight sync of the
smoke-size parameters from one pool's placements to the other's.

Results land in experiments/dryrun_torch/<arch>__<shape>__<mesh>.json.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --pools
"""
from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import functools
import json
import logging
import multiprocessing
import os
import signal
import time
import traceback
import warnings
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.algos import LossConfig
from repro_torch.configs import REGISTRY, SHAPES, InputShape, input_specs, shape_applicable
from repro_torch.kernels import build
from repro_torch.launch.mesh import (fake_process_group, make_host_mesh,
                                     make_production_mesh, split_rollout_train_pools)
from repro_torch.models import attention, get_api, moe, sharding as shd
from repro_torch.models.config import ModelConfig
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.trainer import make_train_step

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
MESH_WORLD = {"host": 1, "single": 256, "multi": 512}

# The RWKV-6 train step differentiates the plain WKV scan: one step of
# Python per token and layer, each traced op by op, forward and backward
# (4,096 x 32 for the full step).  A trace over more token x layer steps
# than this is not made.
_MAX_SERIAL_SCAN_STEPS = 1 << 11

# Prefill lengths in whole query chunks of the plain attention (which are
# whole KV blocks and whole MoE dispatch groups): there every product of a
# prefill is a polynomial of degree <= 2 in the length.
_LENGTH_UNIT = attention._Q_CHUNK
if _LENGTH_UNIT % attention._KV_BLOCK or _LENGTH_UNIT % moe._GROUP:
    raise ImportError("dryrun: a query chunk must hold whole KV blocks and MoE groups")

_FLOPS_METHOD = ("torch.utils.flop_counter.FlopCounterMode over a meta-tensor trace "
                 "of the global step (matmul-class ops and the port's kernels' "
                 "products; elementwise ops not counted), divided by the devices")
_EXTENDED = ("; traced at the least depth and one unit deeper per stack (a prefill "
             "also at 2,048, 4,096 and 6,144 tokens) and extended exactly to the full "
             "depth (affine in the layers) and length (degree 2 in whole 2,048-token "
             "query chunks)")
_PARTITIONED_METHOD = ("over the step run on DTensors over the fake group at full "
                       "depth (every argument its spec's local shard; activations "
                       "constrained to the reference's spec)")
# what DTensor raises where its sharding propagation refuses an op
_REFUSALS = (RuntimeError, NotImplementedError, IndexError)
# wall seconds one partitioned run may take (DTensor's propagation of some
# ops at full size takes minutes: the AdamW's flat view of a column-sharded
# 256k-row embedding, 24 s for one view)
PARTITIONED_BUDGET_S = 10.0


class _OverBudget(Exception):
    pass


def _over_budget(signum, frame):
    raise _OverBudget()


@dataclasses.dataclass
class Combo:
    """One step over abstract state: ``fn(*args)``, each argument's spec
    tree (``None`` for a host value), ``grad``: whether the step runs
    under autograd, ``out_specs(outputs)``: the outputs' spec tree."""
    fn: Callable
    args: tuple
    specs: tuple
    grad: bool
    out_specs: Callable
    attn_impl: str


def decode_attn_impl(cfg: ModelConfig, max_len: int) -> str:
    """The decode kernel where it takes the config's cache, else the plain
    attention: the kernel refuses a softcap and a ring cache (a sliding
    window shorter than the cache)."""
    if cfg.attn_logit_softcap is not None:
        return "ref"
    if cfg.sliding_window is not None and cfg.sliding_window < max_len:
        return "ref"
    return "kernel"


@functools.lru_cache(maxsize=2)
def _abstract(cfg: ModelConfig, shape: InputShape):
    """(api, params, the optimizer state or the cache, inputs) on the meta
    device; kept for the next mesh of the same combo (nothing in them has
    a value to change)."""
    api = get_api(cfg, device="meta")
    params = api.init(0)
    if shape.kind == "train":
        carried = init_opt_state(params)
    else:
        carried = api.init_cache(shape.global_batch, shape.seq_len)
    return api, params, carried, input_specs(cfg, shape)


def build_combo(cfg: ModelConfig, shape: InputShape, mesh) -> Combo:
    """The reference's step for ``shape.kind`` over meta state, with the
    specs of its arguments on ``mesh``."""
    api, params, carried, inputs = _abstract(cfg, shape)
    batch_ok = shd.shardable_batch(mesh, shape.global_batch)
    bspec = shd.batch_axes(mesh) if batch_ok else None

    def dspec(x):
        spec = [None] * x.dim()
        if spec and x.shape[0] == shape.global_batch:
            spec[0] = bspec
        return tuple(spec)

    in_spec = {k: dspec(v) for k, v in inputs.items()}

    if shape.kind == "train":
        state = {"params": params, "opt": carried}
        state_spec = shd.param_specs(state, mesh, cfg)
        # MoE configs need grad accumulation to fit activations per device
        mb = 4 if cfg.is_moe else 1
        fn = make_train_step(api, LossConfig(pg_variant="ppo", kl_beta=0.0),
                             OptConfig(), remat=True, moe_mode="ep",
                             microbatches=mb, attn_impl="kernel")

        def out_specs(out):
            return state_spec, {k: () for k in out[1]}

        return Combo(fn, (state, inputs), (state_spec, in_spec), True, out_specs,
                     "kernel")

    pspec = shd.param_specs(params, mesh, cfg)
    cache = carried
    cspec = shd.cache_specs(cache, mesh, shard_batch=batch_ok)

    def out_specs(out):
        return shd.data_spec(mesh, out[0].dim(), shard_batch=batch_ok), cspec

    if shape.kind == "prefill":
        def fn(params, batch, cache):
            return api.prefill(params, batch, cache, attn_impl="kernel")

        return Combo(fn, (params, inputs, cache), (pspec, in_spec, cspec), False,
                     out_specs, "kernel")

    # decode: serve_step — ONE new token against a seq_len cache
    impl = decode_attn_impl(cfg, shape.seq_len)

    def fn(params, token, pos, cache):
        return api.decode_step(params, token, pos, cache, attn_impl=impl)

    return Combo(fn, (params, inputs["token"], inputs["pos"], cache),
                 (pspec, (bspec,), (bspec,), cspec), False, out_specs, impl)


def _leaves(tree) -> list:
    out: list = []
    shd._tree_map(out.append, tree)
    return out


def _describe(out) -> Dict[str, Any]:
    """The step's outputs other than the state or cache it returns (the
    same shapes as that argument): the train step's metrics (a host float,
    the learning rate, is no device output), or the logits, as picklable
    (shape, dtype) pairs."""
    first, second = out
    extra = second if isinstance(second, dict) else {"logits": first}
    return {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in extra.items() if isinstance(v, torch.Tensor)}


def _outputs(combo: Combo, described: Dict[str, Any]):
    """Meta stand-ins of the step's outputs from ``_describe``'s record."""
    extra = {k: torch.empty(shape, dtype=getattr(torch, dt), device="meta")
             for k, (shape, dt) in described.items()}
    if combo.grad:                       # (new state, metrics)
        return combo.args[0], extra
    return extra["logits"], combo.args[-1]


def _serial_scan_steps(cfg: ModelConfig, shape: InputShape) -> int:
    """Python steps of the plain WKV scan the step differentiates (0 if
    none)."""
    if cfg.family == "ssm" and shape.kind == "train":
        return shape.seq_len * cfg.num_layers
    return 0


def _depth_variants(cfg: ModelConfig):
    """(the config at its least depth, [(a config one repeated unit deeper
    in one stack, the units that stack has beyond the least depth)]): one
    layer (a pattern group and the tail for the hybrid; one encoder and
    one decoder layer for the enc-dec).  Every unit of a stack runs the
    same ops at the same shapes, so a step's FLOPs are affine in the units
    of each stack."""
    rep = dataclasses.replace
    if cfg.family == "audio":
        base = rep(cfg, num_encoder_layers=1, num_layers=1)
        return base, [(rep(base, num_encoder_layers=2), cfg.num_encoder_layers - 1),
                      (rep(base, num_layers=2), cfg.num_layers - 1)]
    if cfg.family == "hybrid":
        unit = len(cfg.block_pattern)
        tail = cfg.num_layers % unit
        base = rep(cfg, num_layers=unit + tail)
        return base, [(rep(cfg, num_layers=2 * unit + tail), cfg.num_layers // unit - 1)]
    return rep(cfg, num_layers=1), [(rep(cfg, num_layers=2), cfg.num_layers - 1)]


def _trace_once(cfg: ModelConfig, shape: InputShape, memory: bool):
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    combo = build_combo(cfg, shape, {"data": 1, "model": 1})
    tracker = None
    if memory:
        # the arguments are tracked as "other" memory, so that a write into
        # one of them (the cache) is not counted as a new allocation
        tracker = MemTracker()
        tracker.track_external(*[t for a in combo.args for t in _leaves(a)])
    with build.abstract_kernels(), torch.set_grad_enabled(combo.grad), \
            FlopCounterMode(display=False) as counter:
        if tracker is None:
            result = combo.fn(*combo.args)
        else:
            with tracker:
                result = combo.fn(*combo.args)
    temp = None
    if tracker is not None:
        from torch.distributed._tools.mem_tracker import _MemRefType
        peak = tracker.get_tracker_snapshot("peak")
        temp = int(sum(dev["Total"] - dev.get(_MemRefType.OTH, 0) for dev in peak.values()))
    return int(counter.get_total_flops()), _describe(result), temp


def _extended_flops(cfg: ModelConfig, shape: InputShape):
    """(FLOPs of the step at full depth and length, its outputs) from
    small traces: the least depth and one unit deeper per stack
    (``_depth_variants``; affine in the units), and for a prefill longer
    than three ``_LENGTH_UNIT``s the same at 1, 2 and 3 units (a
    polynomial of degree 2 in the units), each extended exactly."""
    described = []

    def at_depth(sh):
        base, deeper = _depth_variants(cfg)
        f0, outputs, _ = _trace_once(base, sh, False)
        described.append(outputs)
        return f0 + sum(units * (_trace_once(c, sh, False)[0] - f0) for c, units in deeper)

    t, rem = divmod(shape.seq_len, _LENGTH_UNIT)
    if shape.kind != "prefill" or rem or t <= 3:
        return at_depth(shape), described[0]
    f1, f2, f3 = (at_depth(dataclasses.replace(shape, seq_len=k * _LENGTH_UNIT))
                  for k in (1, 2, 3))
    # Lagrange through t = 1, 2, 3 (integer weights: products of
    # consecutive integers are even)
    flops = ((t - 2) * (t - 3) // 2 * f1 - (t - 1) * (t - 3) * f2
             + (t - 1) * (t - 2) // 2 * f3)
    return flops, described[0]


def trace_step(cfg: ModelConfig, shape: InputShape, *, memory: bool,
               extend: bool = False) -> Dict[str, Any]:
    """Trace the step of (cfg, shape) on meta tensors: its global FLOPs
    (``FlopCounterMode``) and, with ``memory``, the peak bytes it allocates
    (``MemTracker``).  ``extend``: FLOPs from small traces extended to the
    full depth and length, exactly (``_extended_flops``; no ``memory``
    then).  The plan's mesh does not change the trace."""
    if extend and memory:
        raise ValueError("extended traces give FLOPs only")
    if extend:
        base, deeper = _depth_variants(cfg)
        traced = [base] + [c for c, _ in deeper]
    else:
        traced = [cfg]
    steps = sum(_serial_scan_steps(c, shape) for c in traced)
    if steps > _MAX_SERIAL_SCAN_STEPS:
        # the outputs' shapes from the same step at one layer and 16 tokens
        # (its metrics are 0-dim whatever the depth and length)
        small = build_combo(dataclasses.replace(cfg, num_layers=1),
                            dataclasses.replace(shape, seq_len=16), {"data": 1})
        with build.abstract_kernels():
            outputs = _describe(small.fn(*small.args))
        return {"flops_global": None, "temp_bytes": None, "trace_s": None,
                "outputs": outputs,
                "why": (f"not traced: the train step differentiates the plain WKV "
                        f"scan, one Python step per token and layer, each traced op "
                        f"by op ({steps} steps for the traced depths, more than "
                        f"{_MAX_SERIAL_SCAN_STEPS})")}
    t0 = time.perf_counter()
    if extend:
        flops, outputs = _extended_flops(cfg, shape)
        temp = None
    else:
        flops, outputs, temp = _trace_once(cfg, shape, memory)
    return {"flops_global": flops, "outputs": outputs, "temp_bytes": temp,
            "extended": extend, "trace_s": round(time.perf_counter() - t0, 3)}


def _distributed(tree, specs, mesh):
    """``tree`` with every tensor a DTensor over ``mesh`` placed by its spec,
    its local shard a meta tensor (nothing allocated)."""
    from torch.distributed.tensor import DTensor

    def one(t, spec):
        local = torch.empty(shd.local_shape(t.shape, spec, mesh), dtype=t.dtype,
                            device="meta")
        return DTensor.from_local(local, mesh, shd.param_placements(spec, mesh),
                                  run_check=False, shape=t.shape, stride=t.stride())

    return shd.tree_map_specs(one, tree, specs)


def _refusal(e: BaseException) -> str:
    """DTensor's error (its first line), or the budget it ran over, and the
    port's innermost line where it stopped."""
    frames = [f for f in traceback.extract_tb(e.__traceback__)
              if "repro_torch" in f.filename]
    where = ""
    if frames:
        f = frames[-1]
        where = f" at {f.filename.split('src/')[-1]}:{f.lineno}"
    cause = e
    while cause is not None and not isinstance(cause, _OverBudget):
        cause = cause.__cause__ or cause.__context__
    if cause is not None:               # DTensor wraps what its propagation raises
        return (f"DTensor's partitioned step did not finish within "
                f"{PARTITIONED_BUDGET_S:g} s{where}")
    # the first line, without the operands' specs (shapes differ by arch)
    first = str(e).strip().splitlines()[0].split("(Spec(")[0][:200] if str(e).strip() else ""
    return f"DTensor could not run the partitioned step: {type(e).__name__}: {first}{where}"


def _comm_counter():
    """A ``CommDebugMode`` that also sums, by kind, the bytes of each
    collective's local output (what the reference reads off its HLO)."""
    from torch.distributed.tensor.debug import CommDebugMode

    class _Counter(CommDebugMode):
        def __init__(self):
            super().__init__()
            self.bytes: Dict[str, float] = {k: 0.0 for k in _COLLECTIVES}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            before = self.get_total_counts()
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if self.get_total_counts() > before:
                kind = _collective_kind(func)
                self.bytes[kind] = self.bytes.get(kind, 0.0) + sum(
                    t.numel() * t.element_size() for t in _leaves(out))
            return out

    return _Counter()


def _collective_kind(op) -> str:
    name = str(getattr(op, "__name__", op))
    for kind in _COLLECTIVES:
        if kind.replace("-", "_") in name:
            return kind
    return name


def _partitioned_once(cfg: ModelConfig, shape: InputShape, mesh) -> Dict[str, Any]:
    from torch.distributed._tools.mem_tracker import MemTracker, _MemRefType
    from torch.distributed.tensor.experimental import implicit_replication

    combo = build_combo(cfg, shape, mesh)
    args = tuple(a if s is None else _distributed(a, s, mesh)
                 for a, s in zip(combo.args, combo.specs))
    bspec = shd.batch_axes(mesh) if shd.shardable_batch(mesh, shape.global_batch) else None
    tracker = MemTracker()
    tracker.track_external(*[t for a in args for t in _leaves(a)])
    comm = _comm_counter()
    # DTensor warns at every redistribution over two mesh dims at once
    log = logging.getLogger("torch.distributed.tensor._redistribute")
    level = log.level
    log.setLevel(logging.ERROR)
    # the reference's sequence-parallel residual stream
    shd.set_activation_sharding((bspec, "model", None))
    handler = signal.signal(signal.SIGALRM, _over_budget)
    signal.setitimer(signal.ITIMER_REAL, PARTITIONED_BUDGET_S)
    try:
        with build.abstract_kernels(), implicit_replication(), warnings.catch_warnings(), \
                torch.set_grad_enabled(combo.grad), comm, tracker:
            # implicit_replication's notice at each one-element tensor
            warnings.filterwarnings("ignore", "Found a non-scalar tensor")
            combo.fn(*args)
    except _REFUSALS + (_OverBudget,) as e:
        return {"why": _refusal(e)}
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, handler)
        shd.set_activation_sharding(None)
        log.setLevel(level)
    peak = tracker.get_tracker_snapshot("peak")
    temp = int(sum(dev["Total"] - dev.get(_MemRefType.OTH, 0) for dev in peak.values()))
    return {"temp_bytes": temp,
            "collectives": dict(comm.bytes, count=int(comm.get_total_counts()))}


def partitioned_trace(cfg: ModelConfig, shape: InputShape, mesh) -> Dict[str, Any]:
    """The step of (cfg, shape) run on DTensors over ``mesh`` (a mesh of the
    fake group): each device's temp bytes (``MemTracker``) and the
    collectives it issues (``CommDebugMode``: bytes by kind, and their
    count), or ``why`` not.  First at the least depth (``_depth_variants``), where a refusal
    shows in one layer; then, if that ran, at full depth.  Each run gets
    ``PARTITIONED_BUDGET_S`` of wall time (a ``SIGALRM``: call it on the
    main thread)."""
    steps = _serial_scan_steps(cfg, shape)
    if steps > _MAX_SERIAL_SCAN_STEPS:
        return {"why": (f"not traced: the train step differentiates the plain WKV "
                        f"scan, one Python step per token and layer ({steps} steps, "
                        f"more than {_MAX_SERIAL_SCAN_STEPS})")}
    t0 = time.perf_counter()
    out = _partitioned_once(_depth_variants(cfg)[0], shape, mesh)
    if "why" not in out:
        out = _partitioned_once(cfg, shape, mesh)
    out["trace_s"] = round(time.perf_counter() - t0, 3)
    return out


def _mesh_by_name(mesh_name: str):
    if mesh_name == "host":
        return make_host_mesh()
    return make_production_mesh(multi_pod=(mesh_name == "multi"))


def plan_record(cfg: ModelConfig, shape: InputShape, mesh, trace: Dict[str, Any],
                lower_s: float) -> Dict[str, Any]:
    """The record of (cfg, shape) on ``mesh`` from its plan, its trace and,
    beyond a 1x1 mesh, its partitioned run (``partitioned_trace``)."""
    n_dev = shd.mesh_devices(mesh)
    t0 = time.perf_counter()
    combo = build_combo(cfg, shape, mesh)
    arg_bytes = sum(shd.shard_bytes(a, s, mesh) for a, s in zip(combo.args, combo.specs))
    out = _outputs(combo, trace["outputs"])
    out_bytes = shd.shard_bytes(out, combo.out_specs(out), mesh)
    nulls: Dict[str, str] = {
        "compile_s": "the step is traced eagerly: there is no compile step",
        "bytes_accessed": "no counter of the bytes a step accesses in the port",
    }
    flops = trace.get("flops_global")
    if flops is None:
        nulls["flops"] = trace["why"]
    part = None
    if n_dev == 1:
        temp, why = trace.get("temp_bytes"), trace.get("why")
        coll: Optional[Dict[str, float]] = {k: 0.0 for k in _COLLECTIVES}
        coll["count"] = 0
        method = "MemTracker over the meta trace of the step"
    else:
        part = partitioned_trace(cfg, shape, mesh)
        temp, coll, why = part.get("temp_bytes"), part.get("collectives"), part.get("why")
        method = "MemTracker " + _PARTITIONED_METHOD
        if coll is None:
            nulls["collectives"] = why
    if temp is None:
        nulls.update(temp_bytes=why, peak_bytes=why)
    return {
        "status": "ok",
        "lower_s": round(lower_s + time.perf_counter() - t0, 3),
        "compile_s": None,
        "trace_s": trace.get("trace_s"),
        "partitioned_s": None if part is None else part.get("trace_s"),
        "devices": n_dev,
        "attn_impl": combo.attn_impl,
        "flops": None if flops is None else flops / n_dev,
        "flops_global": flops,
        "bytes_accessed": None,
        "memory": {
            "argument_bytes": int(arg_bytes),
            "output_bytes": int(out_bytes),
            "temp_bytes": temp,
            "peak_bytes": None if temp is None else int(arg_bytes + temp),
        },
        "collectives": coll,
        "method": {
            "argument_bytes": "exact: each argument's shard bytes from its spec and shape",
            "output_bytes": "exact: each output's shard bytes (logits and metrics "
                            "split by batch where it splits)",
            "flops": _FLOPS_METHOD + (_EXTENDED if trace.get("extended") else ""),
            "temp_bytes": method + ": the peak of the bytes the step allocates on a "
                                   "device (outputs included)",
            "peak_bytes": "argument_bytes + temp_bytes",
            "collectives": ("none on one device" if n_dev == 1 else
                            "CommDebugMode " + _PARTITIONED_METHOD + ": counts by kind, "
                            "bytes of each collective's local output"),
        },
        "nulls": nulls,
    }


def run_combo(arch: str, shape_name: str, mesh_name: str, *, mesh=None,
              cfg: Optional[ModelConfig] = None, shape: Optional[InputShape] = None,
              trace: Optional[Dict[str, Any]] = None,
              save: bool = True, verbose: bool = True) -> Dict[str, Any]:
    """The record of one combo.  ``cfg``/``shape`` default to the
    registry's and ``SHAPES``'; ``mesh`` to ``mesh_name``'s over the
    default process group (a fake one is made for the call if none
    exists); ``trace`` to a trace made here."""
    cfg = REGISTRY[arch] if cfg is None else cfg
    shape = SHAPES[shape_name] if shape is None else shape
    ok, why = shape_applicable(cfg, shape)
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    if mesh is None and not torch.distributed.is_initialized():
        with fake_process_group(MESH_WORLD[mesh_name]):
            return run_combo(arch, shape_name, mesh_name, cfg=cfg, shape=shape,
                             trace=trace, save=save, verbose=verbose)
    t0 = time.perf_counter()
    try:
        mesh = _mesh_by_name(mesh_name) if mesh is None else mesh
        lower_s = time.perf_counter() - t0
        if trace is None:
            trace = trace_step(cfg, shape, memory=shd.mesh_devices(mesh) == 1)
        rec.update(plan_record(cfg, shape, mesh, trace, lower_s))
    except Exception as e:  # noqa: BLE001 — a dry-run failure is a finding
        rec.update(status="failed", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    if verbose:
        _report(rec)
    if save:
        _save(rec)
    return rec


def _report(rec: Dict[str, Any]) -> None:
    if rec["status"] == "failed":
        print(f"[FAIL] {rec['arch']} {rec['shape']} {rec['mesh']}: {rec['error']}")
        return
    if rec["status"] != "ok":
        return
    flops = "null" if rec["flops"] is None else f"{rec['flops']:.3e}"
    peak = rec["memory"]["peak_bytes"]
    print(f"[OK] {rec['arch']:24s} {rec['shape']:12s} {rec['mesh']:6s} "
          f"trace {rec['trace_s']}s flops/dev {flops} "
          f"args/dev {rec['memory']['argument_bytes'] / 2**30:.2f} GiB "
          f"peak {'null' if peak is None else f'{peak / 2**30:.2f} GiB'}")


def _save(rec: Dict[str, Any], name: Optional[str] = None) -> None:
    os.makedirs(OUT_DIR, exist_ok=True)
    name = name or f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
    with open(os.path.join(OUT_DIR, name), "w") as f:
        json.dump(rec, f, indent=1)


def _worker_init() -> None:
    torch.set_num_threads(1)          # one core per tracing process


def _combo_job(arch: str, shape_name: str, mesh_names: tuple) -> list:
    """The records of (arch, shape) on each mesh from one trace, over a
    fake group of this process's own."""
    try:
        trace = trace_step(REGISTRY[arch], SHAPES[shape_name], memory=False, extend=True)
    except Exception as e:  # noqa: BLE001 — a dry-run failure is a finding
        return [{"arch": arch, "shape": shape_name, "mesh": m, "status": "failed",
                 "error": f"{type(e).__name__}: {e}",
                 "traceback": traceback.format_exc()[-2000:]} for m in mesh_names]
    with fake_process_group(max(MESH_WORLD[m] for m in mesh_names)):
        return [run_combo(arch, shape_name, m, trace=trace, save=False, verbose=False)
                for m in mesh_names]


def run_all(pairs, mesh_names) -> Dict[tuple, list]:
    """``_combo_job`` of each (arch, shape) pair, in one process per core
    (up to 8; inline for one pair)."""
    workers = min(8, os.cpu_count() or 1, len(pairs))
    if workers <= 1:
        return {p: _combo_job(*p, tuple(mesh_names)) for p in pairs}
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(workers, mp_context=ctx,
                                                initializer=_worker_init) as ex:
        futs = {p: ex.submit(_combo_job, *p, tuple(mesh_names)) for p in pairs}
        return {p: f.result() for p, f in futs.items()}


def run_pools(arch: str = "qwen3-8b") -> Dict[str, Any]:
    """Rollout-train decoupling at the RESOURCE level (paper Fig 3a): split
    512 devices into a trainer pool (8x16) and a rollout pool (16x16), plan
    train_step on one and serve_step on the other, and run a weight sync
    of the smoke-size params from the trainer pool's placements to the
    rollout pool's: a DTensor redistribution on the fake group (its
    collectives counted by ``CommDebugMode``), and, where a card is
    present, the copy of the same params on it."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor.debug import CommDebugMode

    cfg = REGISTRY[arch]
    t_start = time.perf_counter()
    rec: Dict[str, Any] = {"arch": arch, "mode": "pools"}
    with fake_process_group(512):
        train_mesh, infer_mesh = split_rollout_train_pools(
            train_chips=128, infer_chips=256, model_parallel=16)
        rec.update(train_mesh=str(tuple(train_mesh.shape)),
                   infer_mesh=str(tuple(infer_mesh.shape)))
        for key, shape_name, mesh in (("train", "train_4k", train_mesh),
                                      ("serve", "decode_32k", infer_mesh)):
            shape = SHAPES[shape_name]
            trace = trace_step(cfg, shape, memory=False, extend=True)
            plan = plan_record(cfg, shape, mesh, trace, 0.0)
            rec[f"{key}_flops_dev"] = plan["flops"]
            rec[f"{key}_argument_bytes_dev"] = plan["memory"]["argument_bytes"]
            rec[f"{key}_peak_bytes_dev"] = plan["memory"]["peak_bytes"]
            if "peak_bytes" in plan["nulls"]:
                rec[f"{key}_peak_bytes_null"] = plan["nulls"]["peak_bytes"]

        # weight sync of the smoke-size params, trainer placements -> rollout's
        small = cfg.smoke()
        params = get_api(small, device="cpu").init(0)
        leaves = _leaves(params)
        tspecs = _tensors_specs(params, shd.param_specs(params, train_mesh, small))
        ispecs = _tensors_specs(params, shd.param_specs(params, infer_mesh, small))
        on_train = [distribute_tensor(t, train_mesh, shd.param_placements(ts, train_mesh))
                    for t, ts in zip(leaves, tspecs)]
        comm = CommDebugMode()
        t0 = time.perf_counter()
        with comm:
            # gathered on the trainer pool, then placed on the rollout pool
            # (this process is rank 0, in the trainer pool only)
            synced = [distribute_tensor(t.full_tensor(), infer_mesh,
                                        shd.param_placements(isp, infer_mesh))
                      for t, isp in zip(on_train, ispecs)]
        rec["weight_sync_s_host"] = round(time.perf_counter() - t0, 4)
        if not all(isinstance(t, DTensor) and t.device_mesh is infer_mesh for t in synced):
            raise RuntimeError("pools: the weight sync left the rollout pool's mesh")
        rec["weight_sync_bytes"] = int(sum(t.numel() * t.element_size() for t in leaves))
        counts = comm.get_comm_counts()
        rec["weight_sync_collectives"] = {str(getattr(k, "__name__", k)): int(v)
                                          for k, v in counts.items()}
    if torch.cuda.is_available():
        dev = torch.device("cuda")
        src = [t.to(dev) for t in leaves]
        dst = [torch.empty_like(t) for t in src]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for d, s in zip(dst, src):
            d.copy_(s)
        torch.cuda.synchronize()
        rec["weight_sync_s_device"] = round(time.perf_counter() - t0, 6)
        rec["weight_sync_device"] = torch.cuda.get_device_name(0)
        if not all(torch.equal(d, s) for d, s in zip(dst, src)):
            raise RuntimeError("pools: the copy on the card differs from its source")
    rec["status"] = "ok"
    rec["wall_s"] = round(time.perf_counter() - t_start, 3)
    print(f"[OK] pools: train {rec['train_mesh']} + rollout {rec['infer_mesh']}; "
          f"weight sync {rec['weight_sync_bytes'] / 2**20:.1f} MiB across pools "
          f"in {rec['weight_sync_s_host']}s (host)")
    _save(rec, f"pools__{arch}.json")
    return rec


def _tensors_specs(tree, specs):
    out = []
    shd.tree_map_specs(lambda t, s: out.append(s), tree, specs)
    return out


def summarize(results) -> Dict[str, int]:
    return {
        "ok": sum(r["status"] == "ok" for r in results),
        "skipped": sum(r["status"] == "skipped" for r in results),
        "failed": sum(r["status"] == "failed" for r in results),
        "nulls": sum(len(r.get("nulls", {})) for r in results),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=sorted(REGISTRY) + [None])
    ap.add_argument("--shape", default=None, choices=sorted(SHAPES) + [None])
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--pools", action="store_true",
                    help="decoupled rollout/train pool demo (paper Fig 3a)")
    args = ap.parse_args(argv)

    if args.pools:
        run_pools(args.arch or "qwen3-8b")
        return

    archs = sorted(REGISTRY) if (args.all or args.arch is None) else [args.arch]
    shapes = sorted(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    t0 = time.perf_counter()
    pairs = [(a, s) for a in archs for s in shapes
             if shape_applicable(REGISTRY[a], SHAPES[s])[0]]
    done = run_all(pairs, meshes)
    results = []
    for arch in archs:
        for shape in shapes:
            # a combo not applicable is skipped without a trace
            recs = done.get((arch, shape)) or [run_combo(arch, shape, m, save=False,
                                                         verbose=False) for m in meshes]
            for rec in recs:
                _report(rec)
                _save(rec)
                results.append(rec)
    c = summarize(results)
    print(f"\n=== dry-run: {c['ok']} ok, {c['skipped']} skipped (documented), "
          f"{c['failed']} failed; {c['nulls']} numbers null (reasons in each record); "
          f"{time.perf_counter() - t0:.1f}s ===")
    if c["failed"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
