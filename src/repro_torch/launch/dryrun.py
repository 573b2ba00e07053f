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
  * ``bytes_accessed`` — over the same trace (``_byte_counter``), the bytes
    of every aten op's tensor inputs and outputs (views and metadata ops
    none; the kernels' abstract op its operands and results), divided by
    the devices: the port's unfused eager ops, an upper bound on the
    reference's (XLA's fused) count, not equal to it.
  * ``memory.temp_bytes`` / ``peak_bytes`` — the peak of the bytes the
    step allocates (its outputs included), and arguments + temp.  On a 1x1
    mesh ``MemTracker`` over the meta trace; on a larger one the step run
    on DTensors over the fake group (``partitioned_trace``: every argument
    a DTensor of its spec's local shard, the reference's activation spec
    installed), where ``_step_counter`` follows each device's local
    storages.
  * ``collectives`` — none on a 1x1 mesh (zeros); on a larger one the
    collective ops of the same partitioned run, bytes of each local output
    by kind and their count (``collectives_by_axis``: the bytes by mesh
    axis).

The partitioned step is the port's own plan: where DTensor's sharding
propagation refuses an op, or decides by torch version, the model, loss
and optimizer lines test ``sharding.ON_DTENSORS`` and place their DTensor
operands explicitly (``models/sharding.py``; each record's
``method.layout`` lists the layout and where it differs from the
reference's rules: the KV heads gathered over ``model`` where they do not
split 16 ways).  A 94-layer train step does not fit a run's budget
(``PARTITIONED_BUDGET_S``), so the numbers come from a few depths:
FLOPs, bytes and collectives are polynomials in the repeated units of
each stack (and a prefill's in its length), extended exactly from small
runs (``_extended``; a number that does not fit raises); temp bytes are
a peak, the largest of several phases' affine sizes, extended where the
peaks at three depths show one phase settled (``_settled_temp``; for a
train step only where a test shows the extension equal to the full run,
the MoE family's), else from a run at full depth.  Each record's
``method`` says which.

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
from fractions import Fraction
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.algos import LossConfig
from repro_torch.configs import REGISTRY, SHAPES, InputShape, input_specs, shape_applicable
from repro_torch.kernels import build
from repro_torch.launch.mesh import (fake_process_group, make_host_mesh,
                                     make_production_mesh, split_rollout_train_pools)
from repro_torch.models import attention, get_api, moe, module, sharding as shd
from repro_torch.models.config import ModelConfig
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.trainer import _CE_CHUNK, make_train_step

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
# the lengths an extended trace of that step runs at: three in one loss
# chunk (at two depths), two in two (at the least depth; ``_extended``),
# whose second chunks hold more than one position (the backward of a
# one-position chunk moves other bytes)
_SERIAL_LENGTHS = (16, 32, 48, 515, 516)
# the same for the partitioned runs, whose collectives are affine in the
# tokens, per loss chunk too, where the tokens split evenly over the model
# axis that splits the sequence-parallel stream (16 on the production
# meshes; an uneven split pads its collectives)
_SERIAL_PART_LENGTHS = (16, 32, 528, 544)

# Prefill lengths in whole query chunks of the plain attention (which are
# whole KV blocks and whole MoE dispatch groups): there every product of a
# prefill is a polynomial of degree <= 2 in the length.
_LENGTH_UNIT = attention._Q_CHUNK
if _LENGTH_UNIT % attention._KV_BLOCK or _LENGTH_UNIT % moe._GROUP:
    raise ImportError("dryrun: a query chunk must hold whole KV blocks and MoE groups")

_FLOPS_METHOD = ("torch.utils.flop_counter.FlopCounterMode over a meta-tensor trace "
                 "of the global step (matmul-class ops and the port's kernels' "
                 "products; elementwise ops not counted), divided by the devices")
_EXTENDED = ("; traced at the least depth and one unit deeper per stack (the "
             "enc-dec's train step also two units deeper: its bytes are of degree 2 "
             "in the decoder's layers; a prefill at 4,096, 6,144 and 8,192 tokens) "
             "and extended exactly to the full depth and length (degree 2 in whole "
             "2,048-token query chunks)")
_BYTES_METHOD = ("the bytes of every aten op's tensor inputs and outputs over the same "
                 "trace (views and metadata ops none, the kernels' abstract op its "
                 "operands and results), divided by the devices: the port's unfused "
                 "eager ops, so an upper bound on XLA's fused count, not equal to it")
_SERIAL_EXTENDED = ("; traced at 16, 32 and 48 tokens (one 512-token loss chunk) at the "
                    "least depth and one layer deeper, and at 515 and 516 tokens (two "
                    "loss chunks) at the least depth, and extended exactly to the full "
                    "depth (affine in the layers) and length (degree 2 in the tokens, "
                    "plus per loss chunk a term affine in the tokens)")
_SERIAL_PART_EXTENDED = ("run at 16 and 32 tokens (one loss chunk) at the least depth and "
                         "one layer deeper and at 528 and 544 tokens (two loss chunks) at "
                         "the least depth, and extended exactly to the full depth (affine "
                         "in the layers) and length (affine in the tokens, plus per loss "
                         "chunk a term affine in the tokens)")
_PARTITIONED_METHOD = ("over the step run on DTensors over the fake group (every "
                       "argument its spec's local shard; activations constrained to "
                       "the reference's spec)")
_LAYOUT = ("the rules' specs for every argument; per layer the weights gathered over "
           "the FSDP axes (pod, data) and their model sharding kept; the residual "
           "stream sequence-parallel over model where the reference's activation "
           "spec constrains it, gathered at each norm's output before the "
           "projections; the row-parallel outputs' partial sums reduced into the "
           "residual's placements; the embedding vocab-parallel (a local lookup and "
           "a partial sum); the loss on vocab-sharded logits (a local max, sum and "
           "pick, each reduced over model); each cache write on its local shard; "
           "the MoE experts on their devices (a local dispatch, the combine reduced "
           "over model); each kernel on its batch rows, heads kept split where "
           "every operand splits them and the decode cache split by sequence "
           "(outputs combined by one sum); AdamW on each shard, every gradient "
           "reduced to its master's placements and the norm one reduction")
# what DTensor raises where its sharding propagation refuses an op
_REFUSALS = (RuntimeError, NotImplementedError, IndexError)
# wall seconds one partitioned run may take (DTensor's propagation of an op
# it has not seen at those shapes enumerates the strategies of every mesh
# dim: seconds for the first runs of a process on the 2x16x16 mesh)
PARTITIONED_BUDGET_S = 60.0


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


def _depth_variants(cfg: ModelConfig, units: int = 1):
    """(the config at ``units`` repeated units per stack, [(a config one
    unit deeper in one stack, the units that stack has beyond ``units``)]):
    a unit is one layer (a pattern group for the hybrid, whose tail is kept;
    each of the enc-dec's encoder and decoder is a stack).  Every unit of a
    stack runs the same ops at the same shapes, so a step's FLOPs, bytes
    and collectives are affine in the units of each stack."""
    rep = dataclasses.replace
    if cfg.family == "audio":
        base = rep(cfg, num_encoder_layers=units, num_layers=units)
        return base, [(rep(base, num_encoder_layers=units + 1),
                       cfg.num_encoder_layers - units),
                      (rep(base, num_layers=units + 1), cfg.num_layers - units)]
    if cfg.family == "hybrid":
        unit = len(cfg.block_pattern)
        tail = cfg.num_layers % unit
        base = rep(cfg, num_layers=units * unit + tail)
        return base, [(rep(cfg, num_layers=(units + 1) * unit + tail),
                       cfg.num_layers // unit - units)]
    return rep(cfg, num_layers=units), [(rep(cfg, num_layers=units + 1),
                                         cfg.num_layers - units)]


def _layers(cfg: ModelConfig) -> int:
    return cfg.num_layers + (cfg.num_encoder_layers if cfg.family == "audio" else 0)


def _byte_counter():
    """A dispatch mode that sums, over every aten op it sees, the bytes of
    the op's tensor inputs and outputs (``.total``); views and metadata
    ops count nothing, the kernels' abstract op its operands and
    results."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class _Bytes(TorchDispatchMode):
        total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if _moves_bytes(func):
                self.total += sum(t.numel() * t.element_size()
                                  for t in tree_leaves((args, kwargs, out))
                                  if isinstance(t, torch.Tensor))
            return out

    return _Bytes()


# ops that allocate or relabel without reading or writing elements
_METADATA_OPS = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                           "new_empty_strided", "_unsafe_view", "lift_fresh",
                           "resize_", "set_"})


def _moves_bytes(func) -> bool:
    schema = func._schema
    if not any(str(r.type) in ("Tensor", "Tensor[]", "List[Tensor]", "Optional[Tensor]")
               for r in schema.returns):
        return False                       # metadata (sizes, strides, scalars)
    if any(r.alias_info is not None and not r.alias_info.is_write for r in schema.returns):
        return False                       # a view of an input
    return func.overloadpacket.__name__ not in _METADATA_OPS


def _made_once(cfg: ModelConfig) -> None:
    """Make what a process's first step makes and caches (RoPE's frequency
    table), so that no step's bytes or peak count it."""
    module._inv_freq(cfg.resolved_head_dim, cfg.rope_theta, torch.device("meta"))


def _trace_once(cfg: ModelConfig, shape: InputShape, memory: bool) -> Dict[str, Any]:
    """The step of (cfg, shape) on meta tensors, on one device: its FLOPs
    (``FlopCounterMode``), the bytes its ops access (``_byte_counter``), its
    outputs (``_describe``) and, with ``memory``, the peak of the bytes it
    allocates (``MemTracker``)."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    combo = build_combo(cfg, shape, {"data": 1, "model": 1})
    _made_once(cfg)
    tracker = None
    if memory:
        # the arguments are tracked as "other" memory, so that a write into
        # one of them (the cache) is not counted as a new allocation
        tracker = MemTracker()
        tracker.track_external(*[t for a in combo.args for t in _leaves(a)])
    with build.abstract_kernels(), torch.set_grad_enabled(combo.grad), \
            FlopCounterMode(display=False) as counter, _byte_counter() as nbytes:
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
    return {"flops": int(counter.get_total_flops()), "bytes": int(nbytes.total),
            "outputs": _describe(result), "temp": temp}


def _numbers(values: Dict[str, Any]) -> Dict[str, int]:
    return {k: v for k, v in values.items() if isinstance(v, int)}


def _lagrange(points, x) -> Fraction:
    """The value at ``x`` of the polynomial through ``points`` [(xi, yi)]."""
    total = Fraction(0)
    for i, (xi, yi) in enumerate(points):
        w = Fraction(yi)
        for j, (xj, _) in enumerate(points):
            if j != i:
                w *= Fraction(x - xj, xi - xj)
        total += w
    return total


def _exact(value: Fraction, what: str) -> int:
    if value.denominator != 1:
        raise ValueError(f"{what} is not the polynomial its extension assumes")
    return int(value)


def _at_depth(run: Callable, cfg: ModelConfig, shape: InputShape,
              units: int = 1, degree: int = 1) -> Dict[str, int]:
    """``run(config, shape)``'s numbers at the full depth of ``cfg``, from
    ``units`` units and one (``degree`` 2: and two) units deeper per stack
    (``_depth_variants``): a polynomial of that degree in the units of each
    stack, the stacks' terms added."""
    base, deeper = _depth_variants(cfg, units)
    v0 = run(base, shape)
    out = dict(v0)
    for c, more in deeper:
        points = [(0, v0), (1, run(c, shape))]
        if degree == 2:
            points.append((2, run(_unit_deeper(c, base), shape)))
        for k in out:
            out[k] += _exact(_lagrange([(x, v[k]) for x, v in points], more), k) - v0[k]
    return out


def _depth_degree(cfg: ModelConfig, shape: InputShape) -> int:
    """2 for the enc-dec's train step, whose decoder layers each take their
    cross K/V from one stack: the backward of that indexing writes the
    whole stack per layer, bytes quadratic in the layers; else 1."""
    return 2 if cfg.family == "audio" and shape.kind == "train" else 1


def _loss_chunks(tokens: int) -> int:
    """The chunks of the train step's fused unembed and loss over
    ``tokens``: its ``tokens - 1`` predicted positions in ``_CE_CHUNK``s."""
    return -(-(tokens - 1) // _CE_CHUNK)


def _extended(run: Callable, cfg: ModelConfig, shape: InputShape, *,
              length: bool = True) -> Dict[str, int]:
    """``run(config, shape)``'s numbers at the full depth and length from
    small runs, each extension exact (a number it does not fit raises): the
    depth by ``_at_depth``; with ``length``, a prefill longer than four
    ``_LENGTH_UNIT``s from runs at 2, 3 and 4 units (each number a
    polynomial of degree 2 in the units there, where every prefill attends
    by KV blocks); a step that differentiates the plain WKV scan from runs
    at the ``_SERIAL_LENGTHS`` (``length``; else ``_SERIAL_PART_LENGTHS``):
    a polynomial in the tokens through the lengths in one loss chunk (of
    degree 2 for the bytes: the backward of each token's slice writes the
    whole sequence; 1 for the collectives), plus per loss chunk past the
    first a polynomial through the lengths in two (degree 1: the backward of
    each chunk's slice writes the whole sequence)."""
    degree = _depth_degree(cfg, shape)
    if _serial_scan_steps(cfg, shape):
        lengths = _SERIAL_LENGTHS if length else _SERIAL_PART_LENGTHS
        ones = [t for t in lengths if _loss_chunks(t) == 1]
        twos = [t for t in lengths if _loss_chunks(t) == 2]
        if len(ones) + len(twos) != len(lengths) or not (ones and twos):
            raise ValueError(f"{lengths}: lengths in one loss chunk and in two")
        base = _depth_variants(cfg)[0]
        full = [_at_depth(run, cfg, dataclasses.replace(shape, seq_len=t), degree=degree)
                for t in ones]
        least = [run(base, dataclasses.replace(shape, seq_len=t)) for t in ones + twos]
        tokens, chunks = shape.seq_len, _loss_chunks(shape.seq_len)
        out = {}
        for k in full[0]:
            one = list(zip(ones, (v[k] for v in full)))
            one_least = list(zip(ones, (v[k] for v in least)))
            # what a second loss chunk adds, after the layers, so the same
            # at every depth
            per_chunk = [(t, v[k] - _lagrange(one_least, t))
                         for t, v in zip(twos, least[len(ones):])]
            out[k] = _exact(_lagrange(one, tokens)
                            + (chunks - 1) * _lagrange(per_chunk, tokens), k)
        return out
    t, rem = divmod(shape.seq_len, _LENGTH_UNIT)
    if not length or shape.kind != "prefill" or rem or t <= 4:
        return _at_depth(run, cfg, shape, degree=degree)
    by_chunks = [(k, _at_depth(run, cfg, dataclasses.replace(shape, seq_len=k * _LENGTH_UNIT),
                               degree=degree)) for k in (2, 3, 4)]
    return {key: _exact(_lagrange([(k, v[key]) for k, v in by_chunks], t), key)
            for key in by_chunks[0][1]}


def _runs_of(cfg: ModelConfig, shape: InputShape, *, length: bool = True) -> list:
    """The (config, shape) pairs ``_extended`` runs, in order (its control
    flow does not depend on the numbers)."""
    wanted = []
    _extended(lambda c, sh: wanted.append((c, sh)) or {}, cfg, shape, length=length)
    return list(dict.fromkeys(wanted))


def trace_step(cfg: ModelConfig, shape: InputShape, *, memory: bool,
               extend: bool = False, runs: Optional[Dict[tuple, Any]] = None
               ) -> Dict[str, Any]:
    """Trace the step of (cfg, shape) on meta tensors: its global FLOPs
    (``FlopCounterMode``) and bytes accessed (``_byte_counter``) and, with
    ``memory``, the peak bytes it allocates (``MemTracker``).  ``extend``:
    FLOPs and bytes from small traces extended to the full depth and
    length, exactly (``_extended``; no ``memory`` then).  A full trace of a
    step that differentiates the plain WKV scan over more token x layer
    steps than ``_MAX_SERIAL_SCAN_STEPS`` is not made.  ``runs``: {(config,
    shape): (``_trace_once``'s result, seconds)} of an extension's runs made
    elsewhere (``run_all``'s jobs); the others are made here.  The plan's
    mesh does not change the trace."""
    if extend and memory:
        raise ValueError("extended traces give FLOPs and bytes only")
    described, made = [], dict(runs or {})

    def run(c, sh):
        if (c, sh) not in made:
            t0 = time.perf_counter()
            out = _trace_once(c, sh, False)
            made[(c, sh)] = out, time.perf_counter() - t0
        out = made[(c, sh)][0]
        described.append(out["outputs"])
        return _numbers(out)

    steps = _serial_scan_steps(cfg, shape)
    t0 = time.perf_counter()
    if extend:
        numbers = _extended(run, cfg, shape)
        # the outputs at full depth and length: the metrics are 0-dim and
        # the logits' shapes do not depend on either
        outputs, temp = described[0], None
    elif steps > _MAX_SERIAL_SCAN_STEPS:
        # the outputs' shapes from the same step at one layer and 16 tokens
        small = build_combo(dataclasses.replace(cfg, num_layers=1),
                            dataclasses.replace(shape, seq_len=16), {"data": 1})
        with build.abstract_kernels():
            outputs = _describe(small.fn(*small.args))
        return {"flops_global": None, "bytes_global": None, "temp_bytes": None,
                "trace_s": None, "outputs": outputs,
                "why": (f"not traced: the train step differentiates the plain WKV "
                        f"scan, one Python step per token and layer, each traced op "
                        f"by op ({steps} steps, more than {_MAX_SERIAL_SCAN_STEPS}); "
                        f"the dry-run extends it from short lengths")}
    else:
        out = _trace_once(cfg, shape, memory)
        numbers, outputs, temp = _numbers(out), out["outputs"], out["temp"]
    took = (sum(v[1] for k, v in made.items() if k in _runs_of(cfg, shape)) if extend
            else time.perf_counter() - t0)
    return {"flops_global": numbers["flops"], "bytes_global": numbers["bytes"],
            "outputs": outputs, "temp_bytes": temp, "extended": extend,
            "serial": bool(steps), "trace_s": round(took, 3)}


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


def _step_counter(mesh, external):
    """A dispatch mode over one partitioned step: the bytes of each
    collective's local output (what the reference reads off its HLO) by
    kind (``bytes``, ``count``) and by the mesh axis whose group runs it
    (``by_axis``), and the peak of the bytes the step's ops allocate on the
    device (``peak``: each new storage from its op to its release;
    ``external`` tensors' storages, the arguments', not counted).  One mode
    where ``CommDebugMode`` and ``MemTracker`` are two: every op of a
    partitioned step passes through it, the local ones too."""
    import weakref

    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    # by the group's ranks: DTensor's sharding cache may hand back a plan
    # made on an equal mesh, whose groups have other names
    ranks = {tuple(dist.get_process_group_ranks(mesh.get_group(i))): name
             for i, name in enumerate(mesh.mesh_dim_names)}
    axes: Dict[str, Optional[str]] = {}

    def axis(group_name: str) -> Optional[str]:
        if group_name not in axes:
            try:
                pg = _resolve_process_group(group_name)
                axes[group_name] = ranks.get(tuple(dist.get_process_group_ranks(pg)))
            except (KeyError, ValueError, RuntimeError):
                axes[group_name] = None
        return axes[group_name]

    def storages(t):
        local = getattr(t, "_local_tensor", None)      # a DTensor's shard
        if local is not None:
            return storages(local)
        return [t.untyped_storage()] if t.device.type == "meta" else []

    seen = {s._cdata for t in external for s in storages(t)}

    class _Counter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.bytes = {k: 0 for k in _COLLECTIVES}
            self.by_axis = {name: 0 for name in ranks.values()}
            self.count = self.live = self.peak = 0

        def _freed(self, key, n):
            self.live -= n
            seen.discard(key)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
            if func.namespace == "_c10d_functional":
                kind = _collective_kind(func)
                if kind in self.bytes:
                    n = sum(t.numel() * t.element_size() for t in outs)
                    self.bytes[kind] += n
                    self.count += 1
                    for a in list(args) + list((kwargs or {}).values()):
                        if isinstance(a, str) and axis(a) is not None:
                            self.by_axis[axis(a)] += n
            for t in outs:
                for st in storages(t):
                    if st._cdata in seen:
                        continue
                    seen.add(st._cdata)
                    n = st.nbytes()
                    self.live += n
                    self.peak = max(self.peak, self.live)
                    weakref.finalize(st, self._freed, st._cdata, n)
            return out

    return _Counter()


def _collective_kind(op) -> str:
    name = str(getattr(op, "__name__", op))
    for kind in _COLLECTIVES:
        if kind.replace("-", "_") in name:
            return kind
    return name


def _partitioned_once(cfg: ModelConfig, shape: InputShape, mesh) -> Dict[str, int]:
    """One run of the step on DTensors over ``mesh``: {"temp": each
    device's peak of the bytes it allocates, "<kind>": the bytes of the
    collectives of that kind, "count": their number}.  Raises what DTensor
    raises, or ``_OverBudget`` past ``PARTITIONED_BUDGET_S`` of wall time."""
    from torch.distributed.tensor.experimental import implicit_replication

    combo = build_combo(cfg, shape, mesh)
    args = tuple(a if s is None else _distributed(a, s, mesh)
                 for a, s in zip(combo.args, combo.specs))
    bspec = shd.batch_axes(mesh) if shd.shardable_batch(mesh, shape.global_batch) else None
    _made_once(cfg)
    counter = _step_counter(mesh, [t for a in args for t in _leaves(a)])
    # DTensor warns at every redistribution over two mesh dims at once
    log = logging.getLogger("torch.distributed.tensor._redistribute")
    level = log.level
    log.setLevel(logging.ERROR)
    handler = signal.signal(signal.SIGALRM, _over_budget)
    signal.setitimer(signal.ITIMER_REAL, PARTITIONED_BUDGET_S)
    try:
        # the reference's sequence-parallel residual stream
        with shd.partitioned((bspec, "model", None)), build.abstract_kernels(), \
                implicit_replication(), warnings.catch_warnings(), \
                torch.set_grad_enabled(combo.grad), counter:
            # implicit_replication's notice at each one-element tensor
            warnings.filterwarnings("ignore", "Found a non-scalar tensor")
            combo.fn(*args)
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, handler)
        log.setLevel(level)
    return dict(counter.bytes, temp=counter.peak, count=counter.count,
                **{"axis:" + k: v for k, v in counter.by_axis.items()})


class _Refused(Exception):
    """A partitioned run's refusal, as ``_refusal`` wrote it."""


def _partitioned_run(cfg: ModelConfig, shape: InputShape, mesh) -> tuple:
    """(``_partitioned_once``'s numbers, or {"why": its refusal}; seconds)."""
    t0 = time.perf_counter()
    try:
        out = _partitioned_once(cfg, shape, mesh)
    except _REFUSALS + (_OverBudget,) as e:
        out = {"why": _refusal(e)}
    return out, time.perf_counter() - t0


def _unit_deeper(c: ModelConfig, base: ModelConfig) -> ModelConfig:
    """``c``, one of ``_depth_variants``' deeper configs, one more unit
    deeper in the stack it deepens."""
    rep = dataclasses.replace
    if c.family == "audio" and c.num_encoder_layers > base.num_encoder_layers:
        return rep(c, num_encoder_layers=c.num_encoder_layers + 1)
    return rep(c, num_layers=c.num_layers + (len(c.block_pattern)
                                             if c.family == "hybrid" else 1))


def _settled_temp(run: Callable, cfg: ModelConfig, shape: InputShape,
                  units: int) -> Optional[tuple]:
    """(the step's temp bytes at full depth, how they were had) from runs at
    ``units``, one and two units deeper per stack, or None where those do
    not settle it.  A peak is the largest of several phases' sizes, each
    affine in the depth.  An inference step's layers free what they make:
    from the depth where one more unit leaves its peak as it is, no unit
    moves it.  A train step keeps each layer's input for its backward: past
    the depths where the phases that do not hold them all peak (the head's,
    the optimizer's), its peak grows by the same bytes a unit, and three
    collinear peaks extend exactly."""
    base, deeper = _depth_variants(cfg, units)
    t0 = run(base, shape)["temp"]
    settled, extended = t0, t0
    for c, more in deeper:
        t1 = run(c, shape)["temp"]
        extended += more * (t1 - t0)
        if t1 == t0 and shape.kind != "train":
            continue
        t2 = run(_unit_deeper(c, base), shape)["temp"]
        if shape.kind != "train" and t2 == t1:
            settled = max(settled, t1)
        elif shape.kind != "train" or t2 - t1 != t1 - t0:
            return None
    if shape.kind == "train":
        return extended, _COLLINEAR.format(units=units)
    return settled, _STEADY


# a train step's partitioned runs start at this many units per stack: the
# head's and the optimizer's phases can peak over a few layers' inputs
_TRAIN_UNITS = 3
# the families whose train step's temp bytes are extended (where its guard
# holds): a test shows the extension equal to the full run for them
# (tests/test_torch_dryrun.py); the others' train steps run at full depth,
# where a phase of a steeper slope (the optimizer's, over every layer's
# gradients) can overtake the one the guard saw
_TRAIN_TEMP_EXTENDED = ("moe",)
_FULL_DEPTH = "run at full depth"
_COLLINEAR = ("extended exactly from {units} units and one unit deeper per stack (the "
              "peaks at two units deeper are collinear with them)")
_STEADY = ("the peak from the depth where one more unit of each stack leaves it "
           "unchanged (an inference step's layers free what they make)")


def partitioned_trace(cfg: ModelConfig, shape: InputShape, mesh,
                      runs: Optional[Dict[tuple, Any]] = None) -> Dict[str, Any]:
    """The step of (cfg, shape) run on DTensors over ``mesh`` (a mesh of the
    fake group): each device's temp bytes and the
    collectives it issues (bytes by kind and by mesh axis, and their count;
    ``_step_counter``), or ``why`` not.  The collectives are extended exactly to the
    full depth from runs at the least depth and one unit deeper per stack
    (``_extended``, at the full length; a step that differentiates the
    plain WKV scan from its short lengths, where its temp bytes are null);
    the temp bytes too where ``_settled_temp`` shows the extension holds,
    else they come from a run at full depth.  Each run gets
    ``PARTITIONED_BUDGET_S`` of wall time (a ``SIGALRM``: call it on the
    main thread).  ``runs``: {(config, shape): ``_partitioned_run``'s result}
    made elsewhere (``run_all``'s jobs); the others are made here."""
    made, used = dict(runs or {}), []

    def run(c, sh):
        if (c, sh) not in made:
            made[(c, sh)] = _partitioned_run(c, sh, mesh)
        if (c, sh) not in used:
            used.append((c, sh))
        out = made[(c, sh)][0]
        if "why" in out:
            raise _Refused(out["why"])
        return out

    def seconds():
        return round(sum(made[k][1] for k in used), 3)

    units = _TRAIN_UNITS if shape.kind == "train" else 1
    base, deeper = _depth_variants(cfg, units)
    guarded = _layers(base) + sum(_layers(c) + _layers(_unit_deeper(c, base))
                                  for c, _ in deeper)
    try:
        if _serial_scan_steps(cfg, shape):
            numbers = _extended(run, cfg, shape, length=False)
        elif (guarded < _layers(cfg) and min(n for _, n in deeper) >= 2
              and (shape.kind != "train" or cfg.family in _TRAIN_TEMP_EXTENDED)):
            numbers = _at_depth(run, cfg, shape, units)
        else:                             # no cheaper than the full depth
            numbers = dict(run(cfg, shape), how=_FULL_DEPTH)
    except _Refused as e:
        return {"why": str(e), "trace_s": seconds()}
    out = {"collectives": {k: numbers[k] for k in _COLLECTIVES + ("count",)},
           "by_axis": {k[5:]: v for k, v in numbers.items() if k.startswith("axis:")},
           "collectives_how": numbers.get("how") or (
               _SERIAL_PART_EXTENDED if _serial_scan_steps(cfg, shape) else
               f"extended exactly from {units} unit{'s' * (units > 1)} and one unit "
               f"deeper per stack (affine in the units)")}
    if _serial_scan_steps(cfg, shape):
        out.update(temp_bytes=None, why_temp=(
            "not extended: the train step differentiates the plain WKV scan, whose "
            "autograd keeps a (B, H, D, D) state per token and layer; its peak at "
            f"{shape.seq_len} tokens is neither traced (one Python step per token "
            "and layer) nor shown to be affine in the tokens"))
    elif "how" in numbers:
        out.update(temp_bytes=numbers["temp"], temp_how=numbers["how"])
    else:
        try:
            settled = _settled_temp(run, cfg, shape, units)
            if settled is None:
                settled = run(cfg, shape)["temp"], _FULL_DEPTH + (
                    " (the peaks at three depths neither collinear nor steady)")
            out["temp_bytes"], out["temp_how"] = settled
        except _Refused as e:
            out.update(temp_bytes=None, why_temp=str(e))
    out["trace_s"] = seconds()
    return out


def _mesh_by_name(mesh_name: str):
    if mesh_name == "host":
        return make_host_mesh()
    return make_production_mesh(multi_pod=(mesh_name == "multi"))


def plan_record(cfg: ModelConfig, shape: InputShape, mesh, trace: Dict[str, Any],
                lower_s: float, part: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The record of (cfg, shape) on ``mesh`` from its plan, its trace and,
    beyond a 1x1 mesh, its partitioned run (``part``, made here if not
    given: ``partitioned_trace``)."""
    n_dev = shd.mesh_devices(mesh)
    t0 = time.perf_counter()
    combo = build_combo(cfg, shape, mesh)
    arg_bytes = sum(shd.shard_bytes(a, s, mesh) for a, s in zip(combo.args, combo.specs))
    out = _outputs(combo, trace["outputs"])
    out_bytes = shd.shard_bytes(out, combo.out_specs(out), mesh)
    nulls: Dict[str, str] = {
        "compile_s": "the step is traced eagerly: there is no compile step",
    }
    flops, nbytes = trace.get("flops_global"), trace.get("bytes_global")
    if flops is None:
        nulls["flops"] = trace["why"]
    if nbytes is None:
        nulls["bytes_accessed"] = trace["why"]
    if n_dev == 1:
        part = None
        temp = trace.get("temp_bytes")
        why = trace.get("why") or ("an extended trace counts FLOPs and bytes only: one "
                                   "device's temp bytes need a full trace with memory")
        coll: Optional[Dict[str, float]] = {k: 0.0 for k in _COLLECTIVES}
        coll["count"] = 0
        method = "MemTracker over the meta trace of the step"
    else:
        part = partitioned_trace(cfg, shape, mesh) if part is None else part
        temp, coll = part.get("temp_bytes"), part.get("collectives")
        why = part.get("why_temp", part.get("why"))
        method = ("the peak of the storages the step's ops make, " + _PARTITIONED_METHOD
                  + "; " + part.get("temp_how", "null"))
        if coll is None:
            nulls["collectives"] = part["why"]
    if temp is None:
        nulls.update(temp_bytes=why, peak_bytes=why)
    coll_method = ("none on one device" if n_dev == 1 else
                   "each collective op " + _PARTITIONED_METHOD + "; "
                   + part.get("collectives_how", "null")
                   + ": counts by kind, bytes of each collective's local output")
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
        "bytes_accessed": None if nbytes is None else nbytes / n_dev,
        "bytes_accessed_global": nbytes,
        "memory": {
            "argument_bytes": int(arg_bytes),
            "output_bytes": int(out_bytes),
            "temp_bytes": temp,
            "peak_bytes": None if temp is None else int(arg_bytes + temp),
        },
        "collectives": coll,
        "collectives_by_axis": None if part is None else part.get("by_axis"),
        "method": {
            "argument_bytes": "exact: each argument's shard bytes from its spec and shape",
            "output_bytes": "exact: each output's shard bytes (logits and metrics "
                            "split by batch where it splits)",
            "flops": _FLOPS_METHOD + _trace_extent(trace),
            "bytes_accessed": _BYTES_METHOD + _trace_extent(trace),
            "temp_bytes": method + ": the peak of the bytes the step allocates on a "
                                   "device (outputs included)",
            "peak_bytes": "argument_bytes + temp_bytes",
            "collectives": coll_method,
            "collectives_by_axis": "the same bytes by the mesh axis whose group runs each",
            "layout": ("one device" if n_dev == 1 else _LAYOUT + _layout_notes(cfg, mesh)),
        },
        "nulls": nulls,
    }


def _trace_extent(trace: Dict[str, Any]) -> str:
    if not trace.get("extended"):
        return ""
    return _SERIAL_EXTENDED if trace.get("serial") else _EXTENDED


def _layout_notes(cfg: ModelConfig, mesh) -> str:
    """Where this config's partitioned step places a tensor other than the
    reference's rules would: the head splits the model axis cannot take."""
    model = shd.mesh_axis_sizes(mesh).get("model", 1)
    notes = []
    if cfg.family == "ssm":
        if cfg.num_rwkv_heads % model:
            notes.append(f"the {cfg.num_rwkv_heads} RWKV heads do not split {model} "
                         f"ways: r, k, v and w are gathered over model before the "
                         f"head split")
    elif cfg.num_kv_heads % model:
        notes.append(f"the {cfg.num_kv_heads} KV heads do not split {model} ways: "
                     f"q, k and v are gathered over model before the GQA head split, "
                     f"and attention runs on each device's batch rows, every head")
    else:
        notes.append(f"the {cfg.num_kv_heads} KV heads split {model} ways: attention "
                     f"runs on each device's heads")
    if cfg.family == "hybrid":
        notes.append("the RG-LRU branch's products run replicated over model, its "
                     "recurrence split over model by width")
    return "; " + "; ".join(notes)


def run_combo(arch: str, shape_name: str, mesh_name: str, *, mesh=None,
              cfg: Optional[ModelConfig] = None, shape: Optional[InputShape] = None,
              trace: Optional[Dict[str, Any]] = None,
              part: Optional[Dict[str, Any]] = None,
              save: bool = True, verbose: bool = True) -> Dict[str, Any]:
    """The record of one combo.  ``cfg``/``shape`` default to the
    registry's and ``SHAPES``'; ``mesh`` to ``mesh_name``'s over the
    default process group (a fake one is made for the call if none
    exists); ``trace`` and, beyond a 1x1 mesh, ``part`` (the partitioned
    run) to ones made here."""
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
                             trace=trace, part=part, save=save, verbose=verbose)
    t0 = time.perf_counter()
    try:
        mesh = _mesh_by_name(mesh_name) if mesh is None else mesh
        lower_s = time.perf_counter() - t0
        if trace is None:
            trace = trace_step(cfg, shape, memory=shd.mesh_devices(mesh) == 1)
        rec.update(plan_record(cfg, shape, mesh, trace, lower_s, part))
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


def _failure(e: BaseException) -> Dict[str, Any]:
    return {"status": "failed", "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-2000:]}


def _trace_job(runs: tuple) -> Dict[tuple, Any]:
    """The runs (config, shape) of an extended trace: {run: (``_trace_once``'s
    result, seconds), or its failure}."""
    out = {}
    for c, sh in runs:
        t0 = time.perf_counter()
        try:
            out[(c, sh)] = _trace_once(c, sh, False), time.perf_counter() - t0
        except Exception as e:  # noqa: BLE001 — a dry-run failure is a finding
            out[(c, sh)] = _failure(e)
    return out


def _partitioned_job(runs: tuple, mesh_name: str) -> Dict[tuple, Any]:
    """Partitioned runs (``_partitioned_run``) on ``mesh_name``'s mesh over a
    fake group of this process's own: {run: its result, or its failure}."""
    out = {}
    with fake_process_group(MESH_WORLD[mesh_name]):
        mesh = _mesh_by_name(mesh_name)
        for c, sh in runs:
            try:
                out[(c, sh)] = _partitioned_run(c, sh, mesh)
            except Exception as e:  # noqa: BLE001 — a dry-run failure is a finding
                out[(c, sh)] = _failure(e)
    return out


def _combo_job(arch: str, shape_name: str, mesh_name: str) -> Dict[str, Any]:
    """``partitioned_trace`` of (arch, shape) on ``mesh_name``'s mesh over a
    fake group of this process's own, or its failure."""
    with fake_process_group(MESH_WORLD[mesh_name]):
        try:
            return partitioned_trace(REGISTRY[arch], SHAPES[shape_name],
                                     _mesh_by_name(mesh_name))
        except Exception as e:  # noqa: BLE001 — a dry-run failure is a finding
            return _failure(e)


def _by_length(runs: list) -> list:
    """``runs`` in groups of one shape each (a length; its depths together,
    which share DTensor's sharding propagation cache)."""
    groups: Dict[InputShape, list] = {}
    for c, sh in runs:
        groups.setdefault(sh, []).append((c, sh))
    return [tuple(g) for g in groups.values()]


def _job_weight(job: tuple) -> float:
    """A guess at a job's wall time, to start the longest first: its layers
    times its tokens' share of the step (the plain WKV scan per token), on
    DTensors more, the 2x16x16 mesh's most."""
    if job[0] == "combo":
        cfg, shape = REGISTRY[job[1]], SHAPES[job[2]]
        job = ("part", [(c, sh) for c, sh in _runs_of(cfg, shape, length=False)]
               + [(cfg, shape)] * (shape.kind == "train"), job[3])
    weight = 0.0
    for cfg, shape in job[1]:
        layers = cfg.num_layers + (cfg.num_encoder_layers if cfg.family == "audio" else 0)
        w = layers * {"train": 3.0, "prefill": 4.0, "decode": 0.3}[shape.kind]
        if _serial_scan_steps(cfg, shape):
            w = shape.seq_len * cfg.num_layers / 20
        if shape.kind == "prefill":
            w *= shape.seq_len / SHAPES["prefill_32k"].seq_len
        weight += w
    if job[0] == "part":
        weight *= 3.0 if job[2] == "multi" else 2.0
    return weight


def run_all(pairs, mesh_names) -> Dict[tuple, list]:
    """The records of each (arch, shape) pair on each mesh, from the runs of
    its extended trace (``_trace_job``) and, per mesh beyond 1x1, of its
    partitioned extension (``_partitioned_job``): one job per length, in
    one process per core (up to 8; inline for one job), the longest first.
    The records are made here, over a fake group of this process's."""
    parts = [m for m in mesh_names if MESH_WORLD[m] > 1]
    jobs = []
    for a, s in pairs:
        cfg, shape = REGISTRY[a], SHAPES[s]
        jobs += [("trace", g) for g in _by_length(_runs_of(cfg, shape))]
        if _serial_scan_steps(cfg, shape):
            jobs += [("part", g, m) for m in parts
                     for g in _by_length(_runs_of(cfg, shape, length=False))]
        else:
            jobs += [("combo", a, s, m) for m in parts]
    jobs.sort(key=_job_weight, reverse=True)
    run = {"trace": _trace_job, "part": _partitioned_job, "combo": _combo_job}

    def take(job, result):
        if job[0] == "combo":
            done[job[1:]] = result
        else:
            done.update({k + job[2:]: v for k, v in result.items()})

    workers = min(8, os.cpu_count() or 1, len(jobs))
    done: Dict[tuple, Any] = {}
    if workers <= 1:
        for j in jobs:
            take(j, run[j[0]](*j[1:]))
    else:
        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(workers, mp_context=ctx,
                                                    initializer=_worker_init) as ex:
            futs = [(j, ex.submit(run[j[0]], *j[1:])) for j in jobs]
            for j, f in futs:
                take(j, f.result())
    out = {}
    with fake_process_group(max(MESH_WORLD[m] for m in mesh_names)):
        for a, s in pairs:
            cfg, shape = REGISTRY[a], SHAPES[s]
            traced = {k: done[k] for k in _runs_of(cfg, shape)}
            failed = [r for r in traced.values() if isinstance(r, dict)]
            trace = None if failed else trace_step(cfg, shape, memory=False, extend=True,
                                                   runs=traced)
            recs = []
            for m in mesh_names:
                part, runs = done.get((a, s, m)), {}
                if m in parts and part is None:
                    runs = {k: done[k + (m,)] for k in _runs_of(cfg, shape, length=False)}
                bad = failed + [r for r in list(runs.values()) + [part]
                                if isinstance(r, dict) and r.get("status") == "failed"]
                if bad:
                    recs.append(dict(bad[0], arch=a, shape=s, mesh=m))
                    continue
                if runs:
                    part = partitioned_trace(cfg, shape, _mesh_by_name(m), runs)
                recs.append(run_combo(a, s, m, trace=trace, part=part, save=False,
                                      verbose=False))
            out[(a, s)] = recs
    return out


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
            part = partitioned_trace(cfg, shape, _holding_this_rank(mesh))
            plan = plan_record(cfg, shape, mesh, trace, 0.0, part)
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


def _holding_this_rank(mesh):
    """``mesh``, or one of its shape and axis names over the first ranks
    where this process's rank is not in it: each device's numbers depend on
    the shape only, and a rank runs only its own shards."""
    from torch.distributed.device_mesh import DeviceMesh

    if mesh.get_coordinate() is not None:
        return mesh
    return DeviceMesh(mesh.device_type, torch.arange(mesh.size()).reshape(tuple(mesh.shape)),
                      mesh_dim_names=mesh.mesh_dim_names)


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
