"""Path-based parameter sharding rules: the port of the JAX package's
``models/sharding.py``.

Parameters are nested dicts; rules regex-match the '/'-joined tree path and
yield a spec *template* for the trailing dims.  Layer stacking prepends axes
(blocks are stacked over layers/groups), so templates are right-aligned: a
rank-3 array matched by a rank-2 template gets ``None`` prepended.  Any dim
not divisible by its mesh axis falls back to replication (GQA kv
projections with few heads, tiny LoRA factors, ...).

A spec is a plain tuple with one entry per tensor dim, exactly the entries
of the reference's ``PartitionSpec``: ``None`` (replicated), a mesh axis
name, or a tuple of names (the dim sharded over all of them, the first
major); ``()`` replicates every dim.  ``param_placements`` turns one into
DTensor placements over a ``DeviceMesh``.

The port keeps one dict per layer where the reference stacks the layers
(``convert.to_jax_layout`` maps one layout onto the other).  A rule matches
the reference's path of each leaf — taken from that mapping, so there is no
second table of names — and a per-layer leaf gets the reference's spec of
its stacked leaf without the leading stacking axis, which no rule shards
(templates are right-aligned; ``param_specs`` checks it).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` (``launch/mesh.py``)
or, where only the axis sizes matter, a mapping ``{axis name: size}`` in
mesh order.
"""
from __future__ import annotations

import math
import re
from collections.abc import Mapping
from typing import Any

import torch

# (regex on path, right-aligned spec template). First match wins.
# Two-axis sharding: the tensor-parallel dim shards over `model`, the other
# big dim shards over `data` (FSDP/ZeRO-style — essential for the 235B MoE
# optimizer state to fit per-chip HBM).  Divisibility fallback per-dim.
PARAM_RULES: list[tuple[str, tuple]] = [
    # --- MoE (expert-parallel over `model`, FSDP over d_model/d_ff) ---
    (r"moe/router$", ("data", None)),
    (r"moe/w_(gate|up|down)$", ("model", "data", None)),
    # --- channel-mix down-proj before generic wv rule ---
    (r"channel_mix/wv$", ("model", "data")),
    (r"channel_mix/w[kr]$", ("data", "model")),
    # --- attention / generic projections ---
    (r"(attn|cross)/w[qkv]$", ("data", "model")),
    (r"(attn|cross)/wo$", ("model", "data")),
    # --- MLP ---
    (r"wi_(gate|up)$", ("data", "model")),
    (r"mlp/wo$", ("model", "data")),
    # --- RWKV time-mix ---
    (r"time_mix/w[rkvg]$", ("data", "model")),
    (r"time_mix/wo$", ("model", "data")),
    (r"time_mix/(mix_[ab]|decay_[ab]|u|ln_scale|ln_bias)$", ()),  # replicate
    # --- RG-LRU ---
    # RG-LRU branch: weights are tiny (W^2) next to its fp32 activations, so
    # the reference shards them FSDP-only (tensor-parallel W sharding made
    # its partitioner move the (B, S, W) fp32 activations between every
    # producer and consumer).
    (r"rec/w[xy]$", ("data", None)),
    (r"rec/wo$", (None, "data")),
    (r"rec/w[ai]$", ("data", None)),
    (r"rec/conv_w$", (None, "model")),
    # --- embeddings / head ---
    (r"embed$", ("model", "data")),
    (r"lm_head$", ("data", "model")),
]


def _path_str(path) -> str:
    return "/".join(str(k) for k in path)


def _spec_for(path: str, shape: tuple, mesh_axes: dict[str, int]) -> tuple:
    for pat, template in PARAM_RULES:
        if re.search(pat, path):
            if not template:
                return ()
            spec = [None] * (len(shape) - len(template)) + list(template)
            for i, ax in enumerate(spec):
                if ax is None:
                    continue
                # the FSDP dim shards over (data, pod): ZeRO across pods —
                # without it the multi-pod mesh replicates the fp32 optimizer
                # per pod and 235B-scale training cannot fit
                if ax == "data" and "pod" in mesh_axes:
                    ax = ("data", "pod")
                axes = ax if isinstance(ax, tuple) else (ax,)
                size = 1
                for a in axes:
                    size *= mesh_axes.get(a, 1)
                if shape[i] % size != 0:
                    # retry without the pod axis before full fallback
                    size = mesh_axes.get(axes[0], 1)
                    ax = axes[0]
                    if shape[i] % size != 0:
                        spec[i] = None
                        continue
                spec[i] = ax
            return tuple(spec)
    return ()  # replicate by default (norm scales, biases, small factors)


def mesh_axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` in mesh order, of a ``DeviceMesh`` or a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_devices(mesh) -> int:
    return math.prod(mesh_axis_sizes(mesh).values())


class _Stacked(list):
    """One leaf of the reference's layout stacked over layers: the port's
    per-layer tensors, in layer order."""


def _is_param_tree(tree) -> bool:
    return isinstance(tree, dict) and ("blocks" in tree or "encoder" in tree)


def _specs_of_param_tree(params, sizes, cfg, prefix):
    """{id(tensor): spec} over one model's params, each leaf's spec that of
    its path in the reference's layout (a stacked leaf's without the
    leading axis)."""
    from repro_torch import convert     # convert imports the model modules

    layout = convert.to_jax_layout(params, cfg, leaf=lambda t: t, stack=_Stacked)
    out: dict[int, tuple] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        elif isinstance(node, _Stacked):
            shape = tuple(node[0].shape)
            if any(tuple(t.shape) != shape for t in node):
                raise ValueError(f"{_path_str(path)}: layers differ in shape")
            spec = _spec_for(_path_str(path), (len(node),) + shape, sizes)
            if spec and spec[0] is not None:
                raise ValueError(f"{_path_str(path)}: a rule shards the stacking axis")
            for t in node:
                out[id(t)] = spec[1:] if spec else ()
        elif isinstance(node, list):          # the hybrid's unstacked tail
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        else:
            out[id(node)] = _spec_for(_path_str(path), tuple(node.shape), sizes)

    walk(layout, prefix)
    return out


def param_specs(params: Any, mesh, cfg=None):
    """Tree of specs matching ``params`` — a model's params, or a tree that
    holds param-shaped trees, such as a train state ``{"params", "opt":
    {"step", "master", "m", "v"}}`` (tensors or meta tensors).  Non-tensor
    leaves (the optimizer's host ``step``) map to None.  A hybrid's params
    need its ``cfg`` (the reference's grouping of its layers)."""
    sizes = mesh_axis_sizes(mesh)

    def walk(node, path):
        if _is_param_tree(node):
            specs = _specs_of_param_tree(node, sizes, cfg, path)
            return _tree_map(lambda t: specs[id(t)], node)
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, torch.Tensor):
            return _spec_for(_path_str(path), tuple(node.shape), sizes)
        return None

    return walk(params, ())


def _tree_map(fn, tree):
    """``fn`` over the tensor leaves of dicts, lists, tuples and named
    tuples; other leaves (ints, strings) kept as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def tree_map_specs(fn, tree, specs):
    """``fn(tensor, spec)`` over the tensor leaves of ``tree`` and the
    matching leaves of its spec tree (``param_specs`` / ``cache_specs``)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, specs)
    if isinstance(tree, dict):
        return {k: tree_map_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_specs(fn, v, s) for v, s in zip(tree, specs)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_specs(fn, v, s) for v, s in zip(tree, specs))
    return tree


def spec_axes(entry) -> tuple:
    """The mesh axes of one spec entry (None, a name or a tuple of names)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def local_shape(shape, spec, mesh) -> tuple:
    """Each device's shard shape of a tensor of ``shape`` under ``spec``.
    The rules shard only dims their axes divide, so shards are even."""
    sizes = mesh_axis_sizes(mesh)
    out = list(shape)
    for i, entry in enumerate(spec):
        n = math.prod(sizes[a] for a in spec_axes(entry))
        if out[i] % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split over {entry!r}")
        out[i] //= n
    return tuple(out)


def shard_bytes(tree, specs, mesh) -> int:
    """Bytes of one device's shards of every tensor in ``tree``."""
    total = [0]

    def one(t, spec):
        total[0] += math.prod(local_shape(t.shape, spec, mesh)) * t.element_size()
        return t

    tree_map_specs(one, tree, specs)
    return total[0]


def param_placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` over ``mesh``'s dims, one per mesh
    dim: ``Shard(i)`` where tensor dim i names that axis, else
    ``Replicate()``.  A dim over several axes is sharded over each of them,
    in mesh order (the reference's ``("data", "pod")`` puts ``data`` major:
    the same shard sizes, another assignment of shards to devices)."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names
    placements = []
    for name in names:
        dims = [i for i, entry in enumerate(spec) if name in spec_axes(entry)]
        placements.append(Shard(dims[0]) if dims else Replicate())
    return tuple(placements)


def batch_axes(mesh):
    """Mesh axes used for data parallelism, e.g. ('pod','data') or ('data',)."""
    return tuple(a for a in mesh_axis_sizes(mesh) if a in ("pod", "data"))


def data_spec(mesh, rank: int, *, batch_dim: int = 0, shard_batch: bool = True) -> tuple:
    """Spec for an activation/input of given rank: batch over dp axes."""
    spec = [None] * rank
    if shard_batch:
        spec[batch_dim] = batch_axes(mesh)
    return tuple(spec)


def shardable_batch(mesh, batch: int) -> bool:
    sizes = mesh_axis_sizes(mesh)
    dp = math.prod(sizes[a] for a in batch_axes(mesh))
    return batch % dp == 0


# ---------------------------------------------------------------------------
# activation sharding hook: the launcher installs a spec; the model's layer
# loops constrain the residual stream with it (sequence-parallel activation
# sharding keeps remat-saved activations within per-device memory).
# ---------------------------------------------------------------------------

_ACTIVATION_SPEC: list = [None]


def set_activation_sharding(spec) -> None:
    """Install (or clear with None) a spec for (B, S, D) activations."""
    _ACTIVATION_SPEC[0] = spec


def constrain_activation(x):
    """A 3-D DTensor redistributed to the installed spec; any other input
    (a plain tensor, another rank, no spec installed) as it is."""
    spec = _ACTIVATION_SPEC[0]
    if spec is None or x.ndim != 3:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    placements = param_placements(spec, x.device_mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


# ---------------------------------------------------------------------------
# cache / state sharding: batch-shard everything with a leading (L, B, ...)
# layout; fall back to replication when batch is unshardable (long_500k,
# B=1) — the model axis still shards params.
# ---------------------------------------------------------------------------

def _is_integer(dtype: torch.dtype) -> bool:
    return not (dtype.is_floating_point or dtype.is_complex or dtype == torch.bool)


def cache_specs(cache: Any, mesh, *, shard_batch: bool = True):
    """Specs of the port's caches (``KVCache``, ``RWKVState``,
    ``HybridCache``, ``EncDecCache``), the same structure with a spec in
    place of each tensor.  Every port cache tensor is stacked on a leading
    layer axis (the hybrid's per kind), so its batch axis is 1 — the
    reference's choice for its stacked leaves; its hybrid tail entries
    (batch axis 0) are the same layers without the stacking axis."""
    sizes = mesh_axis_sizes(mesh)
    dp = math.prod(sizes[a] for a in batch_axes(mesh)) or 1
    md = sizes.get("model", 1)

    def one(leaf):
        rank = len(leaf.shape)
        spec = [None] * rank
        bd = min(1, rank - 1)
        if shard_batch and leaf.shape[bd] % dp == 0 and leaf.shape[bd] >= dp:
            spec[bd] = batch_axes(mesh)
        elif rank >= bd + 2:
            # batch unshardable (long_500k, B=1): context-parallel fallback —
            # shard the sequence axis of KV caches over `data`
            sd = bd + 1
            d_size = sizes.get("data", 1)
            if leaf.shape[sd] % d_size == 0 and leaf.shape[sd] >= d_size and leaf.shape[sd] > md:
                spec[sd] = "data"
        # tensor-parallel one more axis: prefer the LARGEST still-unsharded
        # axis (the sequence axis for KV caches), which decode attention
        # reduces over; integer leaves (positions) are never split.
        if rank >= bd + 3 and not _is_integer(leaf.dtype):
            cands = [i for i in range(bd + 1, rank) if spec[i] is None]
            cands.sort(key=lambda i: -leaf.shape[i])
            for i in cands:
                if leaf.shape[i] % md == 0 and leaf.shape[i] >= md:
                    spec[i] = "model"
                    break
        return tuple(spec)

    return _tree_map(one, cache)
