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

import contextlib
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
# the partitioned step: the model, loss and optimizer lines that DTensor's
# sharding propagation cannot take (or takes differently across torch
# versions) test ``ON_DTENSORS`` first and, while it is set, call the
# helpers below, which place their DTensor operands explicitly and work on
# each device's local shard.  Plain tensors never reach them.
# ---------------------------------------------------------------------------

ON_DTENSORS = False


@contextlib.contextmanager
def partitioned(activation_spec):
    """The step inside runs on DTensors: ``ON_DTENSORS`` set and the
    activation spec installed; both cleared on exit."""
    global ON_DTENSORS
    set_activation_sharding(activation_spec)
    ON_DTENSORS = True
    try:
        yield
    finally:
        ON_DTENSORS = False
        set_activation_sharding(None)


def _rebuild(x, local, placements, shape):
    """A DTensor over ``x``'s mesh from ``local`` (this device's shard of a
    tensor of ``shape``, contiguous) and ``placements``."""
    from torch.distributed.tensor import DTensor

    shape = tuple(shape)
    return DTensor.from_local(local, x.device_mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=_contiguous_stride(shape))


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def _replicated(x, mesh_dims):
    """``x`` with the placements on ``mesh_dims`` made ``Replicate()``."""
    from torch.distributed.tensor import Replicate

    if not mesh_dims:
        return x
    placements = [Replicate() if i in mesh_dims else p for i, p in enumerate(x.placements)]
    return x.redistribute(x.device_mesh, placements)


def view(x, *shape):
    """``x.reshape(shape)``; on the partitioned step, ``reshape`` on the
    local shard."""
    return reshape(x, shape) if ON_DTENSORS else x.reshape(shape)


def batched(x, make, dim: int = 0):
    """``make(b)`` for ``x``'s batch of b rows: a tensor, or a tree of them,
    whose dim ``dim`` is that batch.  On the partitioned step each device
    makes its own rows, placed as ``x``'s batch (replicated elsewhere), so
    that no device holds every row."""
    if not ON_DTENSORS:
        return make(x.shape[0])
    from torch.distributed.tensor import Replicate, Shard

    pl = [Shard(dim) if p.is_shard() and p.dim == 0 else Replicate() for p in x.placements]

    def place(t):
        shape = list(t.shape)
        shape[dim] = x.shape[0]
        return _rebuild(x, t.contiguous(), pl, shape)

    return _tree_map(place, make(x.to_local().shape[0]))


def attend_local(fn, q, k, v, q_pos, kv_pos, kv_valid, **kwargs):
    """``fn`` (the plain ``attend`` or ``_attend_direct``: q (B, Sq, KV, G,
    hd), k/v (B, Skv, KV, hd), positions and validity (B, S)) run on each
    device's shards: the batch split as q's, the KV heads where q, k and v
    all split them, the keys where k and v split their sequence and q is
    not split there (each device then attends over its keys, and the
    outputs are combined by one sum over those mesh dims: the bytes of a
    split softmax's combine, its log-sum-exp weights aside).  Every other
    dim replicated."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = q.device_mesh
    batch, heads, keys = [], [], []
    for m in range(mesh.ndim):
        pq, pk, pv = (getattr(t, "placements", [Replicate()] * mesh.ndim)[m] for t in (q, k, v))
        if pq == Shard(0):
            batch.append(m)
        elif pq == pk == pv == Shard(2):
            heads.append(m)
        elif pk == pv == Shard(1):
            keys.append(m)

    def pl(t, head_dim, key_dim):
        out = []
        for m in range(mesh.ndim):
            if m in batch:
                out.append(Shard(0))
            elif m in heads and head_dim is not None:
                out.append(Shard(head_dim))
            elif m in keys and key_dim is not None:
                out.append(Shard(key_dim))
            else:
                out.append(Replicate())
        return _placed(t, mesh, out).to_local()

    out = fn(pl(q, 2, None), pl(k, 2, 1), pl(v, 2, 1), pl(q_pos, None, None),
             pl(kv_pos, None, 1), pl(kv_valid, None, 1), **kwargs)
    placements = [Shard(0) if m in batch else Shard(2) if m in heads else Replicate()
                  for m in range(mesh.ndim)]
    part = _rebuild(q, out.contiguous(), [Partial() if m in keys else p
                                          for m, p in enumerate(placements)], q.shape)
    return part.redistribute(mesh, placements) if keys else part


def local_rows(fn, *inputs):
    """``fn`` on each device's batch rows: every input of the first's
    leading size sharded on dim 0 as the first is, every other dim and
    input replicated; the outputs, batch-first, sharded so."""
    from torch.distributed.tensor import Replicate

    first = inputs[0]
    mesh = first.device_mesh
    rows = [p if p.is_shard() and p.dim == 0 else Replicate() for p in first.placements]
    local = [_placed(x, mesh, rows if x.shape[0] == first.shape[0]
                     else [Replicate()] * mesh.ndim).to_local() for x in inputs]
    outs = fn(*local)
    return type(outs)(_rebuild(first, y.contiguous(), rows,
                               (first.shape[0],) + tuple(y.shape[1:])) for y in outs)


def microbatch(x, j: int, m: int):
    """Microbatch ``j`` of ``m`` of a DTensor batch ``x``: each device's
    ``j``-th m-th of its own rows, where its rows split m ways, as the
    batch's placements stay (the same rows over all microbatches as
    ``x[j * n // m:(j + 1) * n // m]`` takes, in another order); else that
    slice."""
    n = x.shape[0]
    local = x.to_local()
    rows = local.shape[0]
    if rows % m or n % m:
        return x[j * n // m:(j + 1) * n // m]
    return _rebuild(x, local[j * rows // m:(j + 1) * rows // m].contiguous(), x.placements,
                    (n // m,) + tuple(x.shape[1:]))


def residual(x, y):
    """``x + y``; on the partitioned step ``y`` brought to ``x``'s
    placements first (a partial sum reduced, scattered as ``x``'s
    sequence where ``x`` is sequence-parallel)."""
    return x + placed_like(y, x) if ON_DTENSORS else x + y


def batch_only(x):
    """``x`` sharded on its batch (dim 0) where it is, replicated on every
    other mesh dim: the sequence gathered, partial sums reduced.  What the
    reference's sequence-parallel stream does before each projection."""
    return _replicated(x, [i for i, p in enumerate(x.placements)
                           if not (p.is_shard() and p.dim == 0)])


def split_last(x, axis: str):
    """A DTensor replicated on mesh axis ``axis``, split there on its last
    dim (a local slice) where that divides; otherwise as it is."""
    from torch.distributed.tensor import Shard

    m = x.device_mesh.mesh_dim_names.index(axis) if axis in x.device_mesh.mesh_dim_names else None
    if m is None or not x.placements[m].is_replicate() or x.shape[-1] % x.device_mesh.shape[m]:
        return x
    placements = list(x.placements)
    placements[m] = Shard(x.ndim - 1)
    return x.redistribute(x.device_mesh, placements)


def replicate(tree):
    """Every DTensor of ``tree`` replicated on every mesh dim."""
    return _tree_map(lambda t: _replicated(t, list(range(t.device_mesh.ndim))), tree)


def gather_fsdp(tree):
    """Every DTensor of ``tree`` gathered over the batch mesh axes (``pod``,
    ``data``: the rules' FSDP axes), its ``model`` sharding kept: a layer's
    weights as its matmuls use them."""
    def one(t):
        names = t.device_mesh.mesh_dim_names
        return _replicated(t, [i for i, p in enumerate(t.placements)
                               if p.is_shard() and names[i] in ("pod", "data")])

    return _tree_map(one, tree)


def _dim_groups(src, dst):
    """Pairs (input dims, output dims) of a reshape of ``src`` into ``dst``
    whose products are equal, in order; trailing size-1 dims join the last
    pair."""
    groups, i, j = [], 0, 0
    while i < len(src) and j < len(dst):
        gi, gj = [i], [j]
        a, b = src[i], dst[j]
        i, j = i + 1, j + 1
        while a != b:
            if a < b:
                a *= src[i]
                gi.append(i)
                i += 1
            else:
                b *= dst[j]
                gj.append(j)
                j += 1
        groups.append((gi, gj))
    groups[-1][0].extend(range(i, len(src)))
    groups[-1][1].extend(range(j, len(dst)))
    return groups


def reshape(x, shape):
    """``x.reshape(shape)`` for a DTensor, on its local shard: a sharded dim
    stays sharded, on the leading output dim of its group, where it leads
    its group (size-1 dims aside) and that output dim divides over its mesh
    axes; any other sharding of a dim the reshape splits or merges is
    replicated first.  Torch's own view rules refuse such reshapes, or
    redistribute differently by version."""
    from torch.distributed.tensor import Shard

    src = tuple(x.shape)
    shape = tuple(shape)
    sizes = x.device_mesh.shape
    out_dim = {}
    for gi, gj in _dim_groups(src, shape):
        lead_in = next((d for d in gi if src[d] != 1), gi[0])
        lead_out = next((d for d in gj if shape[d] != 1), gj[0])
        split = math.prod(sizes[m] for m, p in enumerate(x.placements)
                          if p.is_shard() and p.dim == lead_in)
        for d in gi:
            keep = d == lead_in and shape[lead_out] % split == 0
            out_dim[d] = lead_out if keep else None
    x = _replicated(x, [m for m, p in enumerate(x.placements)
                        if p.is_shard() and out_dim[p.dim] is None])
    placements = [Shard(out_dim[p.dim]) if p.is_shard() else p for p in x.placements]
    local = x.to_local().reshape(local_shape_of(shape, placements, x.device_mesh))
    return _rebuild(x, local, placements, shape)


def local_shape_of(shape, placements, mesh) -> tuple:
    """This device's shard shape of a tensor of ``shape`` under DTensor
    ``placements`` (even shards)."""
    out = list(shape)
    for size, p in zip(mesh.shape, placements):
        if p.is_shard():
            out[p.dim] //= size
    return tuple(out)


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


def shard_offset(x, dim: int, mesh_dims) -> int:
    """This device's first index along ``dim`` of ``x``'s global tensor,
    where ``mesh_dims`` shard it (the first mesh dim major)."""
    mesh = x.device_mesh
    n, off = x.shape[dim], 0
    for m in mesh_dims:
        n //= mesh.shape[m]
        off += mesh.get_local_rank(m) * n
    return off


def write_slots(dst, bidx, idx, src) -> None:
    """``dst[bidx, idx] = src`` for a DTensor cache layer ``dst`` (B, S_max,
    ...), written in place on its local shard, its placements kept:
    ``src`` is brought to them (its batch sharded as ``dst``'s; replicated
    where ``dst`` shards its slots, each device then writing the entries
    that land in its slots at their local index; sharded as ``dst`` on its
    trailing dims), ``idx`` alike.  ``bidx`` are the rows 0..B-1 (shape (B,)
    or (B, 1)), as every caller passes.  Planned on meta shards only: a
    device's local write does not drop the entries that land in another
    device's slots (the reference's scatter drops them), so real values
    are refused."""
    from torch.distributed.tensor import Replicate, Shard

    if dst.to_local().device.type != "meta":
        raise NotImplementedError("write_slots: the partitioned cache write is "
                                  "planned on meta shards only")
    lead = idx.dim()                  # src's dims: idx's, then dst's trailing
    src_pl, idx_pl, slot_dims = [], [], []
    for m, p in enumerate(dst.placements):
        if p.is_shard() and p.dim == 0:
            src_pl.append(Shard(0))
            idx_pl.append(Shard(0))
        elif p.is_shard() and p.dim >= 2:
            src_pl.append(Shard(p.dim - 2 + lead))
            idx_pl.append(Replicate())
        else:
            slot_dims += [m] if p.is_shard() else []
            src_pl.append(Replicate())
            idx_pl.append(Replicate())
    mesh = dst.device_mesh
    src_l = _placed(src, mesh, src_pl).to_local()
    idx_l = _placed(idx, mesh, idx_pl).to_local()
    dst_l = dst.to_local()
    if slot_dims:
        idx_l = (idx_l - shard_offset(dst, 1, slot_dims)).clamp(0, dst_l.shape[1] - 1)
    rows = torch.arange(dst_l.shape[0], device=dst_l.device).reshape(
        (-1,) + (1,) * (bidx.dim() - 1))
    dst_l[rows, idx_l] = src_l.to(dst_l.dtype)


def assign(dst, src) -> None:
    """``dst.copy_(src)`` for a DTensor ``dst``, on its local shard: ``src``
    brought to ``dst``'s placements first, which ``dst`` keeps."""
    dst.to_local().copy_(_placed(src, dst.device_mesh, dst.placements).to_local())


def placed_like(x, like):
    """``x`` with ``like``'s placements."""
    return _placed(x, like.device_mesh, like.placements)


def placed_as(local, like):
    """A DTensor of ``local``, this device's shard of a tensor placed and
    shaped as ``like``."""
    return _rebuild(like, local, like.placements, like.shape)


def local_value(x):
    """A replicated DTensor's local value; anything else as it is."""
    return x.to_local() if hasattr(x, "to_local") else x


def global_norm(leaves):
    """sqrt of the fp32 sum of squares over DTensor ``leaves``: each
    device's sum over its shards, every leaf's divided by the devices that
    hold copies of its shards, summed over the whole mesh in one reduction."""
    mesh = leaves[0].device_mesh
    total = 0.0
    for t in leaves:
        copies = math.prod(n for n, p in zip(mesh.shape, t.placements) if not p.is_shard())
        total = total + t.to_local().float().square().sum() / copies
    return from_partial(total, leaves[0], list(range(mesh.ndim)), "sum", ()).sqrt()


def _placed(x, mesh, placements):
    """``x`` (a DTensor, or a plain tensor taken as replicated) with
    ``placements``."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(mesh, placements)


def _vocab_dims(table, dim: int):
    return [m for m, p in enumerate(table.placements) if p.is_shard() and p.dim == dim]


def embed_lookup(table, tokens):
    """``table[tokens]`` for a vocab-parallel DTensor ``table`` (V, D): the
    table gathered over the FSDP axes, each device looking up the tokens in
    its vocab rows (zeros for the others) on its local shard: the result is
    a partial sum over the vocab's mesh dims, sharded by batch as
    ``tokens``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    table = gather_fsdp(table)
    mesh = table.device_mesh
    vdims = _vocab_dims(table, 0)
    table = _replicated(table, [m for m, p in enumerate(table.placements)
                                if p.is_shard() and p.dim != 0])
    tok_pl = [p if m not in vdims and p.is_shard() and p.dim == 0 else Replicate()
              for m, p in enumerate(tokens.placements)]
    tok_l = _placed(tokens, mesh, tok_pl).to_local()
    tab_l = table.to_local()
    rows = tab_l.shape[0]
    li = tok_l.long() - shard_offset(table, 0, vdims)
    hit = ((li >= 0) & (li < rows))[..., None]
    out_l = tab_l[li.clamp(0, rows - 1)] * hit.to(tab_l.dtype)
    shape = tuple(tokens.shape) + (table.shape[1],)
    return DTensor.from_local(
        out_l, mesh, [Partial() if m in vdims else p for m, p in enumerate(tok_pl)],
        run_check=False, shape=torch.Size(shape), stride=_contiguous_stride(shape))


def vocab_logprobs(logits, tokens):
    """``algos.token_logprobs`` on DTensor logits (B, S, V) sharded on the
    vocab: the max, the sum of exponentials and the picked logit computed
    on each device's vocab columns and reduced over the vocab's mesh dims
    (a max, then two sums, each of (B, S) values)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    logits = _replicated(logits, [m for m, p in enumerate(logits.placements)
                                  if not p.is_shard() or p.dim not in (0, 2)])
    mesh = logits.device_mesh
    vdims = _vocab_dims(logits, 2)
    rest = [p if m not in vdims else Replicate() for m, p in enumerate(logits.placements)]
    shape = tuple(logits.shape[:2])

    def reduced(local, op):
        pl = [Partial(op) if m in vdims else p for m, p in enumerate(rest)]
        t = DTensor.from_local(local, mesh, pl, run_check=False, shape=torch.Size(shape),
                               stride=_contiguous_stride(shape))
        return t.redistribute(mesh, rest).to_local()

    lg = logits.to_local()
    tok_l = _placed(tokens, mesh, rest).to_local()
    mx = reduced(lg.amax(-1), "max")
    logz = reduced((lg - mx[..., None]).exp().sum(-1), "sum").log()
    cols = lg.shape[-1]
    li = tok_l.long() - shard_offset(logits, 2, vdims)
    hit = (li >= 0) & (li < cols)
    picked = reduced(lg.gather(-1, li.clamp(0, cols - 1)[..., None])[..., 0]
                     * hit.to(lg.dtype), "sum")
    out = picked - (logz + mx)
    return DTensor.from_local(out, mesh, rest, run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def from_partial(local, like, mesh_dims, op: str, global_shape=None):
    """A DTensor of ``local``, each device's partial value of an ``op``
    reduction over ``mesh_dims``, reduced there; placed as ``like``
    elsewhere (``global_shape``: ``like``'s unless given; ``()``, a scalar,
    is replicated)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    shape = tuple(like.shape) if global_shape is None else tuple(global_shape)
    rest = [Replicate() if m in mesh_dims or not shape else p
            for m, p in enumerate(like.placements)]
    pl = [Partial(op) if m in mesh_dims else p for m, p in enumerate(rest)]
    t = DTensor.from_local(local, like.device_mesh, pl, run_check=False,
                           shape=torch.Size(shape), stride=_contiguous_stride(shape))
    return t.redistribute(like.device_mesh, rest)
