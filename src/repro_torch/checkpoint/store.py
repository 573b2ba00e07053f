"""Checkpointing: msgpack-serialized param/optimizer trees, in the JAX
package's layout, so that a checkpoint written by either package loads in
the other.

Layout: <dir>/step_<n>/{tree.msgpack, meta.json}.  ``tree.msgpack`` is one
msgpack array of ``{"dtype", "shape", "data"}`` maps, one per leaf in
``jax.tree_util`` flatten order over the JAX package's structure: dict keys
sorted, lists in order, ``None`` no leaf; an LM param tree (a dict whose
``blocks`` is the port's per-layer list) mapped to the JAX layout by
``convert.to_jax_layout`` (``blocks`` stacked on a leading layer axis; for
the hybrid, one stack per pattern position and the ``tail`` list, which
needs the model's ``cfg``).  Arrays are stored as (dtype name, shape, raw
little-endian bytes); bfloat16 as its raw 16-bit patterns under
``"bfloat16"``; the optimizer's host-int ``step`` as an ``int32`` of shape
``[]``.  Leaves keep their dtypes and are written one by one, a stacked
leaf layer by layer, so nothing is stacked in memory.

The encoder and decoder below cover the part of msgpack the layout uses
(array, map, str, bin, int) and give ``msgpack.packb(payload,
use_bin_type=True)``'s bytes exactly; the port needs no ``msgpack``
package.  ``meta.json`` holds ``step``, the caller's meta and, under
``"treedef"``, the port's description of the layout (every leaf's path
and shape); ``load_tree`` does not read it, as the JAX package's does not.
"""
from __future__ import annotations

import json
import os
import struct
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.convert import to_jax_layout

_BIN_MAX = 0xFFFFFFFF            # bin32: the largest leaf msgpack can hold


# ---------------------------------------------------------------------------
# msgpack, the subset of the layout (array, map, str, bin, int)
# ---------------------------------------------------------------------------

def _header(small: int, tags: tuple, n: int, what: str) -> bytes:
    """fixarray/fixmap (``small``) or the 16- and 32-bit forms."""
    if n <= 0x0F:
        return bytes([small | n])
    if n <= 0xFFFF:
        return struct.pack(">BH", tags[0], n)
    if n <= 0xFFFFFFFF:
        return struct.pack(">BI", tags[1], n)
    raise ValueError(f"{what} of {n} entries is too large for msgpack")


def _array(n: int) -> bytes:
    return _header(0x90, (0xDC, 0xDD), n, "array")


def _map(n: int) -> bytes:
    return _header(0x80, (0xDE, 0xDF), n, "map")


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    n = len(b)
    if n < 32:
        head = bytes([0xA0 | n])
    elif n <= 0xFF:
        head = struct.pack(">BB", 0xD9, n)
    elif n <= 0xFFFF:
        head = struct.pack(">BH", 0xDA, n)
    elif n <= 0xFFFFFFFF:
        head = struct.pack(">BI", 0xDB, n)
    else:
        raise ValueError("string is too large for msgpack")
    return head + b


def _bin_header(n: int) -> bytes:
    if n <= 0xFF:
        return struct.pack(">BB", 0xC4, n)
    if n <= 0xFFFF:
        return struct.pack(">BH", 0xC5, n)
    if n <= _BIN_MAX:
        return struct.pack(">BI", 0xC6, n)
    raise ValueError(f"a leaf of {n} bytes is too large for msgpack (bin32 holds "
                     f"at most 4 GiB - 1 = {_BIN_MAX} bytes)")


def _int(x: int) -> bytes:
    """msgpack's choice: the fixints, then the unsigned forms for x >= 0."""
    if 0 <= x < 0x80 or -0x20 <= x < 0:
        return struct.pack("b" if x < 0 else "B", x)
    for lo, hi, fmt, tag in ((0x80, 0xFF, "B", 0xCC), (-0x80, -1, "b", 0xD0),
                             (0x100, 0xFFFF, "H", 0xCD), (-0x8000, -0x81, "h", 0xD1),
                             (0x10000, 0xFFFFFFFF, "I", 0xCE),
                             (-0x80000000, -0x8001, "i", 0xD2),
                             (0x100000000, 0xFFFFFFFFFFFFFFFF, "Q", 0xCF),
                             (-0x8000000000000000, -0x80000001, "q", 0xD3)):
        if lo <= x <= hi:
            return struct.pack(">B" + fmt, tag, x)
    raise ValueError(f"integer {x} is too large for msgpack")


class _Reader:
    """Decodes the subset above from a binary file, one value at a time."""

    def __init__(self, f):
        self.f = f

    def _take(self, n: int) -> bytes:
        b = self.f.read(n)
        if len(b) != n:
            raise ValueError("checkpoint: tree.msgpack is truncated")
        return b

    def _bin(self, n: int) -> bytearray:
        buf = bytearray(n)
        view, got = memoryview(buf), 0
        while got < n:
            k = self.f.readinto(view[got:])
            if not k:
                raise ValueError("checkpoint: tree.msgpack is truncated")
            got += k
        return buf

    def _len(self, tag: int, fix: int, w16: int, w32: int) -> Optional[int]:
        if fix <= tag <= fix + 0x0F:
            return tag - fix
        if tag == w16:
            return struct.unpack(">H", self._take(2))[0]
        if tag == w32:
            return struct.unpack(">I", self._take(4))[0]
        return None

    def array_len(self) -> int:
        n = self._len(self._take(1)[0], 0x90, 0xDC, 0xDD)
        if n is None:
            raise ValueError("checkpoint: tree.msgpack does not hold an array")
        return n

    def value(self):
        tag = self._take(1)[0]
        if tag < 0x80:
            return tag
        if tag >= 0xE0:
            return tag - 0x100
        if 0xA0 <= tag <= 0xBF:
            return self._take(tag - 0xA0).decode("utf-8")
        n = self._len(tag, 0x90, 0xDC, 0xDD)
        if n is not None:
            return [self.value() for _ in range(n)]
        n = self._len(tag, 0x80, 0xDE, 0xDF)
        if n is not None:
            out = {}
            for _ in range(n):
                k = self.value()
                out[k] = self.value()
            return out
        sizes = {0xD9: 1, 0xDA: 2, 0xDB: 4, 0xC4: 1, 0xC5: 2, 0xC6: 4}
        if tag in sizes:
            n = int.from_bytes(self._take(sizes[tag]), "big")
            return self._bin(n) if tag in (0xC4, 0xC5, 0xC6) else \
                self._take(n).decode("utf-8")
        ints = {0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q",
                0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if tag in ints:
            fmt = ">" + ints[tag]
            return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]
        raise ValueError(f"checkpoint: msgpack type 0x{tag:02x} is not in the layout")


# ---------------------------------------------------------------------------
# trees: the port's structure <-> the JAX package's leaves
# ---------------------------------------------------------------------------

class _Slot:
    """Stands for one leaf of the port's tree (its index in ``leaves``)."""
    __slots__ = ("i",)

    def __init__(self, i: int):
        self.i = i


class _Stacked(list):
    """The per-layer leaves of one JAX leaf stacked on a layer axis."""


def _slots(tree, leaves: list):
    """``tree`` with every leaf replaced by a ``_Slot`` (the leaf appended
    to ``leaves``); ``None`` stays ``None``."""
    if isinstance(tree, dict):
        return {k: _slots(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_slots(v, leaves) for v in tree)
    if tree is None:
        return None
    leaves.append(tree)
    return _Slot(len(leaves) - 1)


def _jax_view(tree, cfg):
    """The slot tree in the JAX package's structure."""
    if isinstance(tree, dict):
        if isinstance(tree.get("blocks"), list):
            return to_jax_layout(tree, cfg, leaf=lambda s: s, stack=_Stacked)
        return {k: _jax_view(v, cfg) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_jax_view(v, cfg) for v in tree]
    return tree


def _flatten(tree, path: str = ""):
    """(path, ``_Slot`` or ``_Stacked``) in ``jax.tree_util`` order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{path}/{k}")
    elif isinstance(tree, list) and not isinstance(tree, _Stacked):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{path}/{i}")
    elif tree is not None:
        yield path or "/", tree


def _unslot(tree, values: list):
    if isinstance(tree, dict):
        return {k: _unslot(v, values) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unslot(v, values) for v in tree)
    if tree is None:
        return None
    return values[tree.i]


def _layout(tree, cfg):
    """(the port's leaves, the slot tree, [(path, slot or stack)])."""
    leaves: list = []
    slots = _slots(tree, leaves)
    return leaves, slots, list(_flatten(_jax_view(slots, cfg)))


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    if isinstance(x, int) and not isinstance(x, bool):
        return "int32"
    raise TypeError(f"checkpoint: cannot store a leaf of type {type(x).__name__}")


def _shape(x) -> list:
    return list(x.shape) if isinstance(x, torch.Tensor) else []


def _bytes(x) -> memoryview:
    if isinstance(x, torch.Tensor):
        flat = x.detach().contiguous().reshape(-1).view(torch.uint8).cpu()
        return memoryview(flat.numpy())
    return memoryview(np.int32(x).tobytes())


def _parts(leaves: list, node) -> list:
    return [leaves[s.i] for s in node] if isinstance(node, _Stacked) else [leaves[node.i]]


def _leaf_spec(leaves: list, path: str, node) -> tuple:
    """(dtype name, JAX shape, the port's leaves whose bytes make the data)."""
    parts = _parts(leaves, node)
    name, shape = _dtype_name(parts[0]), _shape(parts[0])
    for p in parts[1:]:
        if _dtype_name(p) != name or _shape(p) != shape:
            raise ValueError(f"checkpoint: layers of {path} differ in dtype or shape")
    return name, ([len(parts)] + shape if isinstance(node, _Stacked) else shape), parts


def save_tree(path: str, tree: Any, *, meta: Optional[dict] = None, cfg=None) -> None:
    """Write ``tree`` (the port's params, a train state, any nested
    dicts/lists of tensors and ints) in the JAX package's layout.  ``cfg``
    is needed only for a hybrid model's tree."""
    leaves, _, flat = _layout(tree, cfg)
    specs = [(p,) + _leaf_spec(leaves, p, node) for p, node in flat]
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "tree.msgpack"), "wb") as f:
        f.write(_array(len(specs)))
        for _, name, shape, parts in specs:
            first = _bytes(parts[0])     # every layer of a stack has its size
            f.write(_map(3) + _str("dtype") + _str(name) + _str("shape")
                    + _array(len(shape)) + b"".join(_int(d) for d in shape)
                    + _str("data") + _bin_header(first.nbytes * len(parts)))
            f.write(first)
            for x in parts[1:]:
                f.write(_bytes(x))
    desc = {"format": "jax.tree_util flatten order of the JAX package's layout",
            "leaves": [[p, name, shape] for p, name, shape, _ in specs]}
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"treedef": desc, **(meta or {})}, f)


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"checkpoint: unknown dtype {name!r}")
    return dt


def _decode(d: dict) -> torch.Tensor:
    """One stored leaf -> a CPU tensor of its dtype and shape."""
    dt, shape = _torch_dtype(d["dtype"]), tuple(d["shape"])
    data = d["data"]
    if not len(data):
        return torch.empty(shape, dtype=dt)
    return torch.frombuffer(data, dtype=torch.uint8).view(dt).reshape(shape)


def load_tree(path: str, like: Any, *, cfg=None) -> Any:
    """Restore into the structure of ``like``, on its leaves' devices and
    in their dtypes; each leaf's shape is checked.  An int leaf of ``like``
    (the optimizer's ``step``) comes back as an int.  ``cfg`` is needed
    only for a hybrid model's tree."""
    leaves, slots, flat = _layout(like, cfg)
    values: list = [None] * len(leaves)
    with open(os.path.join(path, "tree.msgpack"), "rb") as f:
        reader = _Reader(f)
        n = reader.array_len()
        if n != len(flat):
            raise ValueError(f"checkpoint/tree mismatch: {n} leaves stored, "
                             f"{len(flat)} in the tree")
        for p, node in flat:
            name, shape, parts = _leaf_spec(leaves, p, node)
            arr = _decode(reader.value())
            if list(arr.shape) != shape:
                raise ValueError(f"checkpoint: {p} has shape {list(arr.shape)}, "
                                 f"the tree {shape}")
            slot_list = list(node) if isinstance(node, _Stacked) else [node]
            pieces = arr.unbind(0) if isinstance(node, _Stacked) else [arr]
            for s, ref, piece in zip(slot_list, parts, pieces):
                if isinstance(ref, torch.Tensor):
                    values[s.i] = piece.to(device=ref.device, dtype=ref.dtype,
                                           copy=True)
                else:
                    values[s.i] = int(piece)
    return _unslot(slots, values)


def save_checkpoint(ckpt_dir: str, step: int, state: Any, *, cfg=None, **meta) -> str:
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    save_tree(path, state, meta={"step": step, **meta}, cfg=cfg)
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    return os.path.join(ckpt_dir, steps[-1]) if steps else None
