"""Carry the JAX package's parameters across to the port.

``params_from_jax`` takes the JAX param tree as nested dicts of numpy
arrays (the caller does the ``np.asarray`` on the JAX side, so this module
imports no JAX) in ``transformer.init_lm``'s layout: ``embed``, ``blocks``
stacked on a leading layer axis, ``final_norm``, ``lm_head``.  It returns
the port's layout — the same dicts with ``blocks`` as a list of per-layer
dicts — as tensors on ``device``.  ``cache_from_jax`` carries a paged KV
pool across the same way, int8 codes and their scales included, so both
packages can start from one pool; ``slot_cache_from_jax`` does the same
for the slot engine's caches (a dense ``KVCache`` or an RWKV-6
``RWKVState``, stacked on a leading layer axis in both packages).  ``params_to_numpy`` is the way back, so
that trees can be compared leaf by leaf.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.attention import KVCache
from repro_torch.models.paged import PagedKVCache
from repro_torch.models.rwkv6 import RWKVState


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a)   # a writable copy: JAX's host buffers are read-only
    if a.dtype.name == "bfloat16":
        # numpy has no bf16 of its own (JAX hands out ml_dtypes'): move the
        # raw 16-bit patterns and reinterpret them.
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _convert(tree, device):
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    return _tensor(tree, device)


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def params_from_jax(tree, device) -> dict:
    """JAX dense-LM param tree (numpy leaves) -> the port's params."""
    device = torch.device(device)
    out = {k: _convert(v, device) for k, v in tree.items() if k != "blocks"}
    n = len(np.asarray(tree["blocks"]["ln1"]["scale"]))
    out["blocks"] = [_convert(_layer(tree["blocks"], i), device)
                     for i in range(n)]
    return out


def cache_from_jax(cache, device) -> PagedKVCache:
    """A JAX ``PagedKVCache`` with numpy leaves (``k_pages``, ``v_pages``,
    and ``k_scales``/``v_scales`` or None) -> the port's ``PagedKVCache``."""
    device = torch.device(device)
    return PagedKVCache(*(None if a is None else _tensor(a, device)
                          for a in (cache.k_pages, cache.v_pages,
                                    cache.k_scales, cache.v_scales)))


def slot_cache_from_jax(cache, device, *, max_len=None):
    """A JAX slot-engine cache with numpy leaves -> the port's: a
    ``KVCache`` (``k``, ``v``, ``pos``; ``max_len``, the sequence budget it
    serves, defaults to its S_max, i.e. not a ring) or an ``RWKVState``
    (``wkv``, ``tm_prev``, ``cm_prev``)."""
    device = torch.device(device)
    if hasattr(cache, "wkv"):
        return RWKVState(*(_tensor(a, device)
                           for a in (cache.wkv, cache.tm_prev, cache.cm_prev)))
    k = _tensor(cache.k, device)
    return KVCache(k, _tensor(cache.v, device), _tensor(cache.pos, device),
                   k.shape[2] if max_len is None else max_len)


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()   # numpy has no bf16 of its own; fp32 holds it exactly
    return t.numpy()


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return _numpy(tree)


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def params_to_numpy(params) -> dict:
    """The port's params (or an fp32 optimizer tree of the same shape) ->
    the JAX layout with numpy leaves: ``blocks`` stacked back on a leading
    layer axis.  bf16 leaves come back as fp32 (exact)."""
    out = {k: _to_numpy(v) for k, v in params.items() if k != "blocks"}
    out["blocks"] = _stack([_to_numpy(b) for b in params["blocks"]])
    return out
