"""Carry the JAX package's parameters across to the port.

``params_from_jax`` takes the JAX param tree as nested dicts of numpy
arrays (the caller does the ``np.asarray`` on the JAX side, so this module
imports no JAX) in ``transformer.init_lm``'s layout: ``embed``, ``blocks``
stacked on a leading layer axis, ``final_norm``, ``lm_head`` — for the
hybrid, ``blocks`` a dict of pattern positions (``"{i}_{kind}"``) each
stacked over the groups, and a ``tail`` list.  It returns the port's
layout — the same dicts with ``blocks`` as a list of per-layer dicts in
execution order — as tensors on ``device``.  ``cache_from_jax`` carries a
paged KV pool across the same way, int8 codes and their scales included,
so both packages can start from one pool; ``slot_cache_from_jax`` does the
same for the slot engine's caches (a dense ``KVCache`` or an RWKV-6
``RWKVState``, stacked on a leading layer axis in both packages, or the
hybrid's dict of stacked groups and tail, which becomes a
``HybridCache``).  ``state_from_jax`` carries a whole train state across,
the critic's value head and its optimizer state included.
``params_to_numpy`` is the way back, so that trees can be compared leaf
by leaf; ``to_jax_layout`` is its layout mapping alone (the checkpoint
store writes through it, dtypes kept).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import transformer
from repro_torch.models.attention import KVCache
from repro_torch.models.paged import PagedKVCache
from repro_torch.models.rglru import RGLRUState
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


def _pattern_keys(stacked: dict) -> list:
    """The hybrid's ``"{i}_{kind}"`` keys in pattern order."""
    return sorted((k for k in stacked if k != "tail"),
                  key=lambda k: int(k.split("_", 1)[0]))


def params_from_jax(tree, device) -> dict:
    """JAX LM param tree (numpy leaves) -> the port's params."""
    device = torch.device(device)
    out = {k: _convert(v, device) for k, v in tree.items()
           if k not in ("blocks", "tail")}
    blocks = tree["blocks"]
    if "tail" in tree:                      # hybrid: groups, then the tail
        keys = _pattern_keys(blocks)
        n = len(np.asarray(blocks[keys[0]]["ln1"]["scale"]))
        layers = ([_layer(blocks[k], g) for g in range(n) for k in keys]
                  + list(tree["tail"]))
    else:
        n = len(np.asarray(blocks["ln1"]["scale"]))
        layers = [_layer(blocks, i) for i in range(n)]
    out["blocks"] = [_convert(lp, device) for lp in layers]
    return out


def cache_from_jax(cache, device) -> PagedKVCache:
    """A JAX ``PagedKVCache`` with numpy leaves (``k_pages``, ``v_pages``,
    and ``k_scales``/``v_scales`` or None) -> the port's ``PagedKVCache``."""
    device = torch.device(device)
    return PagedKVCache(*(None if a is None else _tensor(a, device)
                          for a in (cache.k_pages, cache.v_pages,
                                    cache.k_scales, cache.v_scales)))


def _hybrid_cache_from_jax(cache, device, max_len):
    """The hybrid's JAX cache (each pattern position stacked over the
    groups; tail states with their batch on axis 0) -> a ``HybridCache``
    stacked per kind in execution order."""
    keys = _pattern_keys(cache)
    n = len(np.asarray(cache[keys[0]][0]))
    layers = [(k.split("_", 1)[1], cache[k], g) for g in range(n) for k in keys]
    layers += [("attn" if hasattr(st, "k") else "rglru", st, None)
               for st in cache["tail"]]
    def stack(kind, name):
        return _tensor(np.stack([np.asarray(getattr(st, name))[() if g is None else g]
                                 for k, st, g in layers if k == kind]), device)

    k = stack("attn", "k")
    kv = KVCache(k, stack("attn", "v"), stack("attn", "pos"),
                 k.shape[2] if max_len is None else max_len)
    return transformer.HybridCache(kv, RGLRUState(stack("rglru", "h"),
                                                  stack("rglru", "conv")),
                                   transformer.indexed_kinds(k for k, _, _ in layers))


def slot_cache_from_jax(cache, device, *, max_len=None):
    """A JAX slot-engine cache with numpy leaves -> the port's: a
    ``KVCache`` (``k``, ``v``, ``pos``; ``max_len``, the sequence budget it
    serves, defaults to its S_max, i.e. not a ring), an ``RWKVState``
    (``wkv``, ``tm_prev``, ``cm_prev``) or, from the hybrid's dict, a
    ``HybridCache``."""
    device = torch.device(device)
    if isinstance(cache, dict):
        return _hybrid_cache_from_jax(cache, device, max_len)
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


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _stack(trees, stack):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees], stack) for k in trees[0]}
    return stack(trees)


def to_jax_layout(params, cfg=None, *, leaf=_numpy, stack=np.stack) -> dict:
    """The port's params (or a tree of the same shape) in the JAX layout:
    ``leaf`` applied to every tensor, ``blocks`` stacked back on a leading
    layer axis by ``stack`` (given each leaf's per-layer values in layer
    order) — for a hybrid ``cfg``, one stack per pattern position
    (``"{i}_{kind}"``) and the ``tail`` list of per-layer dicts."""
    out = {k: _map(leaf, v) for k, v in params.items() if k != "blocks"}
    blocks = [_map(leaf, b) for b in params["blocks"]]
    if cfg is None or cfg.family != "hybrid":
        if any("rec" in b for b in blocks):
            raise ValueError("a hybrid tree needs its cfg")
        out["blocks"] = _stack(blocks, stack)
        return out
    groups = transformer.block_groups(cfg)
    out["blocks"] = {f"{i}_{kind}": _stack([b for b, g in zip(blocks, groups) if g == i],
                                           stack)
                     for i, kind in enumerate(cfg.block_pattern)}
    out["tail"] = [b for b, g in zip(blocks, groups) if g is None]
    return out


def params_to_numpy(params, cfg=None) -> dict:
    """The port's params (or an fp32 optimizer tree of the same shape) ->
    the JAX layout with numpy leaves (``to_jax_layout``).  bf16 leaves
    come back as fp32 (exact)."""
    return to_jax_layout(params, cfg)


def _opt_from_jax(opt, device) -> dict:
    tree = params_from_jax if "blocks" in opt["master"] else _convert
    return {"step": int(np.asarray(opt["step"])),
            **{k: tree(opt[k], device) for k in ("master", "m", "v")}}


def state_from_jax(state, device) -> dict:
    """A JAX train state — ``{"params", "opt"}``, or the critic's
    ``{"params", "value", "opt", "vopt"}`` — with numpy leaves -> the
    port's: the params and the optimizer's master/m/v trees through
    ``params_from_jax``, the value head ``{"w", "b"}`` and its optimizer
    state leaf for leaf, each ``step`` a host int."""
    device = torch.device(device)
    out = {"params": params_from_jax(state["params"], device),
           "opt": _opt_from_jax(state["opt"], device)}
    if "value" in state:
        out["value"] = _convert(state["value"], device)
        out["vopt"] = _opt_from_jax(state["vopt"], device)
    return out
