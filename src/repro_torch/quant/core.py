"""Quantization primitives: symmetric per-channel INT8 + FP8-E4M3 trees.

The port of the JAX package's ``quant/core.py``.  The rollout engine calls
``quantize_params`` at construction and at every weight sync, so it holds
int8/fp8 codes on the device; the paged forwards dequantize one layer at a
time inside their layer loop (``models/paged.py``), so only one layer's
full-precision weights exist at once.

Scheme (the FlashRL / vLLM loading recipe), as the reference computes it:

* matmul weights (ndim >= 2) are quantized per output channel: the absmax
  over every non-last axis sets one scale per last-axis column.  The
  reference stacks the layers on a leading axis, so that absmax runs over
  the layer axis too and one column's scale is SHARED by all layers.  Here
  ``blocks`` is a list of per-layer dicts; ``quantize_params`` reduces each
  leaf's absmax across the whole list to give the same scales and codes.
  The hybrid (RecurrentGemma) stacks each pattern position over the groups
  and keeps its tail as a Python list, which the reference does not
  quantize: ``groups`` (``transformer.block_groups(cfg)``) names each
  layer's scale group, or None for a tail layer.
* embeddings / lm_head / norm gains stay full precision.
* fp8 codes are ``torch.float8_e4m3fn`` (max normal 448).

A quantized leaf is a ``QuantLeaf(codes, scale, dtype)``.
"""
from __future__ import annotations

import functools
from typing import Any, List, NamedTuple

import torch

MODES = ("off", "int8", "fp8")          # weight quantization modes
KV_MODES = ("off", "int8")              # KV-page quantization modes

_INT8_MAX = 127.0
_FP8_MAX = 448.0                        # e4m3fn max normal
_EPS = 1e-12                            # zero-tensor guard for absmax scales

# full-precision islands: embeddings / unembedding by name, norm gains by
# leaf key (rmsnorm params are ``{"scale": (D,)}`` dicts, q_norm/k_norm are
# direct leaves).
_SKIP_KEYS = frozenset({"embed", "lm_head", "scale", "bias"})
_SKIP_SUFFIXES = ("_norm",)


class QuantLeaf(NamedTuple):
    """One quantized tensor: int8 or fp8 codes of the original shape, fp32
    scales broadcastable against them, and the original dtype, which
    dequantization restores."""
    codes: torch.Tensor
    scale: torch.Tensor
    dtype: torch.dtype


def _qmax(mode: str) -> float:
    if mode == "int8":
        return _INT8_MAX
    if mode == "fp8":
        return _FP8_MAX
    raise ValueError(f"unknown quant mode {mode!r} (expected int8 | fp8)")


def _absmax(x: torch.Tensor) -> torch.Tensor:
    """|x| reduced over every non-last axis, kept as size-1 axes."""
    xf = x.float().abs()
    if x.ndim < 2:
        return xf
    return xf.amax(dim=tuple(range(x.ndim - 1)), keepdim=True)


def _encode(x: torch.Tensor, scale: torch.Tensor, mode: str) -> QuantLeaf:
    xf = x.float()
    if mode == "int8":
        codes = torch.clamp(torch.round(xf / scale), -_INT8_MAX, _INT8_MAX)
        return QuantLeaf(codes.to(torch.int8), scale, x.dtype)
    return QuantLeaf((xf / scale).to(torch.float8_e4m3fn), scale, x.dtype)


def quantize_array(x: torch.Tensor, mode: str) -> QuantLeaf:
    """Symmetric per-output-channel quantization of one weight tensor."""
    scale = torch.clamp(_absmax(x), min=_EPS) / _qmax(mode)
    return _encode(x, scale, mode)


def _quantize_layers(xs: List[torch.Tensor], mode: str) -> List[QuantLeaf]:
    """The same leaf of every layer, quantized as the reference quantizes
    the stacked ``(L, ...)`` leaf: one scale per column across all layers
    (the per-layer absmaxes reduced with max, which is exact)."""
    amax = functools.reduce(torch.maximum, [_absmax(x) for x in xs])
    scale = torch.clamp(amax, min=_EPS) / _qmax(mode)
    return [_encode(x, scale, mode) for x in xs]


def dequantize_array(leaf: QuantLeaf) -> torch.Tensor:
    """Back to the original dtype: ``(codes.float() * scale).to(dtype)``,
    the reference's arithmetic.  int8 codes take it as one kernel (the
    multiply runs in fp32, the common dtype of int8 and fp32, and rounds
    once into the output's dtype: the same bits); torch does not promote
    fp8, so fp8 codes are widened first."""
    codes = leaf.codes if leaf.codes.dtype == torch.int8 else leaf.codes.float()
    out = torch.empty(codes.shape, dtype=leaf.dtype, device=codes.device)
    return torch.mul(codes, leaf.scale, out=out)


def _skip(key: str, leaf: Any, stacked: bool = False) -> bool:
    """The reference's skip rule.  ``stacked``: ``leaf`` is one layer of a
    leaf the reference holds with a leading layer axis (one more dim)."""
    if key in _SKIP_KEYS or key.endswith(_SKIP_SUFFIXES):
        return True
    if not isinstance(leaf, torch.Tensor):
        return True
    if leaf.ndim + int(stacked) < 2:
        return True
    return not leaf.is_floating_point()


def _quantize_blocks(layers: List[Any], key: str, mode: str) -> List[Any]:
    """Quantize a list of same-structured per-layer trees leaf by leaf."""
    first = layers[0]
    if isinstance(first, dict):
        per_key = {k: _quantize_blocks([lp[k] for lp in layers], k, mode)
                   for k in first}
        return [{k: per_key[k][i] for k in first} for i in range(len(layers))]
    if _skip(key, first, stacked=True):
        return list(layers)
    return _quantize_layers(layers, mode)


def _quantize_groups(layers: List[Any], groups: List[Any], mode: str) -> List[Any]:
    """``layers[i]`` quantized with the other layers of its scale group
    ``groups[i]``; layers of group None are left as they are."""
    if len(groups) != len(layers):
        raise ValueError(f"quantize_params: {len(groups)} groups for "
                         f"{len(layers)} layers")
    out = list(layers)
    for g in dict.fromkeys(x for x in groups if x is not None):
        idx = [i for i, x in enumerate(groups) if x == g]
        for i, lp in zip(idx, _quantize_blocks([layers[i] for i in idx], "", mode)):
            out[i] = lp
    return out


def quantize_params(params: Any, mode: str, *, groups=None) -> Any:
    """Quantize every matmul-weight leaf of a parameter tree.

    ``mode="off"`` returns the tree untouched.  Embeddings, lm_head and
    norm gains are kept full precision; everything else becomes a
    ``QuantLeaf``.  A list (``blocks``) is quantized as the reference's
    stacked layer axis: one scale group of every layer, or, with
    ``groups``, the scale group of each layer (None: not quantized)."""
    if mode == "off":
        return params
    if mode not in MODES:
        raise ValueError(f"unknown quant mode {mode!r} (expected "
                         "off | int8 | fp8)")

    def rec(node, key):
        if isinstance(node, dict):
            return {k: rec(v, k) for k, v in node.items()}
        if isinstance(node, list):
            if groups is not None:
                return _quantize_groups(node, groups, mode)
            return _quantize_blocks(node, key, mode) if node else []
        if _skip(key, node):
            return node
        return quantize_array(node, mode)

    return rec(params, "")


def dequantize_params(params: Any) -> Any:
    """Inverse of ``quantize_params``; identity on plain leaves."""
    if isinstance(params, QuantLeaf):
        return dequantize_array(params)
    if isinstance(params, dict):
        return {k: dequantize_params(v) for k, v in params.items()}
    if isinstance(params, list):
        return [dequantize_params(v) for v in params]
    return params


def is_quantized_tree(params: Any) -> bool:
    """Whether any leaf of ``params`` is a ``QuantLeaf``."""
    if isinstance(params, QuantLeaf):
        return True
    if isinstance(params, dict):
        return any(is_quantized_tree(v) for v in params.values())
    if isinstance(params, list):
        return any(is_quantized_tree(v) for v in params)
    return False
