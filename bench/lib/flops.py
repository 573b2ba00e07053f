"""Operations and bytes from shapes, and the chip's peaks.

The model's FLOPs count the products of the non-embedding weights and the
unembedding (``2 N`` a token forward, ``6 N`` forward and backward) on the
tokens that carry data, plus causal attention's QK^T and PV (``4 H D`` a
visible (query, key) pair and layer forward, three times that forward and
backward).  Nothing recomputed is counted.

``flash_bound`` is a copy of the arithmetic of ``chip_smoke._flash_bound``,
taken from shapes instead of tensors, so that the yardstick lives with the
benchmark.
"""
from __future__ import annotations

from typing import Iterable, Tuple

# NVIDIA H100 SXM, dense, at its 700 W limit (NVIDIA's data sheet)
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def shapes(cfg: dict) -> Tuple[int, int, int, int, int, int, int]:
    """(layers, d_model, heads, kv_heads, head_dim, d_ff, vocab) of a
    configuration file."""
    return (cfg["num_hidden_layers"], cfg["hidden_size"], cfg["num_attention_heads"],
            cfg["num_key_value_heads"], cfg["head_dim"], cfg["intermediate_size"],
            cfg["vocab_size"])


def matmul_params(cfg: dict) -> int:
    """N: the weights of every product a token passes through, the
    unembedding included, the embedding lookup not."""
    n_layers, d, h, kv, hd, f, v = shapes(cfg)
    per_layer = d * h * hd + 2 * d * kv * hd + h * hd * d + 3 * d * f
    return n_layers * per_layer + d * v


def head_params(cfg: dict) -> int:
    _, d, _, _, _, _, v = shapes(cfg)
    return d * v


def causal_pairs(length: int) -> int:
    """Visible (query, key) pairs of a sequence under a causal mask."""
    return length * (length + 1) // 2


def attention_flops(cfg: dict, pairs: int) -> float:
    """Forward QK^T and PV over ``pairs`` visible pairs, every layer."""
    n_layers, _, h, _, hd, _, _ = shapes(cfg)
    return 4.0 * n_layers * h * hd * pairs


def forward_flops(cfg: dict, lengths: Iterable[int]) -> float:
    """One forward of sequences of these (real) lengths, logits at every
    position."""
    lengths = list(lengths)
    return (2.0 * matmul_params(cfg) * sum(lengths)
            + attention_flops(cfg, sum(causal_pairs(n) for n in lengths)))


def flash_bound(b: int, h: int, kv: int, s: int, d: int, backward: bool,
                itemsize: int = 2) -> dict:
    """``chip_smoke._flash_bound`` for a causal bf16 call: the larger of the
    operations (4 D a visible pair forward; 10 D backward: QK^T again, dP,
    dV, dK, dQ) at 989 TFLOP/s and the bytes (forward: q, k, v read, o and
    lse written; backward: q, k, v, o, dO, lse read, dq, dk, dv written) at
    3.35 TB/s."""
    flops = (10 if backward else 4) * d * b * h * causal_pairs(s)
    qo, kvb = b * h * s * d * itemsize, b * kv * s * d * itemsize
    lse = 4 * b * h * s
    nbytes = (3 * qo + 4 * kvb + lse) if backward else (2 * qo + 2 * kvb + lse)
    t_ops, t_bytes = flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S
    return {"bytes": nbytes, "flops": flops, "seconds": max(t_ops, t_bytes),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
