"""Minimal module substrate: norms, RoPE and init helpers on plain tensors.

Parameters are nested dicts of tensors with the JAX package's tree layout
(``convert.params_from_jax`` maps one onto the other), except that the
per-layer blocks are a Python list instead of arrays stacked on a layer
axis.  Norm scales are fp32 even in a bf16 model, and norms and RoPE compute
in fp32 and cast back to the input dtype.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.models import sharding as shd


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype, device,
               scale: float | None = None):
    """Truncated-normal dense kernel (d_in, d_out), drawn in fp32."""
    if scale is None:
        scale = 1.0 / np.sqrt(d_in)
    w = torch.empty((d_in, d_out), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d_model: int, dtype, device):
    w = torch.empty((vocab, d_model), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w.to(dtype)


def rmsnorm_init(d: int, device):
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm(params, x, eps: float = 1e-6):
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    if shd.ON_DTENSORS:
        # the sequence-parallel stream gathered before the projections
        return shd.batch_only((y * params["scale"]).to(dt))
    return (y * params["scale"]).to(dt)


def rmsnorm_head(scale, x, eps: float = 1e-6):
    """RMSNorm over the trailing head_dim (qk-norm), scale shape (head_dim,)."""
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(dt)


# ---------------------------------------------------------------------------
# RoPE (half-split, not interleaved)
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float):
    half = head_dim // 2
    return 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) * 2.0 / head_dim))


@functools.lru_cache(maxsize=16)
def _inv_freq(head_dim: int, theta: float, device: torch.device):
    # built once per device: a host->device copy from pageable memory
    # would synchronise the stream on every layer of every step.
    return torch.from_numpy(rope_frequencies(head_dim, theta)).to(device)


def apply_rope(x, positions, theta: float):
    """x: (..., seq, heads, head_dim); positions: broadcastable to (..., seq)."""
    inv_freq = _inv_freq(x.shape[-1], theta, x.device)
    angles = positions.float()[..., None] * inv_freq   # (..., seq, half)
    angles = angles[..., None, :]                      # broadcast over heads
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def count_params(params) -> int:
    if isinstance(params, torch.Tensor):
        return params.numel()
    items = params.values() if isinstance(params, dict) else params
    return sum(count_params(p) for p in items)
