"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

The port of the JAX package's ``models/rglru.py``.  Recurrence: h_t = a_t *
h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t), with a_t = exp(-c * softplus(Lambda)
* r_t) and input-dependent sigmoid gates r, i.  The block is: linear ->
causal depthwise conv(4) -> RG-LRU on one branch, linear -> GeLU on the
other, merged multiplicatively.  Decode carries {h, conv}.

The recurrence runs in the ``rglru_scan`` kernel (``attn_impl="kernel"``:
the CUDA kernel on the card, its plain version on the CPU) over any number
of steps, the decode step's one included, or in the reference model's own
forms (``"ref"``): a log-step doubling scan of the associative combine over
a prompt, one multiply-add at decode.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.device import torch_dtype
from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.models import module
from repro_torch.models import sharding as shd
from repro_torch.models.config import ModelConfig

_C = 8.0


class RGLRUState(NamedTuple):
    h: torch.Tensor     # (L, B, W) fp32 recurrent state; one layer's view drops L
    conv: torch.Tensor  # (L, B, K-1, W) previous conv inputs, in the model dtype

    def layer(self, i: int) -> "RGLRUState":
        """Layer ``i``'s views into the state."""
        return RGLRUState(self.h[i], self.conv[i])

    def rows(self, lo: int, hi: int) -> "RGLRUState":
        """Views of batch rows ``lo:hi`` of every layer."""
        return RGLRUState(self.h[:, lo:hi], self.conv[:, lo:hi])

    def write_layer(self, i: int, new: "RGLRUState") -> None:
        """Copy one layer's new state into layer ``i`` (in place)."""
        for dst, src in zip(self.layer(i), new):
            if shd.ON_DTENSORS:
                shd.assign(dst, src)
            else:
                dst.copy_(src)


def _width(cfg: ModelConfig) -> int:
    return cfg.lru_width or cfg.d_model


def init_rglru_state(cfg: ModelConfig, batch: int, device, *,
                     num_layers: int = 1) -> RGLRUState:
    """Zero state of ``num_layers`` RG-LRU layers."""
    w = _width(cfg)
    return RGLRUState(
        h=torch.zeros((num_layers, batch, w), dtype=torch.float32, device=device),
        conv=torch.zeros((num_layers, batch, cfg.conv_width - 1, w),
                         dtype=torch_dtype(cfg.dtype), device=device))


def init_recurrent_block(gen: torch.Generator, cfg: ModelConfig, device):
    dt = torch_dtype(cfg.dtype)
    d, w = cfg.d_model, _width(cfg)
    conv_w = torch.randn((cfg.conv_width, w), generator=gen, dtype=torch.float32,
                         device=device)
    return {
        "wx": module.dense_init(gen, d, w, dt, device),       # conv/LRU branch in
        "wy": module.dense_init(gen, d, w, dt, device),       # gate branch in
        "wo": module.dense_init(gen, w, d, dt, device),
        "conv_w": (conv_w * 0.1).to(dt),
        "conv_b": torch.zeros((w,), dtype=dt, device=device),
        "lam": torch.full((w,), 2.0, dtype=torch.float32, device=device),
        "wa": module.dense_init(gen, w, w, dt, device, scale=0.01),
        "ba": torch.zeros((w,), dtype=torch.float32, device=device),
        "wi": module.dense_init(gen, w, w, dt, device, scale=0.01),
        "bi": torch.zeros((w,), dtype=torch.float32, device=device),
    }


def _causal_conv(p, x, conv_state):
    """Depthwise causal conv of width K. x: (B, S, W); conv_state: (B, K-1,
    W).  Tap i of the window meets ``conv_w[K-1-i]``; fp32 accumulation."""
    k = p["conv_w"].shape[0]
    full = torch.cat([conv_state, x], dim=1)     # (B, K-1+S, W)
    s = x.shape[1]
    if shd.ON_DTENSORS:
        acc = torch.zeros_like(x, dtype=torch.float32)
    else:
        acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):
        acc = acc + full[:, i:i + s].float() * p["conv_w"][k - 1 - i].float()
    return (acc + p["conv_b"]).to(x.dtype), full[:, -(k - 1):]


def _gates(p, xc):
    """(a, b) of the recurrence, fp32: both gate products run on fp32
    copies of the weights, as the reference computes them."""
    xf = xc.float()
    r = torch.sigmoid(xf @ p["wa"].float() + p["ba"])
    i = torch.sigmoid(xf @ p["wi"].float() + p["bi"])
    log_a = -_C * F.softplus(p["lam"]) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, beta * (i * xf)


def doubling_scan(a, b, h0):
    """The reference's associative scan of ``(a1, b1) . (a2, b2) = (a1 a2,
    a2 b1 + b2)`` over time, as a log-step doubling (Hillis-Steele) scan.
    a/b: (B, S, W) fp32; h0: (B, W).  Returns hs (B, S, W)."""
    a = torch.cat([torch.zeros_like(h0)[:, None], a], dim=1)
    b = torch.cat([h0[:, None], b], dim=1)
    step = 1
    while step < a.shape[1]:
        a, b = (torch.cat([a[:, :step], a[:, :-step] * a[:, step:]], dim=1),
                torch.cat([b[:, :step], a[:, step:] * b[:, :-step] + b[:, step:]], dim=1))
        step *= 2
    return b[:, 1:]


def _scan(a, b, h0, attn_impl):
    """(hs, h_last) of the recurrence over every step of a/b."""
    if attn_impl == "kernel":
        return rglru_scan(a, b, h0)
    if attn_impl == "ref":
        hs = doubling_scan(a, b, h0)
        return hs, hs[:, -1]
    raise ValueError(f"unknown attn_impl {attn_impl!r} (expected kernel | ref)")


def _replicated_branch(p, state):
    """On the partitioned step the branch's products run on each device's
    batch rows, replicated over the other mesh axes: its weights are
    FSDP-only in the rules (gathered with the layer's), but for the conv
    taps, gathered here with the state's width."""
    return shd.replicate(p), RGLRUState(*(shd.batch_only(t) for t in state))


def recurrent_block(p, cfg: ModelConfig, x, state: RGLRUState, *,
                    attn_impl: str = "kernel"):
    """x: (B, S, D); ``state``: one layer's (B, ...) state.  Returns (out
    (B, S, D), the layer's new RGLRUState); ``state`` is not modified."""
    if shd.ON_DTENSORS:
        p, state = _replicated_branch(p, state)
    gate = F.gelu(x @ p["wy"], approximate="tanh")
    xc, conv_state = _causal_conv(p, x @ p["wx"], state.conv)
    a, b = _gates(p, xc)
    h0 = state.h
    if shd.ON_DTENSORS:
        # the recurrence is elementwise over the width: split it over the
        # tensor-parallel axis, as the fp32 (B, S, W) activations it keeps
        a, b, h0 = (shd.split_last(t, "model") for t in (a, b, h0))
    hs, h_last = _scan(a, b, h0, attn_impl)
    out = (hs.to(x.dtype) * gate) @ p["wo"]
    return out, RGLRUState(h=h_last, conv=conv_state)


def recurrent_step(p, cfg: ModelConfig, x, state: RGLRUState, *,
                   attn_impl: str = "kernel"):
    """Decode: x (B, 1, D).  ``"kernel"``: the scan kernel over one step;
    ``"ref"``: the reference's elementwise step."""
    if shd.ON_DTENSORS:
        p, state = _replicated_branch(p, state)
    gate = F.gelu(x @ p["wy"], approximate="tanh")
    xc, conv_state = _causal_conv(p, x @ p["wx"], state.conv)
    a, b = _gates(p, xc)                                   # (B, 1, W)
    if attn_impl == "kernel":
        _, h = rglru_scan(a, b, state.h)
    elif attn_impl == "ref":
        h = a[:, 0] * state.h + b[:, 0]
    else:
        raise ValueError(f"unknown attn_impl {attn_impl!r} (expected kernel | ref)")
    out = (h[:, None, :].to(x.dtype) * gate) @ p["wo"]
    return out, RGLRUState(h=h, conv=conv_state)
