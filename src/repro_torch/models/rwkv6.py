"""RWKV-6 "Finch" block: data-dependent token shift + decay linear attention.

The port of the JAX package's ``models/rwkv6.py`` (arXiv:2404.05892):
time mixing with LoRA-modulated token shift, per-channel data-dependent
decay w_t = exp(-exp(.)), bonus u, a per-head WKV state S in R^{hd x hd};
channel mixing with squared ReLU.  Decode carries {wkv, tm_prev, cm_prev}.

The WKV recurrence runs in the ``rwkv6_scan`` kernel (``attn_impl=
"kernel"``: the CUDA kernel on the card, its plain version on the CPU) or
in its plain version on any device (``"ref"``).  The reference chunks its
``lax.scan`` under ``jax.checkpoint`` only to bound its backward's
residuals; serving needs no backward.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.device import torch_dtype
from repro_torch.kernels.ref import rwkv6_scan_ref
from repro_torch.kernels.rwkv6_scan import rwkv6_scan
from repro_torch.models import module
from repro_torch.models import sharding as shd
from repro_torch.models.config import ModelConfig

_MIX_LORA = 32
_DECAY_LORA = 64


class RWKVState(NamedTuple):
    wkv: torch.Tensor      # (L, B, H, hd, hd) fp32; one layer's view drops L
    tm_prev: torch.Tensor  # (L, B, D)
    cm_prev: torch.Tensor  # (L, B, D)

    def layer(self, i: int) -> "RWKVState":
        """Layer ``i``'s views into the state."""
        return RWKVState(self.wkv[i], self.tm_prev[i], self.cm_prev[i])

    def rows(self, lo: int, hi: int) -> "RWKVState":
        """Views of batch rows ``lo:hi`` of every layer."""
        return RWKVState(self.wkv[:, lo:hi], self.tm_prev[:, lo:hi],
                         self.cm_prev[:, lo:hi])

    def write_layer(self, i: int, new: "RWKVState") -> None:
        """Copy one layer's new state into layer ``i`` (in place)."""
        for dst, src in zip(self.layer(i), new):
            if shd.ON_DTENSORS:
                shd.assign(dst, src)
            else:
                dst.copy_(src)


def init_rwkv_state(cfg: ModelConfig, batch: int, device) -> RWKVState:
    """Zero state of every layer."""
    n, h, hd, d = cfg.num_layers, cfg.num_rwkv_heads, cfg.rwkv_head_size, cfg.d_model
    dt = torch_dtype(cfg.dtype)
    return RWKVState(
        wkv=torch.zeros((n, batch, h, hd, hd), dtype=torch.float32, device=device),
        tm_prev=torch.zeros((n, batch, d), dtype=dt, device=device),
        cm_prev=torch.zeros((n, batch, d), dtype=dt, device=device),
    )


def _normal(gen, shape, scale, dtype, device):
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * scale).to(dtype)


def init_time_mix(gen: torch.Generator, cfg: ModelConfig, device):
    dt = torch_dtype(cfg.dtype)
    d, h, hd = cfg.d_model, cfg.num_rwkv_heads, cfg.rwkv_head_size
    zeros = lambda: torch.zeros((d,), dtype=dt, device=device)  # noqa: E731
    return {
        "mu_x": zeros(), "mu_w": zeros(), "mu_k": zeros(), "mu_v": zeros(),
        "mu_r": zeros(), "mu_g": zeros(),
        # token-shift LoRA: (D, 5*r) tanh (5, r, D)
        "mix_a": module.dense_init(gen, d, 5 * _MIX_LORA, dt, device, scale=0.01),
        "mix_b": _normal(gen, (5, _MIX_LORA, d), 0.01, dt, device),
        # decay: w = exp(-exp(w0 + tanh(x@da)@db))
        "w0": torch.full((d,), -6.0, dtype=torch.float32, device=device),
        "decay_a": module.dense_init(gen, d, _DECAY_LORA, dt, device, scale=0.01),
        "decay_b": _normal(gen, (_DECAY_LORA, d), 0.01, dt, device),
        "u": _normal(gen, (h, hd), 0.1, torch.float32, device),
        "wr": module.dense_init(gen, d, d, dt, device),
        "wk": module.dense_init(gen, d, d, dt, device),
        "wv": module.dense_init(gen, d, d, dt, device),
        "wg": module.dense_init(gen, d, d, dt, device),
        "wo": module.dense_init(gen, d, d, dt, device),
        "ln_scale": torch.ones((h, hd), dtype=torch.float32, device=device),
        "ln_bias": torch.zeros((h, hd), dtype=torch.float32, device=device),
    }


def init_channel_mix(gen: torch.Generator, cfg: ModelConfig, device):
    dt = torch_dtype(cfg.dtype)
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu_k": torch.zeros((d,), dtype=dt, device=device),
        "mu_r": torch.zeros((d,), dtype=dt, device=device),
        "wk": module.dense_init(gen, d, f, dt, device),
        "wv": module.dense_init(gen, f, d, dt, device),
        "wr": module.dense_init(gen, d, d, dt, device),
    }


def init_block(gen: torch.Generator, cfg: ModelConfig, device):
    return {
        "ln1": module.rmsnorm_init(cfg.d_model, device),
        "ln2": module.rmsnorm_init(cfg.d_model, device),
        "time_mix": init_time_mix(gen, cfg, device),
        "channel_mix": init_channel_mix(gen, cfg, device),
    }


def _head_groupnorm(p, y, eps=1e-5):
    """y: (..., H, hd) layernorm per head, fp32.  The variance is the
    population variance (``jnp.var``), hence ``correction=0``."""
    yf = y.float()
    mean = yf.mean(-1, keepdim=True)
    var = yf.var(-1, keepdim=True, correction=0)
    return (yf - mean) * torch.rsqrt(var + eps) * p["ln_scale"] + p["ln_bias"]


def _token_shift_inputs(p, x, prev):
    """Finch data-dependent token shift.

    x: (B,S,D); prev: (B,D) state (the token before x[:,0]).
    Returns xw, xk, xv, xr, xg each (B,S,D), plus the new prev (B,D)."""
    shifted = torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)
    sx = shifted - x
    xxx = x + sx * p["mu_x"]
    a = torch.tanh(xxx @ p["mix_a"])                    # (B,S,5r)
    b, s, _ = a.shape
    a = shd.view(a, b, s, 5, _MIX_LORA)
    adj = torch.einsum("bsnr,nrd->bsnd", a, p["mix_b"])  # (B,S,5,D)
    mus = torch.stack([p["mu_w"], p["mu_k"], p["mu_v"], p["mu_r"], p["mu_g"]])
    mixed = x[:, :, None, :] + sx[:, :, None, :] * (mus + adj)
    xw, xk, xv, xr, xg = mixed.unbind(dim=2)
    return xw, xk, xv, xr, xg, x[:, -1, :]


def _decay(p, xw):
    """w in (0,1): (B,S,D) fp32.  tanh of the LoRA input in the model
    dtype, the rest in fp32."""
    lora = torch.tanh(xw @ p["decay_a"]).float() @ p["decay_b"].float()
    return torch.exp(-torch.exp(p["w0"] + lora))


def wkv_scan(r, k, v, w, u, state, *, attn_impl: str = "kernel"):
    """r,k,v,w: (B,S,H,hd); u: (H,hd); state: (B,H,hd,hd) fp32.
    Returns y (B,S,H,hd) fp32 and the new state."""
    if attn_impl == "kernel":
        return rwkv6_scan(r, k, v, w, u, state)
    if attn_impl == "ref":
        if shd.ON_DTENSORS:
            return shd.local_rows(rwkv6_scan_ref, r, k, v, w, u, state)
        return rwkv6_scan_ref(r, k, v, w, u, state)
    raise ValueError(f"unknown attn_impl {attn_impl!r} (expected kernel | ref)")


def time_mix(p, cfg: ModelConfig, x, prev, wkv_state, *, attn_impl="kernel"):
    b, s, d = x.shape
    h, hd = cfg.num_rwkv_heads, cfg.rwkv_head_size
    xw, xk, xv, xr, xg, new_prev = _token_shift_inputs(p, x, prev)
    r = shd.view(xr @ p["wr"], b, s, h, hd)
    k = shd.view(xk @ p["wk"], b, s, h, hd)
    v = shd.view(xv @ p["wv"], b, s, h, hd)
    g = F.silu(xg @ p["wg"])
    w = shd.view(_decay(p, xw), b, s, h, hd)
    y, new_state = wkv_scan(r, k, v, w, p["u"], wkv_state, attn_impl=attn_impl)
    y = shd.view(_head_groupnorm(p, y), b, s, d).to(x.dtype)
    return (y * g) @ p["wo"], new_prev, new_state


def channel_mix(p, x, prev):
    shifted = torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)
    sx = shifted - x
    xk = x + sx * p["mu_k"]
    xr = x + sx * p["mu_r"]
    k = torch.square(torch.relu(xk @ p["wk"]))
    v = k @ p["wv"]
    if shd.ON_DTENSORS:
        r = torch.sigmoid(xr @ p["wr"])
        return r * shd.placed_like(v, r), x[:, -1, :]
    return torch.sigmoid(xr @ p["wr"]) * v, x[:, -1, :]


def block(p, cfg: ModelConfig, x, state: RWKVState, *, attn_impl="kernel"):
    """Pre-norm residual block.  ``state``: one layer's (B, ...) state.
    Returns (x, the layer's new RWKVState); ``state`` is not modified."""
    if shd.ON_DTENSORS:
        p = shd.gather_fsdp(p)
    y, tm_prev, wkv = time_mix(p["time_mix"], cfg,
                               module.rmsnorm(p["ln1"], x, cfg.norm_eps),
                               state.tm_prev, state.wkv, attn_impl=attn_impl)
    x = shd.residual(x, y)
    y, cm_prev = channel_mix(p["channel_mix"],
                             module.rmsnorm(p["ln2"], x, cfg.norm_eps),
                             state.cm_prev)
    x = shd.residual(x, y)
    return x, RWKVState(wkv=wkv, tm_prev=tm_prev, cm_prev=cm_prev)
