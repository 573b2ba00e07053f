"""Gated MLPs (SwiGLU / GeGLU)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import torch_dtype
from repro_torch.models import module
from repro_torch.models.config import ModelConfig


def init_mlp(gen: torch.Generator, cfg: ModelConfig, device,
             d_ff: int | None = None):
    dt = torch_dtype(cfg.dtype)
    d_ff = d_ff or cfg.d_ff
    return {
        "wi_gate": module.dense_init(gen, cfg.d_model, d_ff, dt, device),
        "wi_up": module.dense_init(gen, cfg.d_model, d_ff, dt, device),
        "wo": module.dense_init(gen, d_ff, cfg.d_model, dt, device),
    }


def mlp(p, cfg: ModelConfig, x):
    gate = x @ p["wi_gate"]
    up = x @ p["wi_up"]
    if cfg.mlp_activation == "geglu":
        act = F.gelu(gate, approximate="tanh")
    else:
        act = F.silu(gate)
    return (act * up) @ p["wo"]
