"""Decoder-only LM assembly, dense family.

The JAX package stacks the layers on a leading axis and runs them with
``lax.scan``; here ``params["blocks"]`` is a list of per-layer dicts walked
by a Python loop.  Other families (MoE, RWKV-6, RG-LRU, VLM, enc-dec) are
later slices of the port.

Entry points:
    init_lm(cfg, seed, device=)                 -> params
    lm_apply(params, cfg, tokens, ...)          -> (logits fp32, aux)
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models import attention, ffn, module
from repro_torch.models.config import ModelConfig


def _check_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (dense only)")


def _init_attn_block(gen: torch.Generator, cfg: ModelConfig, device):
    return {
        "ln1": module.rmsnorm_init(cfg.d_model, device),
        "ln2": module.rmsnorm_init(cfg.d_model, device),
        "attn": attention.init_attention(gen, cfg, device),
        "mlp": ffn.init_mlp(gen, cfg, device),
    }


def init_lm(cfg: ModelConfig, seed: int = 0, *, device=None):
    """Random weights drawn on ``device`` from one generator seeded with
    ``seed`` (fp32 draws, cast to ``cfg.dtype``)."""
    _check_dense(cfg)
    device = resolve_device(device)
    dt = torch_dtype(cfg.dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    params: dict[str, Any] = {
        "embed": module.embed_init(gen, cfg.vocab_size, cfg.d_model, dt,
                                   device),
        "final_norm": module.rmsnorm_init(cfg.d_model, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = module.dense_init(gen, cfg.d_model, cfg.vocab_size,
                                              dt, device)
    params["blocks"] = [_init_attn_block(gen, cfg, device)
                        for _ in range(cfg.num_layers)]
    return params


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------

def _attn_block_apply(p, cfg: ModelConfig, x, positions, attn_impl):
    y = attention.self_attention(p["attn"], cfg,
                                 module.rmsnorm(p["ln1"], x, cfg.norm_eps),
                                 positions, attn_impl=attn_impl)
    x = x + y
    h = module.rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + ffn.mlp(p["mlp"], cfg, h)


def unembedding_matrix(params, cfg: ModelConfig):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _unembed(params, cfg: ModelConfig, x):
    x = module.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return (x @ unembedding_matrix(params, cfg)).float()


def _default_positions(b, s, device):
    return torch.arange(s, dtype=torch.int32, device=device)[None, :].expand(b, s)


def lm_apply(params, cfg: ModelConfig, tokens, *, positions=None,
             return_features: bool = False, attn_impl: str = "kernel"):
    """Full-sequence causal forward.  Returns (logits fp32, aux dict) — or,
    with ``return_features``, the final-norm hidden states (B, S, D).
    Differentiable with respect to the param tensors.  ``attn_impl``:
    ``"kernel"`` (flash attention; masks by index, so ``positions`` must be
    left to the default 0..S-1) or ``"ref"`` (plain ``attend``)."""
    _check_dense(cfg)
    if positions is not None and attn_impl == "kernel":
        raise ValueError("lm_apply: explicit positions need attn_impl='ref' "
                         "(the flash kernel masks by sequence index)")
    x = params["embed"][tokens]
    b, s, _ = x.shape
    if positions is None:
        positions = _default_positions(b, s, x.device)
    for lp in params["blocks"]:
        x = _attn_block_apply(lp, cfg, x, positions, attn_impl)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    aux = {"load_balance_loss": zero, "router_z_loss": zero}
    if return_features:
        return module.rmsnorm(params["final_norm"], x, cfg.norm_eps), aux
    return _unembed(params, cfg, x), aux


def _last_position_logits(params, cfg: ModelConfig, x, valid):
    """Unembed only each row's last valid position -> (B, V) fp32."""
    b, s, _ = x.shape
    if valid is None:
        last = torch.full((b,), s - 1, dtype=torch.int64, device=x.device)
    else:
        last = torch.clamp(valid.sum(dim=1) - 1, min=0)
    x_last = torch.gather(x, 1, last[:, None, None].expand(b, 1, x.shape[2]))
    x_last = module.rmsnorm(params["final_norm"], x_last, cfg.norm_eps)[:, 0]
    return (x_last @ unembedding_matrix(params, cfg)).float()
