"""Decoder-only LM assembly, dense and RWKV-6 (``ssm``) families.

The JAX package stacks the layers on a leading axis and runs them with
``lax.scan``; here ``params["blocks"]`` is a list of per-layer dicts walked
by a Python loop, and the slot engine's caches (``attention.KVCache``,
``rwkv6.RWKVState``) are stacked on a leading layer axis and updated in
place, one layer's view at a time.  Other families (MoE, RG-LRU, VLM,
enc-dec) are later slices of the port.

Entry points:
    init_lm(cfg, seed, device=)                   -> params
    init_cache(cfg, batch, max_len, device)       -> KVCache | RWKVState
    lm_apply(params, cfg, tokens, ...)            -> (logits fp32, aux)
    lm_prefill(params, cfg, tokens, cache, ...)   -> (last logits (B, V), cache)
    lm_decode_step(params, cfg, token, pos, cache, attn_impl=) -> (logits (B, V), cache)

``attn_impl`` ("kernel" | "ref") picks the dense family's attention
kernels and the RWKV-6 family's WKV scan kernel against their plain
versions.  Quantized trees (``quant.quantize_params``) are dequantized one
layer at a time inside the layer loops.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models import attention, ffn, module, rwkv6
from repro_torch.models.config import ModelConfig
from repro_torch.quant import core as quant

FAMILIES = ("dense", "ssm")     # the families ported so far
_IMPLS = ("kernel", "ref")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet ({' | '.join(FAMILIES)})")


def _check_impl(attn_impl: str) -> None:
    if attn_impl not in _IMPLS:
        raise ValueError(f"unknown attn_impl {attn_impl!r} (expected kernel | ref)")


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
    _check_family(cfg)
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
    init_block = _init_attn_block if cfg.family == "dense" else rwkv6.init_block
    params["blocks"] = [init_block(gen, cfg, device)
                        for _ in range(cfg.num_layers)]
    return params


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device):
    """The slot engine's cache: dense -> ``KVCache``; ssm -> ``RWKVState``."""
    _check_family(cfg)
    if cfg.family == "dense":
        return attention.init_kv_cache(cfg, batch, max_len, device)
    return rwkv6.init_rwkv_state(cfg, batch, device)


def layers(params):
    """(index, per-layer params), each dequantized just before its layer
    runs when the tree holds quantized weights: only one layer's
    full-precision weights exist at once.  An unquantized tree is walked as
    it is."""
    blocks = params["blocks"]
    if not (blocks and quant.is_quantized_tree(blocks[0])):
        return enumerate(blocks)
    return ((i, quant.dequantize_params(lp)) for i, lp in enumerate(blocks))


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


def _attn_block_prefill(p, cfg: ModelConfig, x, positions, cache, *, valid=None):
    y, _ = attention.prefill_attention(
        p["attn"], cfg, module.rmsnorm(p["ln1"], x, cfg.norm_eps), positions,
        cache, valid=valid)
    x = x + y
    return x + ffn.mlp(p["mlp"], cfg, module.rmsnorm(p["ln2"], x, cfg.norm_eps))


def _attn_block_decode(p, cfg: ModelConfig, x, pos, cache, *, attn_impl):
    y, _ = attention.decode_attention(
        p["attn"], cfg, module.rmsnorm(p["ln1"], x, cfg.norm_eps), pos, cache,
        attn_impl=attn_impl)
    x = x + y
    return x + ffn.mlp(p["mlp"], cfg, module.rmsnorm(p["ln2"], x, cfg.norm_eps))


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
    Dense: differentiable with respect to the param tensors; ``attn_impl``
    ``"kernel"`` (flash attention; masks by index, so ``positions`` must be
    left to the default 0..S-1) or ``"ref"`` (plain ``attend``).  RWKV-6:
    every block from a zero state, the WKV scan kernel or its plain version
    (``attn_impl``); ``positions`` are unused."""
    _check_family(cfg)
    _check_impl(attn_impl)
    if positions is not None and attn_impl == "kernel" and cfg.family == "dense":
        raise ValueError("lm_apply: explicit positions need attn_impl='ref' "
                         "(the flash kernel masks by sequence index)")
    x = params["embed"][tokens]
    b, s, _ = x.shape
    if cfg.family == "dense":
        if positions is None:
            positions = _default_positions(b, s, x.device)
        for lp in params["blocks"]:
            x = _attn_block_apply(lp, cfg, x, positions, attn_impl)
    else:
        state0 = rwkv6.init_rwkv_state(cfg, b, x.device)
        for i, lp in enumerate(params["blocks"]):
            x, _ = rwkv6.block(lp, cfg, x, state0.layer(i), attn_impl=attn_impl)
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


def lm_prefill(params, cfg: ModelConfig, tokens, cache, *, valid=None,
               attn_impl: str = "kernel"):
    """Causal forward that fills ``cache`` (in place).

    tokens: (B, S); ``valid`` (B, S) marks real (non-pad) token positions,
    meaningful for the dense family only: the recurrent state ingests every
    position, so RWKV-6 prompts must be prefilled at their exact length.
    Dense prefill runs plain ``attend`` (as the reference); ``attn_impl``
    picks the RWKV-6 scan.  Returns (last-valid-position logits (B, V)
    fp32, cache)."""
    _check_family(cfg)
    _check_impl(attn_impl)
    x = params["embed"][tokens]
    b, s, _ = x.shape
    if cfg.family == "dense":
        positions = _default_positions(b, s, x.device)
        for i, lp in layers(params):
            x = _attn_block_prefill(lp, cfg, x, positions, cache.layer(i),
                                    valid=valid)
    else:
        for i, lp in layers(params):
            x, st = rwkv6.block(lp, cfg, x, cache.layer(i), attn_impl=attn_impl)
            cache.write_layer(i, st)
    return _last_position_logits(params, cfg, x, valid), cache


def lm_decode_step(params, cfg: ModelConfig, token, pos, cache, *,
                   attn_impl: str = "kernel"):
    """One-token decode for every row. token/pos: (B,) int.  Updates
    ``cache`` in place and returns (logits (B, V) fp32, cache)."""
    _check_family(cfg)
    _check_impl(attn_impl)
    x = params["embed"][token][:, None, :]
    if cfg.family == "dense":
        for i, lp in layers(params):
            x = _attn_block_decode(lp, cfg, x, pos, cache.layer(i),
                                   attn_impl=attn_impl)
    else:
        for i, lp in layers(params):
            x, st = rwkv6.block(lp, cfg, x, cache.layer(i), attn_impl=attn_impl)
            cache.write_layer(i, st)
    return _unembed(params, cfg, x)[:, 0, :], cache
