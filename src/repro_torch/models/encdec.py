"""Encoder-decoder transformer backbone (Seamless-M4T-medium, ``audio``):
the port of the JAX package's ``models/encdec.py``.

The audio frontend (mel + conv feature extractor) is a stub, as in the
reference: the encoder consumes precomputed frame embeddings ``(B, T, D)``.
The encoder is a stack of non-causal self-attention blocks with RoPE over
frame positions 0..T-1; the decoder is a causal stack whose blocks add a
cross-attention over the encoder's output between self-attention and MLP
(norms ``ln1``, ``ln2``, ``ln3``).  Cross K/V are computed once per
sequence (``_cross_kv``) and carried in the cache for decode.  Cross
attention has no RoPE and no qk-norm, and every frame is visible.

As in ``transformer.py``, ``params["encoder"]`` and ``params["decoder"]``
are lists of per-layer dicts (the reference stacks them on a leading axis;
``convert`` maps one onto the other) and the cache (``EncDecCache``) is
written in place.  ``attn_impl`` ("kernel" | "ref"):

* the encoder's self-attention runs the flash kernels with
  ``causal=False`` (or plain ``attend`` with every key visible);
* the decoder's self-attention runs causal flash in ``encdec_apply`` and
  the decode-attention kernel in ``encdec_decode_step``;
* the decoder's prefill self-attention and every cross-attention run plain
  ``attend`` in both (the flash kernel takes one S for queries and keys).

Entry points:
    init_encdec(cfg, seed, device=)                          -> params
    init_dec_cache(cfg, batch, max_len, enc_frames, device)  -> EncDecCache
    encdec_apply(params, cfg, frames, tokens, ...)           -> (logits fp32, aux)
    encdec_prefill(params, cfg, frames, tokens, cache, ...)  -> (logits (B, V), cache)
    encdec_decode_step(params, cfg, token, pos, cache, ...)  -> (logits (B, V), cache)
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.device import generator, resolve_device, torch_dtype
from repro_torch.models import attention, ffn, module
from repro_torch.models.attention import KVCache
from repro_torch.models.config import ModelConfig
from repro_torch.models import sharding as shd
from repro_torch.models.sharding import constrain_activation
from repro_torch.models.transformer import remat_block

_IMPLS = ("kernel", "ref")


def _check(cfg: ModelConfig, attn_impl: str) -> None:
    if cfg.family != "audio":
        raise ValueError(f"encdec: family {cfg.family!r} is not the enc-dec (audio)")
    if attn_impl not in _IMPLS:
        raise ValueError(f"unknown attn_impl {attn_impl!r} (expected kernel | ref)")


def _init_enc_layer(gen: torch.Generator, cfg: ModelConfig, device):
    return {
        "ln1": module.rmsnorm_init(cfg.d_model, device),
        "ln2": module.rmsnorm_init(cfg.d_model, device),
        "attn": attention.init_attention(gen, cfg, device),
        "mlp": ffn.init_mlp(gen, cfg, device),
    }


def _init_dec_layer(gen: torch.Generator, cfg: ModelConfig, device):
    return {
        "ln1": module.rmsnorm_init(cfg.d_model, device),
        "ln2": module.rmsnorm_init(cfg.d_model, device),
        "ln3": module.rmsnorm_init(cfg.d_model, device),
        "attn": attention.init_attention(gen, cfg, device),
        "cross": attention.init_attention(gen, cfg, device, cross=True),
        "mlp": ffn.init_mlp(gen, cfg, device),
    }


def init_encdec(cfg: ModelConfig, seed: int = 0, *, device=None):
    """Random weights drawn on ``device`` from one generator seeded with
    ``seed`` (fp32 draws, cast to ``cfg.dtype``)."""
    _check(cfg, "ref")
    device = resolve_device(device)
    dt = torch_dtype(cfg.dtype)
    gen = generator(device, seed)
    return {
        "embed": module.embed_init(gen, cfg.vocab_size, cfg.d_model, dt, device),
        "lm_head": module.dense_init(gen, cfg.d_model, cfg.vocab_size, dt, device),
        "enc_norm": module.rmsnorm_init(cfg.d_model, device),
        "final_norm": module.rmsnorm_init(cfg.d_model, device),
        "encoder": [_init_enc_layer(gen, cfg, device)
                    for _ in range(cfg.num_encoder_layers)],
        "decoder": [_init_dec_layer(gen, cfg, device) for _ in range(cfg.num_layers)],
    }


def _positions(b: int, s: int, device):
    return torch.arange(s, dtype=torch.int32, device=device)[None, :].expand(b, s)


def _enc_layer(lp, cfg: ModelConfig, x, positions, attn_impl):
    if shd.ON_DTENSORS:
        lp = shd.gather_fsdp(lp)
    x = constrain_activation(x)
    x = shd.residual(x, attention.self_attention(
        lp["attn"], cfg, module.rmsnorm(lp["ln1"], x, cfg.norm_eps), positions,
        causal=False, window=None, attn_impl=attn_impl))
    return shd.residual(x, ffn.mlp(lp["mlp"], cfg, module.rmsnorm(lp["ln2"], x, cfg.norm_eps)))


def encode(params, cfg: ModelConfig, frames, *, attn_impl: str = "kernel",
           remat: bool = False):
    """frames: (B, T, D) stubbed frontend output -> memory (B, T, D).
    ``remat``: every layer under ``transformer.remat_block``."""
    _check(cfg, attn_impl)
    x = frames.to(torch_dtype(cfg.dtype))
    b, t, _ = x.shape
    positions = shd.batched(x, lambda n: _positions(n, t, x.device))
    layer = remat_block(_enc_layer, remat)
    for lp in params["encoder"]:
        x = layer(lp, cfg, x, positions, attn_impl)
    return module.rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def _cross_kv(params, cfg: ModelConfig, memory):
    """Cross K/V of every decoder layer: (L, B, T, KV, hd) each."""
    ks, vs = zip(*(attention.cross_kv(
        shd.gather_fsdp(lp["cross"]) if shd.ON_DTENSORS else lp["cross"], cfg, memory)
        for lp in params["decoder"]))
    return torch.stack(ks), torch.stack(vs)


def _cross_attend(lp, cfg: ModelConfig, x, ck, cv):
    """x: (B, S, D) against one layer's cross K/V: every frame visible."""
    return attention.cross_attend(lp["cross"], cfg, x, ck, cv)


class EncDecCache(NamedTuple):
    """The decoder's cache: its self-attention ``KVCache`` stacked over the
    decoder layers (the reference's ``"self"``) and the cross K/V of every
    layer, (L, B, T, KV, hd) each, written by ``encdec_prefill``."""
    self_kv: KVCache
    cross_k: torch.Tensor
    cross_v: torch.Tensor

    def rows(self, lo: int, hi: int) -> "EncDecCache":
        """Views of batch rows ``lo:hi`` of every layer."""
        return EncDecCache(self.self_kv.rows(lo, hi), self.cross_k[:, lo:hi],
                           self.cross_v[:, lo:hi])


def init_dec_cache(cfg: ModelConfig, batch: int, max_len: int, enc_frames: int,
                   device) -> EncDecCache:
    shape = (cfg.num_layers, batch, enc_frames, cfg.num_kv_heads, cfg.resolved_head_dim)
    dt = torch_dtype(cfg.dtype)
    return EncDecCache(attention.init_kv_cache(cfg, batch, max_len, device),
                       torch.zeros(shape, dtype=dt, device=device),
                       torch.zeros(shape, dtype=dt, device=device))


def _dec_layer(lp, cfg: ModelConfig, x, ck, cv, *, positions=None, cache=None,
               pos=None, mode: str = "full", attn_impl: str = "kernel"):
    """One decoder block: ``mode`` "full" (causal self-attention over x),
    "prefill" (the same through plain ``attend``, writing ``cache``, one
    layer's view) or "decode" (one token at ``pos``)."""
    if shd.ON_DTENSORS:
        lp = shd.gather_fsdp(lp)
    h = module.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    if mode == "full":
        y = attention.self_attention(lp["attn"], cfg, h, positions, window=None,
                                     attn_impl=attn_impl)
    elif mode == "prefill":
        y, _ = attention.prefill_attention(lp["attn"], cfg, h, positions, cache,
                                           window=None)
    else:
        y, _ = attention.decode_attention(lp["attn"], cfg, h, pos, cache, window=None,
                                          attn_impl=attn_impl)
    x = shd.residual(x, y)
    x = shd.residual(x, _cross_attend(lp, cfg, module.rmsnorm(lp["ln2"], x, cfg.norm_eps),
                                      ck, cv))
    return shd.residual(x, ffn.mlp(lp["mlp"], cfg, module.rmsnorm(lp["ln3"], x, cfg.norm_eps)))


def _logits(params, cfg: ModelConfig, x):
    head = shd.gather_fsdp(params["lm_head"]) if shd.ON_DTENSORS else params["lm_head"]
    return (module.rmsnorm(params["final_norm"], x, cfg.norm_eps) @ head).float()


def _embed(params, tokens, reduced: bool):
    """The tokens' embeddings; on the partitioned step a vocab-parallel
    lookup, its partial sums reduced where ``reduced``."""
    if not shd.ON_DTENSORS:
        return params["embed"][tokens]
    x = shd.embed_lookup(params["embed"], tokens)
    return shd.batch_only(x) if reduced else x


def _dec_layer_full(lp, cfg: ModelConfig, x, ck, cv, positions, attn_impl):
    return _dec_layer(lp, cfg, constrain_activation(x), ck, cv, positions=positions,
                      attn_impl=attn_impl)


def encdec_apply(params, cfg: ModelConfig, frames, tokens, *,
                 return_features: bool = False, attn_impl: str = "kernel",
                 remat: bool = False):
    """Teacher-forcing forward.  Returns (logits fp32 (B, S, V), aux: zero
    router losses) — or, with ``return_features``, the final-norm hidden
    states (B, S, D).  Differentiable with respect to the param tensors.
    ``remat``: every encoder and decoder layer under
    ``transformer.remat_block``."""
    _check(cfg, attn_impl)
    memory = encode(params, cfg, frames, attn_impl=attn_impl, remat=remat)
    ck_all, cv_all = _cross_kv(params, cfg, memory)
    x = _embed(params, tokens, reduced=False)
    b, s, _ = x.shape
    positions = shd.batched(x, lambda n: _positions(n, s, x.device))
    layer = remat_block(_dec_layer_full, remat)
    for i, lp in enumerate(params["decoder"]):
        x = layer(lp, cfg, x, ck_all[i], cv_all[i], positions, attn_impl)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    aux = {"load_balance_loss": zero, "router_z_loss": zero}
    if return_features:
        return module.rmsnorm(params["final_norm"], x, cfg.norm_eps), aux
    return _logits(params, cfg, x), aux


def encdec_prefill(params, cfg: ModelConfig, frames, tokens, cache: EncDecCache, *,
                   attn_impl: str = "kernel"):
    """Encode ``frames``, write the cross K/V and the decoder's self cache
    (in place) for ``tokens`` (B, S) at positions 0..S-1.  Returns (the
    logits of position S-1 (B, V) fp32, cache): the last position whatever
    a caller's ``valid`` says, as in the reference."""
    _check(cfg, attn_impl)
    memory = encode(params, cfg, frames, attn_impl=attn_impl)
    ck_all, cv_all = _cross_kv(params, cfg, memory)
    if ck_all.shape != cache.cross_k.shape:
        raise ValueError(f"encdec_prefill: cross K/V {tuple(ck_all.shape)} from "
                         f"{tuple(frames.shape)} frames, cache holds "
                         f"{tuple(cache.cross_k.shape)}")
    if shd.ON_DTENSORS:
        shd.assign(cache.cross_k, ck_all)
        shd.assign(cache.cross_v, cv_all)
    else:
        cache.cross_k.copy_(ck_all)
        cache.cross_v.copy_(cv_all)
    del ck_all, cv_all
    x = _embed(params, tokens, reduced=True)
    b, s, _ = x.shape
    positions = shd.batched(x, lambda n: _positions(n, s, x.device))
    for i, lp in enumerate(params["decoder"]):
        x = _dec_layer(lp, cfg, x, cache.cross_k[i], cache.cross_v[i],
                       positions=positions, cache=cache.self_kv.layer(i), mode="prefill")
    return _logits(params, cfg, x[:, -1]), cache


def encdec_decode_step(params, cfg: ModelConfig, token, pos, cache: EncDecCache, *,
                       attn_impl: str = "kernel"):
    """One decoder token per row (token/pos: (B,) int) over the cross K/V
    in the cache; writes the self cache in place.  Returns (logits (B, V)
    fp32, cache)."""
    _check(cfg, attn_impl)
    x = _embed(params, token, reduced=True)[:, None, :]
    for i, lp in enumerate(params["decoder"]):
        x = _dec_layer(lp, cfg, x, cache.cross_k[i], cache.cross_v[i], pos=pos,
                       cache=cache.self_kv.layer(i), mode="decode", attn_impl=attn_impl)
    return _logits(params, cfg, x)[:, 0, :], cache
