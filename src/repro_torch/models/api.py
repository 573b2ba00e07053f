"""Uniform model API over the six families: dense, MoE, RWKV-6 (``ssm``),
RecurrentGemma (``hybrid``), PaliGemma (``vlm``) and Seamless-M4T
(``audio``, the enc-dec) — the port's counterpart of the JAX package's
``models/api.py``.

    api = get_api(cfg, device=)            # the card unless device= says otherwise
    params = api.init(seed)
    logits, aux = api.apply(params, batch, attn_impl=, scan_impl=, moe_mode=)
    cache = api.init_cache(batch_size, max_len)          # KVCache | RWKVState | HybridCache
    logits, cache = api.prefill(params, batch, cache, attn_impl=, moe_mode=)
    logits, cache = api.decode_step(params, token, pos, cache, attn_impl=, moe_mode=)

``batch`` is a dict: ``tokens`` (B, S) int for every family, ``patches``
(B, P, D) for the VLM (stubbed vision embeddings, optional: they go before
the tokens, and a VLM's cache holds ``num_image_tokens`` positions more
than ``max_len``), ``frames`` (B, T, D) for the enc-dec (stubbed audio
frontend output, required), ``valid`` (B, S) for a prefill.

``attn_impl`` is "kernel" | "ref"; ``moe_mode`` is "ep" (the reference's
capacity dispatch, the default) | "dense" (every expert on every token:
the trainer's mode), and only the MoE family reads it.  The attention
families (dense and MoE) also expose the paged-KV views of the paged
engine:

    cache = api.init_paged_cache(num_pages, page_size, kv_quant=)   # off | int8
    logits, cache = api.prefill_chunk(params, tokens, valid, start, block_row, cache,
                                      moe_mode=)
    logits, cache = api.decode_paged(params, token, pos, cache, block_tables,
                                     attn_impl=, moe_mode=)

Families without a paged KV cache (``ssm``, ``hybrid``, ``vlm``,
``audio``) leave those None: the slot ``DecodeEngine`` serves the first
three (the VLM text-only, as in the reference); the reference has no
engine for the enc-dec, whose path is ``prefill`` / ``decode_step``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models import encdec, paged, transformer
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    device: torch.device
    init: Callable[..., Any]              # (seed) -> params on device
    apply: Callable[..., Any]             # (params, batch, return_features=, attn_impl=, scan_impl=, moe_mode=) -> (logits, aux)
    prefill: Callable[..., Any]           # (params, batch, cache, attn_impl=, moe_mode=) -> (logits, cache)
    decode_step: Callable[..., Any]       # (params, token, pos, cache, attn_impl=, moe_mode=) -> (logits, cache)
    init_cache: Callable[..., Any]        # (batch, max_len) -> KVCache | RWKVState | HybridCache | EncDecCache
    # paged-KV views (None for families without positional KV caches)
    init_paged_cache: Optional[Callable[..., Any]] = None  # (num_pages, page_size, kv_quant=) -> PagedKVCache
    prefill_chunk: Optional[Callable[..., Any]] = None     # (params, tokens, valid, start, block_row, cache, moe_mode=) -> (logits, cache)
    decode_paged: Optional[Callable[..., Any]] = None      # (params, token, pos, cache, block_tables, attn_impl=, moe_mode=) -> (logits, cache)
    cache_view: Optional[Callable[..., Any]] = None        # (layer_pages, block_row) -> (k, v, valid)


def get_api(cfg: ModelConfig, *, device=None) -> ModelAPI:
    if cfg.family != "audio" and cfg.family not in transformer.FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r} "
                         f"({' | '.join(transformer.FAMILIES + ('audio',))})")
    device = resolve_device(device)
    if cfg.family == "audio":
        return _encdec_api(cfg, device)

    def init(seed: int = 0):
        return transformer.init_lm(cfg, seed, device=device)

    def apply(params, batch, *, return_features=False, attn_impl="kernel",
              scan_impl=None, moe_mode="ep"):
        return transformer.lm_apply(params, cfg, batch["tokens"],
                                    prefix_embeds=batch.get("patches"),
                                    return_features=return_features,
                                    attn_impl=attn_impl, scan_impl=scan_impl,
                                    moe_mode=moe_mode)

    def prefill(params, batch, cache, *, attn_impl="kernel", moe_mode="ep"):
        return transformer.lm_prefill(params, cfg, batch["tokens"], cache,
                                      prefix_embeds=batch.get("patches"),
                                      valid=batch.get("valid"),
                                      attn_impl=attn_impl, moe_mode=moe_mode)

    def decode_step(params, token, pos, cache, *, attn_impl="kernel",
                    moe_mode="ep"):
        return transformer.lm_decode_step(params, cfg, token, pos, cache,
                                          attn_impl=attn_impl, moe_mode=moe_mode)

    def init_cache(batch, max_len):
        extra = cfg.num_image_tokens if cfg.family == "vlm" else 0
        return transformer.init_cache(cfg, batch, max_len + extra, device)

    if not paged.supports_paged(cfg):
        return ModelAPI(cfg, device, init, apply, prefill, decode_step,
                        init_cache)

    def init_paged_cache(num_pages, page_size, kv_quant="off"):
        return paged.init_paged_cache(cfg, num_pages, page_size,
                                      kv_quant=kv_quant, device=device)

    def prefill_chunk(params, tokens, valid, start, block_row, cache, *,
                      moe_mode="ep"):
        return paged.paged_prefill_chunk(params, cfg, tokens, valid, start,
                                         block_row, cache, moe_mode=moe_mode)

    def decode_paged(params, token, pos, cache, block_tables, *,
                     attn_impl="kernel", moe_mode="ep"):
        return paged.paged_decode_step(params, cfg, token, pos, cache,
                                       block_tables, attn_impl=attn_impl,
                                       moe_mode=moe_mode)

    return ModelAPI(cfg, device, init, apply, prefill, decode_step, init_cache,
                    init_paged_cache=init_paged_cache,
                    prefill_chunk=prefill_chunk, decode_paged=decode_paged,
                    cache_view=paged.gather_request_view)


def _encdec_api(cfg: ModelConfig, device) -> ModelAPI:
    """The enc-dec's API (reference ``api.py:50-68``): ``batch["frames"]``
    goes through the encoder; ``valid`` is not read (prefill logits are
    the last position's).  No paged views."""
    def init(seed: int = 0):
        return encdec.init_encdec(cfg, seed, device=device)

    def apply(params, batch, *, return_features=False, attn_impl="kernel",
              scan_impl=None, moe_mode="ep"):
        del scan_impl, moe_mode      # no scans; the backbone is dense
        return encdec.encdec_apply(params, cfg, batch["frames"], batch["tokens"],
                                   return_features=return_features,
                                   attn_impl=attn_impl)

    def prefill(params, batch, cache, *, attn_impl="kernel", moe_mode="ep"):
        del moe_mode
        return encdec.encdec_prefill(params, cfg, batch["frames"], batch["tokens"],
                                     cache, attn_impl=attn_impl)

    def decode_step(params, token, pos, cache, *, attn_impl="kernel", moe_mode="ep"):
        del moe_mode
        return encdec.encdec_decode_step(params, cfg, token, pos, cache,
                                         attn_impl=attn_impl)

    def init_cache(batch, max_len):
        return encdec.init_dec_cache(cfg, batch, max_len, cfg.encoder_frames, device)

    return ModelAPI(cfg, device, init, apply, prefill, decode_step, init_cache)
