"""Decoder-only LM assembly: the dense, MoE, RWKV-6 (``ssm``),
RecurrentGemma (``hybrid``: RG-LRU + local attention) and PaliGemma
(``vlm``) families.

The JAX package stacks the layers on a leading axis and runs them with
``lax.scan`` (the hybrid: a scan over pattern groups, then an unrolled
tail); here ``params["blocks"]`` is a list of per-layer dicts in execution
order (the hybrid: group g's pattern positions for every g, then the
tail) walked by a Python loop, and the slot engine's caches
(``attention.KVCache``, ``rwkv6.RWKVState``, ``HybridCache``) are stacked
on a leading layer axis and updated in place, one layer's view at a time.
An MoE layer is an attention block whose MLP is ``moe.moe_apply``
(``moe_mode`` "ep" | "dense"); ``lm_apply`` returns its router losses
averaged over the layers.  A VLM is a dense stack whose token embeddings
are scaled by sqrt(d_model) (Gemma's scale, rounded to the activation
dtype first, as in the reference) and, in ``lm_apply`` / ``lm_prefill``,
preceded by ``prefix_embeds`` (the stubbed vision frontend's patch
embeddings).  The enc-dec family is ``encdec.py``.

Entry points:
    init_lm(cfg, seed, device=)                   -> params
    init_cache(cfg, batch, max_len, device)       -> KVCache | RWKVState | HybridCache
    lm_apply(params, cfg, tokens, prefix_embeds=, ...)          -> (logits fp32, aux)
    lm_prefill(params, cfg, tokens, cache, prefix_embeds=, ...) -> (last logits (B, V), cache)
    lm_decode_step(params, cfg, token, pos, cache, attn_impl=) -> (logits (B, V), cache)

``lm_apply``, ``lm_prefill`` and ``lm_decode_step`` take ``moe_mode``
(default "ep", the reference's capacity dispatch; the trainer passes
"dense").

``attn_impl`` ("kernel" | "ref") picks the dense and MoE families' attention
kernels, the RWKV-6 family's WKV scan kernel, and the hybrid's RG-LRU scan,
flash and decode-attention kernels against their plain versions
(``lm_apply`` takes the scans' choice apart, as ``scan_impl``).  Quantized
trees (``quant.quantize_params``, with ``block_groups(cfg)``) are
dequantized one layer at a time inside the layer loops.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import generator, resolve_device, torch_dtype
from repro_torch.models import attention, ffn, moe, module, rglru, rwkv6
from repro_torch.models.config import ModelConfig
from repro_torch.models import sharding as shd
from repro_torch.models.sharding import constrain_activation
from repro_torch.quant import core as quant

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")   # the decoder-only families
ATTENTION_FAMILIES = ("dense", "moe", "vlm")          # every layer an attention block
_IMPLS = ("kernel", "ref")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"family {cfg.family!r} is not a decoder-only LM "
                         f"({' | '.join(FAMILIES)}); the enc-dec is models/encdec.py")


def _check_impl(attn_impl: str) -> None:
    if attn_impl not in _IMPLS:
        raise ValueError(f"unknown attn_impl {attn_impl!r} (expected kernel | ref)")


def _init_attn_block(gen: torch.Generator, cfg: ModelConfig, device):
    p = {
        "ln1": module.rmsnorm_init(cfg.d_model, device),
        "ln2": module.rmsnorm_init(cfg.d_model, device),
        "attn": attention.init_attention(gen, cfg, device),
    }
    if cfg.is_moe:
        p["moe"] = moe.init_moe(gen, cfg, device)
    else:
        p["mlp"] = ffn.init_mlp(gen, cfg, device)
    return p


def _init_rglru_block(gen: torch.Generator, cfg: ModelConfig, device):
    return {
        "ln1": module.rmsnorm_init(cfg.d_model, device),
        "ln2": module.rmsnorm_init(cfg.d_model, device),
        "rec": rglru.init_recurrent_block(gen, cfg, device),
        "mlp": ffn.init_mlp(gen, cfg, device),
    }


def _hybrid_layout(cfg: ModelConfig):
    pattern = cfg.block_pattern
    n_groups = cfg.num_layers // len(pattern)
    tail = tuple(pattern[: cfg.num_layers - n_groups * len(pattern)])
    return pattern, n_groups, tail


def indexed_kinds(kinds) -> Tuple[Tuple[str, int], ...]:
    """Each kind with its index among the earlier entries of that kind."""
    seen: dict = {}
    out = []
    for k in kinds:
        out.append((k, seen.get(k, 0)))
        seen[k] = seen.get(k, 0) + 1
    return tuple(out)


def layer_kinds(cfg: ModelConfig) -> Tuple[Tuple[str, int], ...]:
    """Per layer in execution order: (kind, its index among the layers of
    that kind), kind "attn" | "rglru" (the hybrid) — or the dense / MoE /
    RWKV-6 layer kind for every layer."""
    if cfg.family == "hybrid":
        pattern, n_groups, tail = _hybrid_layout(cfg)
        return indexed_kinds([k for _ in range(n_groups) for k in pattern] + list(tail))
    kind = "attn" if cfg.family in ATTENTION_FAMILIES else "rwkv"
    return indexed_kinds([kind] * cfg.num_layers)


def block_groups(cfg: ModelConfig) -> Optional[list]:
    """For each entry of ``blocks``, the reference's stacked leaf it belongs
    to: the hybrid's pattern position ``i`` (its ``blocks["{i}_{kind}"]``,
    stacked over the groups), or None for the tail (a Python list).  Other
    families: None (one stack of every layer).  These are the reference's
    quantization scale groups (``quant.quantize_params``'s ``groups``: the
    tail stays unquantized) and its param layout (``convert``)."""
    if cfg.family != "hybrid":
        return None
    pattern, n_groups, tail = _hybrid_layout(cfg)
    return list(range(len(pattern))) * n_groups + [None] * len(tail)


def init_lm(cfg: ModelConfig, seed: int = 0, *, device=None):
    """Random weights drawn on ``device`` from one generator seeded with
    ``seed`` (fp32 draws, cast to ``cfg.dtype``)."""
    _check_family(cfg)
    device = resolve_device(device)
    dt = torch_dtype(cfg.dtype)
    gen = generator(device, seed)
    params: dict[str, Any] = {
        "embed": module.embed_init(gen, cfg.vocab_size, cfg.d_model, dt,
                                   device),
        "final_norm": module.rmsnorm_init(cfg.d_model, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = module.dense_init(gen, cfg.d_model, cfg.vocab_size,
                                              dt, device)
    init_block = {"attn": _init_attn_block, "rwkv": rwkv6.init_block,
                  "rglru": _init_rglru_block}
    params["blocks"] = [init_block[kind](gen, cfg, device)
                        for kind, _ in layer_kinds(cfg)]
    return params


class HybridCache(NamedTuple):
    """The hybrid's slot cache: a ``KVCache`` stacked over its attention
    layers, an ``RGLRUState`` stacked over its RG-LRU layers, and per layer
    in execution order (kind, index into the stack of that kind)."""
    kv: attention.KVCache
    rglru: rglru.RGLRUState
    kinds: Tuple[Tuple[str, int], ...]

    def rows(self, lo: int, hi: int) -> "HybridCache":
        """Views of batch rows ``lo:hi`` of every layer."""
        return HybridCache(self.kv.rows(lo, hi), self.rglru.rows(lo, hi), self.kinds)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device):
    """The slot engine's cache: dense / MoE -> ``KVCache``; ssm ->
    ``RWKVState``; hybrid -> ``HybridCache``."""
    _check_family(cfg)
    if cfg.family in ATTENTION_FAMILIES:
        return attention.init_kv_cache(cfg, batch, max_len, device)
    if cfg.family == "ssm":
        return rwkv6.init_rwkv_state(cfg, batch, device)
    kinds = layer_kinds(cfg)
    n_attn = sum(k == "attn" for k, _ in kinds)
    return HybridCache(
        attention.init_kv_cache(cfg, batch, max_len, device, num_layers=n_attn),
        rglru.init_rglru_state(cfg, batch, device, num_layers=len(kinds) - n_attn),
        kinds)


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

def mlp_residual(p, cfg: ModelConfig, x, y, moe_mode: str = "ep"):
    """``x + y``, then the block's MLP (or MoE, every token routed: padding
    and masked lanes take expert capacity, as in the reference) on its
    norm, added back.  Returns (x, aux: the MoE's router losses, or
    None)."""
    x = shd.residual(x, y)
    h = module.rmsnorm(p["ln2"], x, cfg.norm_eps)
    if cfg.is_moe:
        y, aux = moe.moe_apply(p["moe"], cfg, h, mode=moe_mode)
        return shd.residual(x, y), aux
    return shd.residual(x, ffn.mlp(p["mlp"], cfg, h)), None


def _attn_block_apply(p, cfg: ModelConfig, x, positions, attn_impl, moe_mode="ep"):
    if shd.ON_DTENSORS:
        p = shd.gather_fsdp(p)
    x = constrain_activation(x)
    y = attention.self_attention(p["attn"], cfg,
                                 module.rmsnorm(p["ln1"], x, cfg.norm_eps),
                                 positions, attn_impl=attn_impl)
    return mlp_residual(p, cfg, x, y, moe_mode)


def _attn_block_prefill(p, cfg: ModelConfig, x, positions, cache, *, valid=None,
                        moe_mode="ep"):
    if shd.ON_DTENSORS:
        p = shd.gather_fsdp(p)
    y, _ = attention.prefill_attention(
        p["attn"], cfg, module.rmsnorm(p["ln1"], x, cfg.norm_eps), positions,
        cache, valid=valid)
    return mlp_residual(p, cfg, x, y, moe_mode)[0]


def _attn_block_decode(p, cfg: ModelConfig, x, pos, cache, *, attn_impl,
                       moe_mode="ep"):
    if shd.ON_DTENSORS:
        p = shd.gather_fsdp(p)
    y, _ = attention.decode_attention(
        p["attn"], cfg, module.rmsnorm(p["ln1"], x, cfg.norm_eps), pos, cache,
        attn_impl=attn_impl)
    return mlp_residual(p, cfg, x, y, moe_mode)[0]


def _rglru_block_apply(p, cfg: ModelConfig, x, state, *, decode: bool, attn_impl):
    if shd.ON_DTENSORS:
        p = shd.gather_fsdp(p)
    if not decode:
        x = constrain_activation(x)
    fn = rglru.recurrent_step if decode else rglru.recurrent_block
    y, state = fn(p["rec"], cfg, module.rmsnorm(p["ln1"], x, cfg.norm_eps), state,
                  attn_impl=attn_impl)
    x = shd.residual(x, y)
    x = shd.residual(x, ffn.mlp(p["mlp"], cfg, module.rmsnorm(p["ln2"], x, cfg.norm_eps)))
    return x, state


def _hybrid_layer(lp, cfg: ModelConfig, x, cache: HybridCache, i: int, *,
                  positions=None, pos=None, attn_impl):
    """Layer ``i`` of a hybrid prefill (``positions``) or decode step
    (``pos``), its cache written in place.  Prefill attention runs plain
    ``attend`` and passes no ``valid``, as the reference does."""
    kind, j = cache.kinds[i]
    if kind == "attn":
        if pos is None:
            return _attn_block_prefill(lp, cfg, x, positions, cache.kv.layer(j))
        return _attn_block_decode(lp, cfg, x, pos, cache.kv.layer(j),
                                  attn_impl=attn_impl)
    x, st = _rglru_block_apply(lp, cfg, x, cache.rglru.layer(j),
                               decode=pos is not None, attn_impl=attn_impl)
    cache.rglru.write_layer(j, st)
    return x


def unembedding_matrix(params, cfg: ModelConfig):
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return shd.gather_fsdp(head) if shd.ON_DTENSORS else head


def _unembed(params, cfg: ModelConfig, x):
    x = module.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return (x @ unembedding_matrix(params, cfg)).float()


def _embed(params, cfg: ModelConfig, tokens, prefix_embeds=None):
    """Token embeddings; a VLM's scaled by sqrt(d_model) rounded to their
    dtype first (bf16: 45.25 at d_model 2048), with ``prefix_embeds`` (B,
    P, D) cast to that dtype and put before the tokens."""
    if shd.ON_DTENSORS:
        x = shd.embed_lookup(params["embed"], tokens)
    else:
        x = params["embed"][tokens]
    if cfg.family == "vlm":
        x = x * float(torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype))
        if prefix_embeds is not None:
            x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    return x


def _default_positions(b, s, device):
    return torch.arange(s, dtype=torch.int32, device=device)[None, :].expand(b, s)


def remat_block(fn, remat: bool):
    """``fn`` itself, or with ``remat`` ``fn`` under
    ``torch.utils.checkpoint`` (non-reentrant): its activations are not
    kept for the backward but recomputed there, as the reference's
    ``jax.checkpoint`` of each layer does."""
    if not remat:
        return fn

    def run(*args, **kwargs):
        return checkpoint(fn, *args, use_reentrant=False, **kwargs)

    return run


def _rwkv_block_apply(lp, cfg: ModelConfig, x, state, *, attn_impl):
    return rwkv6.block(lp, cfg, constrain_activation(x), state, attn_impl=attn_impl)


def lm_apply(params, cfg: ModelConfig, tokens, *, positions=None,
             prefix_embeds=None, return_features: bool = False,
             attn_impl: str = "kernel",
             scan_impl: Optional[str] = None, moe_mode: str = "ep",
             remat: bool = False):
    """Full-sequence causal forward.  Returns (logits fp32, aux dict) — or,
    with ``return_features``, the final-norm hidden states (B, S, D); a
    VLM's S counts its ``prefix_embeds`` (P) first.
    Dense, MoE, VLM and the hybrid's attention layers: differentiable with
    respect to the param tensors; ``attn_impl`` ``"kernel"`` (flash
    attention, any group size in either dtype; masks by index, so
    ``positions`` must be left to the default 0..S-1) or ``"ref"`` (plain
    ``attend``).  MoE: the router's
    load-balance and z losses averaged over the layers, through
    ``moe_mode``'s path (dense families: zeros).  RWKV-6:
    every block from a zero state, the WKV scan kernel or its plain version
    (``scan_impl``); ``positions`` are unused.  Hybrid: the RG-LRU layers
    from a zero state through the scan kernel or the reference's doubling
    scan (``scan_impl``); the attention layers as the dense family's, by
    ``attn_impl`` (windowed flash attention or plain ``attend``).  ``scan_impl``
    defaults to ``attn_impl``; the scan kernels have no backward, so a
    forward that is differentiated passes ``"ref"``.  ``remat`` runs every
    block under ``remat_block`` (the train step's memory for compute
    trade); the values are the same either way."""
    scan_impl = attn_impl if scan_impl is None else scan_impl
    _check_family(cfg)
    _check_impl(attn_impl)
    _check_impl(scan_impl)
    if positions is not None and attn_impl == "kernel" and cfg.family != "ssm":
        raise ValueError("lm_apply: explicit positions need attn_impl='ref' "
                         "(the flash kernel masks by sequence index)")
    x = _embed(params, cfg, tokens, prefix_embeds)
    b, s, _ = x.shape
    auxs = []
    if cfg.family in ATTENTION_FAMILIES:
        if positions is None:
            positions = shd.batched(x, lambda n: _default_positions(n, s, x.device))
        block = remat_block(_attn_block_apply, remat)
        for lp in params["blocks"]:
            x, aux = block(lp, cfg, x, positions, attn_impl, moe_mode)
            auxs.append(aux)
    elif cfg.family == "ssm":
        state0 = shd.batched(x, lambda n: rwkv6.init_rwkv_state(cfg, n, x.device), dim=1)
        block = remat_block(_rwkv_block_apply, remat)
        for i, lp in enumerate(params["blocks"]):
            x, _ = block(lp, cfg, x, state0.layer(i), attn_impl=scan_impl)
    else:
        if positions is None:
            positions = shd.batched(x, lambda n: _default_positions(n, s, x.device))
        state0 = shd.batched(x, lambda n: rglru.init_rglru_state(cfg, n, x.device),
                             dim=1).layer(0)
        attn_block = remat_block(_attn_block_apply, remat)
        rglru_block = remat_block(_rglru_block_apply, remat)
        for lp, (kind, _) in zip(params["blocks"], layer_kinds(cfg)):
            if kind == "attn":
                x, _ = attn_block(lp, cfg, x, positions, attn_impl)
            else:
                x, _ = rglru_block(lp, cfg, x, state0, decode=False,
                                   attn_impl=scan_impl)
    if cfg.is_moe:
        aux = {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]}
    else:
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
    if shd.ON_DTENSORS:
        # the hybrid's stream is sequence-parallel: DTensor gathers a
        # sharded dim by masked partials, which not every version reduces
        x = shd.batch_only(x)
    x_last = torch.gather(x, 1, last[:, None, None].expand(b, 1, x.shape[2]))
    x_last = module.rmsnorm(params["final_norm"], x_last, cfg.norm_eps)[:, 0]
    return (x_last @ unembedding_matrix(params, cfg)).float()


def lm_prefill(params, cfg: ModelConfig, tokens, cache, *, prefix_embeds=None,
               valid=None, attn_impl: str = "kernel", moe_mode: str = "ep"):
    """Causal forward that fills ``cache`` (in place).

    tokens: (B, S); a VLM's ``prefix_embeds`` (B, P, D) go first and fill
    cache positions 0..P-1, its tokens P..P+S-1.  ``valid`` (B, S) marks
    real (non-pad) token positions (a VLM's widened over the prefix, which
    is always valid), meaningful for the attention families only (attention masks the
    pads; the MoE routes them all the same, as the reference does): the
    recurrent state ingests every position, so RWKV-6 and hybrid prompts
    must be prefilled at their exact length.  Dense, MoE and hybrid
    attention prefill runs plain ``attend`` (as the reference);
    ``attn_impl`` picks the RWKV-6 and RG-LRU scans.
    Returns (last-valid-position logits (B, V) fp32, cache)."""
    _check_family(cfg)
    _check_impl(attn_impl)
    x = _embed(params, cfg, tokens, prefix_embeds)
    if shd.ON_DTENSORS:
        x = shd.batch_only(x)
    b, s, _ = x.shape
    if valid is not None and valid.shape[1] != s:     # a VLM's image prefix
        valid = torch.cat([torch.ones((b, s - valid.shape[1]), dtype=torch.bool,
                                      device=valid.device), valid.bool()], dim=1)
    if cfg.family in ATTENTION_FAMILIES:
        positions = shd.batched(x, lambda n: _default_positions(n, s, x.device))
        for i, lp in layers(params):
            x = _attn_block_prefill(lp, cfg, x, positions, cache.layer(i),
                                    valid=valid, moe_mode=moe_mode)
    elif cfg.family == "ssm":
        for i, lp in layers(params):
            x, st = rwkv6.block(lp, cfg, x, cache.layer(i), attn_impl=attn_impl)
            cache.write_layer(i, st)
    else:
        positions = shd.batched(x, lambda n: _default_positions(n, s, x.device))
        for i, lp in layers(params):
            x = _hybrid_layer(lp, cfg, x, cache, i, positions=positions,
                              attn_impl=attn_impl)
    return _last_position_logits(params, cfg, x, valid), cache


def lm_decode_step(params, cfg: ModelConfig, token, pos, cache, *,
                   attn_impl: str = "kernel", moe_mode: str = "ep"):
    """One-token decode for every row. token/pos: (B,) int.  Updates
    ``cache`` in place and returns (logits (B, V) fp32, cache)."""
    _check_family(cfg)
    _check_impl(attn_impl)
    x = _embed(params, cfg, token)[:, None, :]
    if shd.ON_DTENSORS:
        x = shd.batch_only(x)
    if cfg.family in ATTENTION_FAMILIES:
        for i, lp in layers(params):
            x = _attn_block_decode(lp, cfg, x, pos, cache.layer(i),
                                   attn_impl=attn_impl, moe_mode=moe_mode)
    elif cfg.family == "ssm":
        for i, lp in layers(params):
            x, st = rwkv6.block(lp, cfg, x, cache.layer(i), attn_impl=attn_impl)
            cache.write_layer(i, st)
    else:
        for i, lp in layers(params):
            x = _hybrid_layer(lp, cfg, x, cache, i, pos=pos, attn_impl=attn_impl)
    return _unembed(params, cfg, x)[:, 0, :], cache
