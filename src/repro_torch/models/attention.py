"""GQA attention: projections, the plain-torch ``attend``, the
full-sequence ``self_attention`` (causal or not) that runs either
``attend`` or the flash kernels (``attn_impl``), the slot engine's dense
KV cache with its prefill and decode steps, and ``cross_attention``.

* GQA is expressed by reshaping queries to (B, S, n_kv, group, head_dim);
  KV heads are never repeated in memory.
* Up to ``_DIRECT_PATH_MAX_SEQ`` keys the score tensor is materialised
  directly; beyond it an online-softmax loop over KV blocks (flash-style in
  plain torch) keeps peak scores at (B, H, q_chunk, block_k).
* Masked scores take a ``-1e30`` fill, not ``-inf``: a fully masked row
  averages V uniformly, exactly as in the reference package.
* The dense cache (``KVCache``) is ``(L, B, S_max, n_kv, head_dim)`` plus
  an int32 position map ``(L, B, S_max)`` (-1 = empty), stacked over layers
  like the paged pool.  Sliding-window configs allocate ``S_max = window``
  when that is shorter than the sequence budget and write at
  ``pos % S_max`` (a ring); the position map makes masking uniform.  Unlike
  the reference, whose functions return a new cache, prefill and decode
  write the layer's view IN PLACE (indexed assignment): a functional copy
  of the whole cache per step is not an option at serving sizes.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.device import torch_dtype
from repro_torch.kernels.decode_attention import (
    decode_attention as decode_attention_kernel)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import module
from repro_torch.models import sharding as shd
from repro_torch.models.config import ModelConfig

_DIRECT_PATH_MAX_SEQ = 2048  # below this, materialise scores directly
_KV_BLOCK = 1024
_Q_CHUNK = 2048
_NEG_INF = -1e30
_INT32_MAX = 2 ** 31 - 1


def init_attention(gen: torch.Generator, cfg: ModelConfig, device, *,
                   cross: bool = False):
    """Projection weights; ``q_norm``/``k_norm`` with ``cfg.qk_norm``, never
    for ``cross`` attention (the enc-dec decoder's)."""
    dt = torch_dtype(cfg.dtype)
    hd = cfg.resolved_head_dim
    p = {
        "wq": module.dense_init(gen, cfg.d_model, cfg.q_dim, dt, device),
        "wk": module.dense_init(gen, cfg.d_model, cfg.kv_dim, dt, device),
        "wv": module.dense_init(gen, cfg.d_model, cfg.kv_dim, dt, device),
        "wo": module.dense_init(gen, cfg.q_dim, cfg.d_model, dt, device),
    }
    if cfg.qk_norm and not cross:
        p["q_norm"] = torch.ones((hd,), dtype=torch.float32, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=torch.float32, device=device)
    return p


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor    # (L, B, S_max, n_kv, head_dim); one layer's view drops L
    v: torch.Tensor
    pos: torch.Tensor  # (L, B, S_max) int32, -1 = empty
    max_len: int       # the sequence budget it was made for (> S_max: a ring)

    @property
    def ring(self) -> bool:
        return self.k.shape[-3] < self.max_len

    def layer(self, i: int) -> "KVCache":
        """Layer ``i``'s (B, S_max, ...) views into the cache."""
        return KVCache(self.k[i], self.v[i], self.pos[i], self.max_len)

    def rows(self, lo: int, hi: int) -> "KVCache":
        """Views of batch rows ``lo:hi`` of every layer."""
        return KVCache(self.k[:, lo:hi], self.v[:, lo:hi], self.pos[:, lo:hi],
                       self.max_len)


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, device, *,
                  window=None, num_layers=None) -> KVCache:
    """Empty cache of ``num_layers`` layers (default: every layer of the
    config): zeros, positions -1.  ``window`` (default
    ``cfg.sliding_window``) shorter than ``max_len`` makes a ring of
    ``window`` slots."""
    w = window if window is not None else cfg.sliding_window
    s = min(max_len, w) if w is not None else max_len
    n = cfg.num_layers if num_layers is None else num_layers
    shape = (n, batch, s, cfg.num_kv_heads, cfg.resolved_head_dim)
    dt = torch_dtype(cfg.dtype)
    return KVCache(
        k=torch.zeros(shape, dtype=dt, device=device),
        v=torch.zeros(shape, dtype=dt, device=device),
        pos=torch.full(shape[:3], -1, dtype=torch.int32, device=device),
        max_len=max_len)


# ---------------------------------------------------------------------------
# core attend
# ---------------------------------------------------------------------------

def _soft_cap(logits, cap):
    if cap is None:
        return logits
    return cap * torch.tanh(logits / cap)


def _mask(q_pos, kv_pos, kv_valid, window):
    """(B, 1, 1, Sq, Skv) bool: valid, causal and (optionally) windowed."""
    mask = (kv_valid[:, None, None, None, :]
            & (kv_pos[:, None, None, None, :] <= q_pos[:, None, None, :, None]))
    if window is not None:
        mask = mask & ((q_pos[:, None, None, :, None]
                        - kv_pos[:, None, None, None, :]) < window)
    return mask


def _attend_direct(q, k, v, q_pos, kv_pos, kv_valid, *, window, softcap):
    """q: (B,Sq,KV,G,hd); k/v: (B,Skv,KV,hd).  Materialises the scores.

    Probabilities are cast to ``v.dtype`` before the PV product, as in the
    reference: in bf16 they round to bf16."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqkgd,btkd->bkgqt", q.float() * scale, k.float())
    logits = _soft_cap(logits, softcap)
    logits = torch.where(_mask(q_pos, kv_pos, kv_valid, window), logits,
                         _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bkgqt,btkd->bqkgd", probs.to(v.dtype), v)


def _attend_kv_scan(q, k, v, q_pos, kv_pos, kv_valid, *, window, softcap,
                    block=_KV_BLOCK):
    """Online-softmax loop over KV blocks. Same field order as _attend_direct."""
    b, sq, nkv, g, hd = q.shape
    pad = -k.shape[1] % block
    if pad:
        # padded keys are invalid (-1e30): in a fully masked row they still
        # count in the uniform average, as in the reference.
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = F.pad(kv_pos, (0, pad), value=-1)
        kv_valid = F.pad(kv_valid, (0, pad), value=False)
    skv = k.shape[1]
    qf = q.float() * hd ** -0.5
    m = torch.full((b, nkv, g, sq), -torch.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, nkv, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, nkv, g, sq, hd), dtype=torch.float32, device=q.device)
    for lo in range(0, skv, block):
        kj, vj = k[:, lo:lo + block], v[:, lo:lo + block]
        logits = torch.einsum("bqkgd,btkd->bkgqt", qf, kj.float())
        logits = _soft_cap(logits, softcap)
        mask = _mask(q_pos, kv_pos[:, lo:lo + block],
                     kv_valid[:, lo:lo + block], window)
        logits = torch.where(mask, logits, _NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgqt,btkd->bkgqd", p,
                                                    vj.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)  # (B,Sq,KV,G,hd)


def _attend_blockwise(q, k, v, q_pos, kv_pos, kv_valid, **kwargs):
    """Query chunks of ``_Q_CHUNK``, each an online-softmax loop over KV
    blocks: peak live scores are (B, H, q_chunk, block_k)."""
    sq = q.shape[1]
    outs = [_attend_kv_scan(q[:, lo:lo + _Q_CHUNK], k, v,
                            q_pos[:, lo:lo + _Q_CHUNK], kv_pos, kv_valid,
                            **kwargs)
            for lo in range(0, sq, _Q_CHUNK)]
    return torch.cat(outs, dim=1)


def attend(q, k, v, q_pos, kv_pos, kv_valid, *, window=None, softcap=None):
    if shd.ON_DTENSORS:
        return shd.attend_local(_attend, q, k, v, q_pos, kv_pos, kv_valid,
                                window=window, softcap=softcap)
    return _attend(q, k, v, q_pos, kv_pos, kv_valid, window=window, softcap=softcap)


def _attend(q, k, v, q_pos, kv_pos, kv_valid, *, window, softcap):
    if k.shape[1] <= _DIRECT_PATH_MAX_SEQ:
        return _attend_direct(q, k, v, q_pos, kv_pos, kv_valid, window=window,
                              softcap=softcap)
    return _attend_blockwise(q, k, v, q_pos, kv_pos, kv_valid, window=window,
                             softcap=softcap)


# ---------------------------------------------------------------------------
# layer-level entry points
# ---------------------------------------------------------------------------

def _project_q(p, cfg: ModelConfig, x, positions):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = shd.view(x @ p["wq"], b, s, cfg.num_heads, hd)
    if cfg.qk_norm and "q_norm" in p:
        q = module.rmsnorm_head(p["q_norm"], q, cfg.norm_eps)
    q = module.apply_rope(q, positions, cfg.rope_theta)
    return shd.view(q, b, s, cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, hd)


def _project_kv(p, cfg: ModelConfig, x, positions):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    k = shd.view(x @ p["wk"], b, s, cfg.num_kv_heads, hd)
    v = shd.view(x @ p["wv"], b, s, cfg.num_kv_heads, hd)
    if cfg.qk_norm and "k_norm" in p:
        k = module.rmsnorm_head(p["k_norm"], k, cfg.norm_eps)
    k = module.apply_rope(k, positions, cfg.rope_theta)
    return k, v


def _window(cfg: ModelConfig, window):
    """``window="cfg"``: the config's sliding window; else as given."""
    return cfg.sliding_window if window == "cfg" else window


def self_attention(p, cfg: ModelConfig, x, positions, *, causal: bool = True,
                   window="cfg", attn_impl: str = "kernel"):
    """Full-sequence self-attention. x: (B,S,D); positions: (B,S) int.

    ``causal=False`` lets every query see every key (the enc-dec encoder);
    the plain route then gives every query the position ``INT32_MAX``, as
    the reference does.  ``window``: "cfg" (``cfg.sliding_window``), None
    or a number of tokens.

    ``attn_impl="kernel"`` runs ``FlashAttention`` (the CUDA kernels on the
    card, their plain versions on the CPU) on strided (B, H, S, D) views of
    the projections; it masks by sequence index, which is ``attend``'s mask
    for positions 0..S-1 (``lm_apply``'s default).  ``"ref"`` runs
    ``attend``, which rounds P to ``v.dtype`` before PV: in bf16 the two
    differ by that rounding, in fp32 they agree."""
    b, s, _ = x.shape
    w = _window(cfg, window)
    q = _project_q(p, cfg, x, positions)
    k, v = _project_kv(p, cfg, x, positions)
    if attn_impl == "kernel":
        out = flash_attention(
            shd.view(q, b, s, cfg.num_heads, cfg.resolved_head_dim).transpose(1, 2),
            k.transpose(1, 2), v.transpose(1, 2), causal=causal,
            window=w, softcap=cfg.attn_logit_softcap)
        out = out.transpose(1, 2)
    elif attn_impl == "ref":
        kv_valid = shd.batched(x, lambda n: torch.ones((n, s), dtype=torch.bool,
                                                       device=x.device))
        q_pos = positions if causal else torch.full_like(positions, _INT32_MAX)
        out = attend(q, k, v, q_pos, positions, kv_valid,
                     window=w, softcap=cfg.attn_logit_softcap)
    else:
        raise ValueError(f"unknown attn_impl {attn_impl!r} (expected kernel | ref)")
    return shd.view(out, b, s, cfg.q_dim) @ p["wo"]


def prefill_attention(p, cfg: ModelConfig, x, positions, cache: KVCache, *,
                      window="cfg", valid=None):
    """Causal self-attention that also writes one layer's cache in place.

    x: (B, S, D); positions: (B, S); ``cache``: one layer's view.  Requires
    S_max >= S for full caches; ring caches keep the last ``window`` tokens.
    ``valid`` (B, S) masks right-padded prompt slots: invalid positions are
    excluded from attention and written with pos = -1.  Attention runs the
    plain ``attend`` over the new K/V, as the reference does.  ``window``
    as in ``self_attention``."""
    b, s, _ = x.shape
    q = _project_q(p, cfg, x, positions)
    k, v = _project_kv(p, cfg, x, positions)
    kv_valid = (shd.batched(x, lambda n: torch.ones((n, s), dtype=torch.bool,
                                                    device=x.device))
                if valid is None else valid)
    idx = (positions % cache.k.shape[1]).long()
    bidx = torch.arange(b, device=x.device)[:, None]
    if shd.ON_DTENSORS:
        new_pos = torch.where(kv_valid, positions, -1).to(torch.int32)
        for dst, src in ((cache.k, k), (cache.v, v), (cache.pos, new_pos)):
            shd.write_slots(dst, bidx, idx, src)
    else:
        cache.k[bidx, idx] = k
        cache.v[bidx, idx] = v
        cache.pos[bidx, idx] = torch.where(kv_valid, positions, -1).to(torch.int32)
    out = attend(q, k, v, positions, positions, kv_valid,
                 window=_window(cfg, window), softcap=cfg.attn_logit_softcap)
    return shd.view(out, b, s, cfg.q_dim) @ p["wo"], cache


def decode_attention(p, cfg: ModelConfig, x, pos, cache: KVCache, *,
                     window="cfg", attn_impl: str = "kernel"):
    """One-token decode. x: (B, 1, D); pos: (B,) int current positions;
    ``cache``: one layer's view, written in place at ``pos % S_max``.

    ``attn_impl="kernel"`` runs the decode kernel (the CUDA kernel on the
    card, its plain version on the CPU) with lengths ``pos + 1`` and the
    window (``window`` as in ``self_attention``): the cache is not a ring,
    so slot index = position and the valid entries after the write are
    exactly 0..pos.  It refuses a
    softcapped config (the TPU kernel has no softcap) and a ring cache.
    ``"ref"`` runs ``_attend_direct`` over the position map."""
    if attn_impl == "kernel" and cfg.attn_logit_softcap is not None:
        raise ValueError("decode_attention: attn_impl='kernel' has no softcap "
                         "(as the TPU kernel); use attn_impl='ref'")
    if attn_impl == "kernel" and cache.ring:
        raise ValueError("decode_attention: attn_impl='kernel' needs a cache of "
                         f"the full sequence budget ({cache.max_len}), not a ring "
                         f"of {cache.k.shape[1]}; use attn_impl='ref'")
    b = x.shape[0]
    w = _window(cfg, window)
    positions = pos[:, None]
    q = _project_q(p, cfg, x, positions)
    k_new, v_new = _project_kv(p, cfg, x, positions)
    idx = (pos % cache.k.shape[1]).long()
    bidx = torch.arange(b, device=x.device)
    if shd.ON_DTENSORS:
        for dst, src in ((cache.k, k_new[:, 0]), (cache.v, v_new[:, 0]),
                         (cache.pos, pos.to(torch.int32))):
            shd.write_slots(dst, bidx, idx, src)
    else:
        cache.k[bidx, idx] = k_new[:, 0]
        cache.v[bidx, idx] = v_new[:, 0]
        cache.pos[bidx, idx] = pos.to(torch.int32)
    if attn_impl == "kernel":
        out = decode_attention_kernel(
            shd.view(q, b, cfg.num_heads, cfg.resolved_head_dim), cache.k,
            cache.v, pos + 1, window=w)
    elif attn_impl == "ref":
        direct = (functools.partial(shd.attend_local, _attend_direct) if shd.ON_DTENSORS
                  else _attend_direct)
        out = direct(q, cache.k, cache.v, positions, cache.pos, cache.pos >= 0, window=w,
                     softcap=cfg.attn_logit_softcap)
    else:
        raise ValueError(f"unknown attn_impl {attn_impl!r} (expected kernel | ref)")
    return shd.view(out, b, 1, cfg.q_dim) @ p["wo"], cache


# ---------------------------------------------------------------------------
# cross attention (enc-dec)
# ---------------------------------------------------------------------------

def cross_kv(p, cfg: ModelConfig, memory):
    """Cross K and V of one layer over memory (B,T,D): (B,T,KV,hd) each,
    no RoPE, no qk-norm."""
    b, t, _ = memory.shape
    shape = (b, t, cfg.num_kv_heads, cfg.resolved_head_dim)
    return shd.view(memory @ p["wk"], *shape), shd.view(memory @ p["wv"], *shape)


def cross_attend(p, cfg: ModelConfig, x, k, v, memory_valid=None):
    """x: (B,S,D) against one layer's cross K/V (B,T,KV,hd): plain
    ``attend``, every valid memory position visible to every query
    (queries at ``INT32_MAX``, keys at 0)."""
    b, s, _ = x.shape
    t = k.shape[1]
    q = shd.view(x @ p["wq"], b, s, cfg.num_kv_heads,
                 cfg.num_heads // cfg.num_kv_heads, cfg.resolved_head_dim)
    if memory_valid is None:
        memory_valid = shd.batched(x, lambda n: torch.ones((n, t), dtype=torch.bool,
                                                           device=x.device))
    q_pos = shd.batched(x, lambda n: torch.full((n, s), _INT32_MAX, dtype=torch.int32,
                                                device=x.device))
    kv_pos = shd.batched(x, lambda n: torch.zeros((n, t), dtype=torch.int32,
                                                  device=x.device))
    out = attend(q, k, v, q_pos, kv_pos, memory_valid, window=None, softcap=None)
    return shd.view(out, b, s, cfg.q_dim) @ p["wo"]


def cross_attention(p, cfg: ModelConfig, x, memory, memory_valid=None):
    """x: (B,S,D) decoder states; memory: (B,T,D) encoder output:
    ``cross_kv`` then ``cross_attend``.  No path of the port calls it: the
    enc-dec decoder computes the K/V once (``encdec._cross_kv``), as the
    reference does."""
    k, v = cross_kv(p, cfg, memory)
    return cross_attend(p, cfg, x, k, v, memory_valid)
