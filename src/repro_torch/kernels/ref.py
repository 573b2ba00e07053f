"""Plain-torch versions of the port's kernels (the correctness ground truth).

Each function here is the line-for-line counterpart of the JAX package's
oracle of the same name.  The CPU tests hold the kernels' wrappers to them,
and ``chip_smoke.py`` compares each CUDA kernel with its plain version on
the card.  Nothing on the main path calls them when a card is present.
"""
from __future__ import annotations

import torch


def paged_decode_attention_ref(q, k_pages, v_pages, block_tables, lengths, *,
                               k_scales=None, v_scales=None, softcap=None):
    """Paged single-token GQA decode. q: (B, H, D);
    k_pages/v_pages: (N, page_size, KV, D); block_tables: (B, P) int
    physical page ids (-1 = unassigned); lengths: (B,) tokens written.
    ``k_scales``/``v_scales``: (N, page_size, KV) fp32 per-(slot, kv-head)
    scales for int8 pages — the gathered view is dequantized before
    attention.  Returns (B, H, D)."""
    b, h, d = q.shape
    page_size, kv = k_pages.shape[1], k_pages.shape[2]
    g = h // kv
    idx = torch.clamp(block_tables.long(), min=0)
    k = k_pages[idx].reshape(b, -1, kv, d)      # (B, P*page, KV, D)
    v = v_pages[idx].reshape(b, -1, kv, d)
    if k_scales is not None:
        k = k.float() * k_scales[idx].reshape(b, -1, kv)[..., None]
        v = v.float() * v_scales[idx].reshape(b, -1, kv)[..., None]
    s = k.shape[1]
    qf = q.float().reshape(b, kv, g, d) * (d ** -0.5)
    logits = torch.einsum("bkgd,btkd->bkgt", qf, k.float())
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    pos = torch.arange(s, device=q.device)[None, :]
    mask = ((pos < lengths[:, None])
            & torch.repeat_interleave(block_tables >= 0, page_size, dim=1))
    logits = torch.where(mask[:, None, None, :], logits, -1e30)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p, v.float())
    return out.reshape(b, h, d).to(q.dtype)
