"""Plain-torch versions of the port's kernels (the correctness ground truth).

Each function here is the line-for-line counterpart of the JAX package's
oracle of the same name.  The CPU tests hold the kernels' wrappers to them,
and ``chip_smoke.py`` compares each CUDA kernel with its plain version on
the card.  Nothing on the main path calls them when a card is present.
"""
from __future__ import annotations

import torch


def decode_attention_ref(q, k, v, lengths, *, window=None):
    """Single-token GQA decode. q: (B, H, D); k/v: (B, S, KV, D);
    lengths: (B,) number of valid cache entries (positions 0..len-1).
    Returns (B, H, D)."""
    b, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    g = h // kv
    qf = q.float().reshape(b, kv, g, d) * (d ** -0.5)
    logits = torch.einsum("bkgd,btkd->bkgt", qf, k.float())
    pos = torch.arange(s, device=q.device)[None, :]
    mask = pos < lengths[:, None]
    if window is not None:
        mask &= pos >= (lengths[:, None] - window)
    logits = torch.where(mask[:, None, None, :], logits, -1e30)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p, v.float())
    return out.reshape(b, h, d).to(q.dtype)


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


def _flash_logits(q, k, causal, window, softcap):
    """Scores (B, KV, G, S, S) fp32 after the softcap and the -1e30 fill,
    and tanh(s / softcap) (None without a softcap) for the backward."""
    b, h, s, d = q.shape
    kv = k.shape[1]
    qf = q.float().reshape(b, kv, h // kv, s, d) * (d ** -0.5)
    logits = torch.einsum("bkgqd,bktd->bkgqt", qf, k.float())
    t = None
    if softcap is not None:
        t = torch.tanh(logits / softcap)
        logits = softcap * t
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= (qpos - kpos) < window
    return torch.where(mask, logits, -1e30), t


def flash_attention_ref(q, k, v, *, causal=True, window=None, softcap=None,
                        return_lse=False):
    """q: (B, H, S, D); k/v: (B, KV, S, D); GQA via H % KV == 0.
    Returns (B, H, S, D) in q's dtype, accumulation in fp32; with
    ``return_lse`` also the per-row log-sum-exp of the masked scores,
    (B, H, S) fp32, which the backward recomputes P from."""
    b, h, s, d = q.shape
    kv = k.shape[1]
    logits, _ = _flash_logits(q, k, causal, window, softcap)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqt,bktd->bkgqd", p, v.float())
    out = out.reshape(b, h, s, d).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(logits, dim=-1).reshape(b, h, s)
    return out


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal=True, window=None,
                            softcap=None):
    """The explicit backward of ``flash_attention_ref``: P recomputed from
    the saved log-sum-exp, dV = P^T dO, dS = P * (dO V^T - rowsum(dO * O)),
    times 1 - tanh^2 under a softcap, zero on masked entries (P is 0
    there); dQ = dS K / sqrt(D), dK = dS^T Q / sqrt(D), with dK and dV
    summed over the G query heads of each KV head.  Returns (dq, dk, dv)
    in the dtypes of q, k, v."""
    b, h, s, d = q.shape
    kv = k.shape[1]
    g = h // kv
    scale = d ** -0.5
    logits, t = _flash_logits(q, k, causal, window, softcap)
    p = torch.exp(logits - lse.reshape(b, kv, g, s, 1))
    dof = do.float().reshape(b, kv, g, s, d)
    delta = (dof * o.float().reshape(b, kv, g, s, d)).sum(-1, keepdim=True)
    dv = torch.einsum("bkgqt,bkgqd->bktd", p, dof)
    dp = torch.einsum("bkgqd,bktd->bkgqt", dof, v.float())
    ds = p * (dp - delta)
    if t is not None:
        ds = ds * (1.0 - t * t)
    qf = q.float().reshape(b, kv, g, s, d)
    dq = torch.einsum("bkgqt,bktd->bkgqd", ds, k.float()) * scale
    dk = torch.einsum("bkgqt,bkgqd->bktd", ds, qf) * scale
    return (dq.reshape(b, h, s, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


def rwkv6_scan_ref(r, k, v, w, u, state):
    """RWKV-6 WKV recurrence. r/k/v/w: (B, T, H, D); u: (H, D);
    state: (B, H, D, D) fp32. Returns (y (B,T,H,D) fp32, new_state)."""
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    ys = []
    for t in range(rf.shape[1]):
        rt, kt, vt, wt = rf[:, t], kf[:, t], vf[:, t], wf[:, t]  # (B, H, D)
        a = kt[..., :, None] * vt[..., None, :]                   # (B, H, D, D)
        ys.append(torch.einsum("bhi,bhij->bhj", rt, state + u[..., :, None] * a))
        state = wt[..., :, None] * state + a
    return torch.stack(ys, dim=1), state


def rglru_scan_ref(a, b, h0):
    """RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t, elementwise over
    W. a/b: (B, T, W) (widened to fp32); h0: (B, W) fp32.
    Returns (hs (B, T, W) fp32, h_last (B, W) fp32)."""
    af, bf = a.float(), b.float()
    h = h0.float()
    hs = []
    for t in range(af.shape[1]):
        h = af[:, t] * h + bf[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1), h
