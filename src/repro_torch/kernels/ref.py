"""Plain-torch versions of the port's kernels (the correctness ground truth).

Each function here is the line-for-line counterpart of the JAX package's
oracle of the same name.  The CPU tests hold the kernels' wrappers to them,
and ``chip_smoke.py`` compares each CUDA kernel with its plain version on
the card.  Nothing on the main path calls them when a card is present.  The
two ``*_chunked_ref`` functions have no oracle of their name: they are the
chunked scan kernels' passes in plain torch, held to the oracles on the CPU
(``tests/test_torch_scan_chunked.py``); nothing on the main path calls them.
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


# log2 of a decay is floored here, as in the chunked WKV kernel: w = 0
# decays as 2^-128 there, and a NaN w stays NaN (clamp passes it on)
_LOG2_DECAY_FLOOR = -128.0


def rwkv6_scan_chunked_ref(r, k, v, w, u, state, chunk):
    """The chunked WKV route of ``csrc/rwkv6_scan.cu`` pass for pass, in
    plain torch (same inputs and outputs as ``rwkv6_scan_ref``; w in
    [0, 1]).  T is cut into chunks of ``chunk`` steps, the last padded with
    r = k = v = 0, w = 1, which change nothing.  Per chunk, log2 w summed in
    float64 from the chunk's start (lc_t before step t) and kept as fp32
    hi + lo; (a) A_c = sum_s (k_s 2^(lc_L - lc_{s+1})) v_s^T and g_c =
    2^lc_L; (b) S_{c+1} = g_c S_c + A_c from the state; (c) y_t = (r_t
    2^lc_t)^T S_c + sum_{s<t} P_ts v_s + (r_t . u k_t) v_t with P_ts =
    sum_i r_t k_s 2^((hi_t - hi_{s+1}) + (lo_t - lo_{s+1})) when t and s
    share a 4-step tile, else split at t's tile start m as
    sum_i (r_t 2^(lc_t - lc_m)) (k_s 2^(lc_m - lc_{s+1})); every factor
    <= 1.  Returns (y (B, T, H, D) fp32, new state)."""
    b, t, h, d = r.shape
    n = -(-t // chunk)
    pad = n * chunk - t

    def chunks(x):                   # (B, T, H, D) -> (B, H, n, L, D)
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        return x.reshape(b, n, chunk, h, d).permute(0, 3, 1, 2, 4)

    rf, kf, vf = (chunks(x.float()) for x in (r, k, v))
    lw = chunks(torch.clamp(torch.log2(w.float()), min=_LOG2_DECAY_FLOOR))
    lc = torch.nn.functional.pad(torch.cumsum(lw.double(), dim=3), (0, 0, 1, 0))
    hi = lc.float()
    lo = (lc - hi.double()).float()
    # (a) chunk states from zero and total decays
    to_end = torch.exp2((lc[..., -1:, :] - lc[..., 1:, :]).float())
    a_c = torch.einsum("bhnsi,bhnsj->bhnij", kf * to_end, vf)
    g_c = torch.exp2(lc[..., -1, :].float())
    # (b) each chunk's incoming state
    s_in = []
    s = state.float()
    for c in range(n):
        s_in.append(s)
        s = g_c[:, :, c, :, None] * s + a_c[:, :, c]
    # (c) outputs: the decay factor of a pair (t, s < t) is one exp2 within a
    # 4-step tile; across tiles it splits at t's tile start m into two <= 1
    def gap(ha, la, hb, lb):
        return (ha - hb) + (la - lb)

    diff = gap(hi[..., :-1, None, :], lo[..., :-1, None, :],
               hi[..., None, 1:, :], lo[..., None, 1:, :])       # (B, H, n, L_t, L_s, D)
    steps = torch.arange(chunk, device=r.device)
    m = steps // 4 * 4
    earlier = (m[None, :] < m[:, None])[:, :, None]            # s's tile before t's
    below = (steps[None, :] < steps[:, None])[:, :, None]
    to_row = torch.exp2(gap(hi[..., :-1, :], lo[..., :-1, :], hi[..., m, :], lo[..., m, :]))
    from_col = torch.exp2(torch.clamp(gap(hi[..., m, None, :], lo[..., m, None, :],
                                          hi[..., None, 1:, :], lo[..., None, 1:, :]), max=0.0))
    fac = torch.where(earlier, to_row[..., :, None, :] * from_col,
                      torch.exp2(torch.where(below, diff, float("-inf"))))
    p = torch.einsum("bhnti,bhnsi,bhntsi->bhnts", rf, kf, fac)
    bonus = (rf * u.float()[None, :, None, None, :] * kf).sum(-1)
    p = p + torch.diag_embed(bonus)
    y = (torch.einsum("bhnti,bhnij->bhntj", rf * torch.exp2(hi[..., :-1, :] + lo[..., :-1, :]),
                      torch.stack(s_in, dim=2))
         + torch.einsum("bhnts,bhnsj->bhntj", p, vf))
    y = y.permute(0, 2, 3, 1, 4).reshape(b, n * chunk, h, d)[:, :t]
    return y, s


def rglru_scan_chunked_ref(a, b, h0, chunk):
    """The chunked RG-LRU route of ``csrc/rglru_scan.cu`` pass for pass, in
    plain torch (same inputs and outputs as ``rglru_scan_ref``).  T is cut
    into chunks of ``chunk`` steps; aggregate: each chunk's (prod a, h from
    0); finish: each chunk's incoming h folded from h0 through the chunks
    before it, then the chunk rerun from it.  Returns (hs (B, T, W) fp32,
    h_last (B, W) fp32)."""
    af, bf = a.float(), b.float()
    t = af.shape[1]
    bounds = [(lo, min(t, lo + chunk)) for lo in range(0, t, chunk)]
    pairs = []
    for lo, hi in bounds:
        p, h = torch.ones_like(af[:, 0]), torch.zeros_like(af[:, 0])
        for s in range(lo, hi):
            h = af[:, s] * h + bf[:, s]
            p = p * af[:, s]
        pairs.append((p, h))
    hs = []
    for c, (lo, hi) in enumerate(bounds):
        h = h0.float()
        for p, hc in pairs[:c]:
            h = p * h + hc
        for s in range(lo, hi):
            h = af[:, s] * h + bf[:, s]
            hs.append(h)
    return torch.stack(hs, dim=1), h
