"""Mixture-of-Experts layer (the port of the JAX package's ``models/moe.py``).

Two execution paths:

* ``dense``: every expert processes every token, gate-combined.  The
  numerical oracle, and the trainer's mode for an MoE config (as in the
  reference).
* ``ep`` (default): the reference's capacity-factor top-k dispatch over
  token groups of ``_GROUP``.  Each (token, k) assignment takes the next
  slot of its expert's buffer, counted token-major, then by top-k slot;
  assignments at or past the capacity are dropped.  The reference builds
  one-hot dispatch and combine tensors and contracts them with einsums;
  here the same kept assignments are scattered into the experts' buffers
  and gathered back, which moves the same values (a one-hot product copies
  its one nonzero term exactly).

The expert products are plain ``torch.matmul`` batched over the experts,
as the reference's are einsums outside any Pallas kernel.  The expert FFN
runs in the model dtype; the combine runs in fp32 with the gates and is
cast back.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import torch_dtype
from repro_torch.models import module
from repro_torch.models import sharding as shd
from repro_torch.models.config import ModelConfig

_GROUP = 512
MODES = ("ep", "dense")


def _trunc_normal(gen, shape, scale, dtype, device):
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w.mul_(scale).to(dtype)


def init_moe(gen: torch.Generator, cfg: ModelConfig, device):
    """Router fp32 (d, E); ``w_gate``/``w_up`` (E, d, f) and ``w_down``
    (E, f, d) in the model dtype, drawn in fp32."""
    dt = torch_dtype(cfg.dtype)
    e, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    return {
        "router": module.dense_init(gen, d, e, torch.float32, device),
        "w_gate": _trunc_normal(gen, (e, d, f), 1.0 / np.sqrt(d), dt, device),
        "w_up": _trunc_normal(gen, (e, d, f), 1.0 / np.sqrt(d), dt, device),
        "w_down": _trunc_normal(gen, (e, f, d), 1.0 / np.sqrt(f), dt, device),
    }


def _router(p, cfg: ModelConfig, x):
    """(logits, probs, gates, idx): the top-k gates normalized, fp32.  A
    stable descending sort gives ``lax.top_k``'s order: values descending,
    the lower expert first on a tie."""
    logits = x.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.num_experts_per_tok
    gates, idx = top[..., :k], idx[..., :k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, gates, idx


def _aux_losses(cfg: ModelConfig, logits, probs, idx):
    """Load balance (Switch Transformer eq. 4-6) and router z-loss."""
    e = cfg.num_experts
    frac = F.one_hot(idx, e).float().sum(-2).reshape(-1, e).mean(0)
    prob = probs.reshape(-1, e).mean(0)
    z = torch.logsumexp(logits, dim=-1).square().mean()
    return {"load_balance_loss": e * (frac * prob).sum(), "router_z_loss": z}


def _expert_ffn(p, h):
    """h: (E, N, d) -> (E, N, d) through each expert's SwiGLU."""
    act = F.silu(torch.matmul(h, p["w_gate"])) * torch.matmul(h, p["w_up"])
    return torch.matmul(act, p["w_down"])


def _combine(picked, gates, keep=None):
    """Each token's k expert outputs ``picked`` (N, k, d), weighted by its
    gates (N, k) in fp32 and summed; dropped assignments (``keep`` False)
    add nothing."""
    out = picked.float() * gates[..., None]
    if keep is not None:
        out = torch.where(keep[..., None], out, 0.0)
    return out.sum(1)


def moe_dense(p, cfg: ModelConfig, x):
    """Oracle path: all experts on all tokens. x: (B, S, d)."""
    b, s, d = x.shape
    logits, probs, gates, idx = _router(p, cfg, x)
    n, k = b * s, cfg.num_experts_per_tok
    out_e = _expert_ffn(p, x.reshape(n, d))                 # (E, N, d)
    tok = torch.arange(n, device=x.device)[:, None]
    out = _combine(out_e[idx.reshape(n, k), tok], gates.reshape(n, k))
    return out.reshape(b, s, d).to(x.dtype), _aux_losses(cfg, logits, probs, idx)


def capacity(cfg: ModelConfig, group: int) -> int:
    """Slots of each expert's buffer for a group of ``group`` tokens, in the
    reference's float order."""
    return max(1, int(group * cfg.num_experts_per_tok / cfg.num_experts
                      * cfg.capacity_factor))


def dispatch_plan(cfg: ModelConfig, idx):
    """For the router's ``idx`` (G, gs, k) of G groups: each assignment's
    slot in its expert's buffer (G, gs*k), counted over the flattened
    (token, k) order, and whether it is kept (slot < capacity)."""
    g, gs, k = idx.shape
    flat = idx.reshape(g, gs * k)
    onehot = F.one_hot(flat, cfg.num_experts)               # (G, gs*k, E)
    slot = (onehot.cumsum(1) - 1).gather(2, flat[..., None])[..., 0]
    return slot, slot < capacity(cfg, gs)


def moe_ep(p, cfg: ModelConfig, x):
    """Capacity-dispatch path. x: (B, S, d)."""
    if shd.ON_DTENSORS:
        return _moe_ep_partitioned(p, cfg, x)
    b, s, d = x.shape
    gs = min(s, _GROUP)
    assert s % gs == 0, f"seq {s} not divisible by moe group {gs}"
    g = b * (s // gs)
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    cap = capacity(cfg, gs)

    xg = x.reshape(g, gs, d)
    logits, probs, gates, idx = _router(p, cfg, xg)         # idx: (G, gs, k)
    slot, keep = dispatch_plan(cfg, idx)
    # buffer rows laid out (E, G, cap); dropped assignments all write one
    # spare row past the end, which is cut off
    flat = idx.reshape(g, gs * k)
    group = torch.arange(g, device=x.device)[:, None]
    row = (flat * g + group) * cap + slot
    n_rows = e * g * cap
    dest = torch.where(keep, row, n_rows).reshape(-1)
    src = xg.repeat_interleave(k, dim=1).reshape(-1, d)
    buf = x.new_zeros(n_rows + 1, d).index_copy(0, dest, src)
    out_e = _expert_ffn(p, buf[:n_rows].view(e, g * cap, d)).reshape(n_rows, d)

    picked = out_e[torch.where(keep, row, 0).reshape(-1)].view(g * gs, k, d)
    out = _combine(picked, gates.reshape(g * gs, k), keep.reshape(g * gs, k))
    return out.reshape(b, s, d).to(x.dtype), _aux_losses(cfg, logits, probs, idx)


def _moe_ep_partitioned(p, cfg: ModelConfig, x):
    """``moe_ep`` on the partitioned step: x (B, S, d) sharded by batch
    only, the experts sharded over ``model`` (the rules' expert
    parallelism), as the reference's dispatch and combine einsums are
    partitioned.  Each device routes its tokens over every expert, fills
    and runs the buffers of its own experts and combines their outputs: the
    fp32 combine is a partial sum over the experts' mesh dims, reduced
    before the cast; the router losses are means over the batch's."""
    edims = [m for m, pl in enumerate(p["w_gate"].placements) if pl.is_shard()]
    bdims = [m for m, pl in enumerate(x.placements) if pl.is_shard()]
    xl = x.to_local()
    pl = {n: shd.batch_only(t).to_local() if n == "router" else t.to_local()
          for n, t in p.items()}
    b, s, d = xl.shape
    gs = min(s, _GROUP)
    assert s % gs == 0, f"seq {s} not divisible by moe group {gs}"
    g = b * (s // gs)
    e_local, k = pl["w_gate"].shape[0], cfg.num_experts_per_tok
    cap = capacity(cfg, gs)

    xg = xl.reshape(g, gs, d)
    logits, probs, gates, idx = _router(pl, cfg, xg)
    slot, keep = dispatch_plan(cfg, idx)
    flat = idx.reshape(g, gs * k) - shd.shard_offset(p["w_gate"], 0, edims)
    mine = keep & (flat >= 0) & (flat < e_local)
    group = torch.arange(g, device=xl.device)[:, None]
    row = (flat * g + group) * cap + slot
    n_rows = e_local * g * cap
    dest = torch.where(mine, row, n_rows).reshape(-1)
    src = xg.repeat_interleave(k, dim=1).reshape(-1, d)
    buf = xl.new_zeros(n_rows + 1, d).index_copy(0, dest, src)
    out_e = _expert_ffn(pl, buf[:n_rows].view(e_local, g * cap, d)).reshape(n_rows, d)
    picked = out_e[torch.where(mine, row, 0).reshape(-1)].view(g * gs, k, d)
    part = _combine(picked, gates.reshape(g * gs, k), mine.reshape(g * gs, k))
    out = shd.from_partial(part.reshape(b, s, d), x, edims, "sum")
    aux = {n: shd.from_partial(v, x, bdims, "avg", global_shape=())
           for n, v in _aux_losses(cfg, logits, probs, idx).items()}
    return out.to(x.dtype), aux


def moe_apply(p, cfg: ModelConfig, x, *, mode: str = "ep"):
    """(y (B, S, d) in x's dtype, aux losses) through ``mode``'s path."""
    if mode == "dense":
        return moe_dense(p, cfg, x)
    if mode == "ep":
        return moe_ep(p, cfg, x)
    raise ValueError(f"unknown moe_mode {mode!r} (expected ep | dense)")
