"""AdamW with fp32 master weights and global-norm clipping.

The reference's arithmetic, per leaf: warmup ``lr * min(1, step/warmup)``,
the clip scale ``min(1, clip / (gnorm + 1e-9))``, bias corrections
``1 - b^step`` and decoupled weight decay on the master.

Memory: the fp32 ``master``, ``m`` and ``v`` are updated IN PLACE (the JAX
code returns new trees; holding two copies of 12 bytes per parameter would
not fit a 2B model's trainer on one card).  The model-dtype params are
always NEW tensors: an engine synced with an earlier tree keeps decoding
with exactly those weights.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from repro_torch.models import sharding as shd


@dataclasses.dataclass(frozen=True)
class OptConfig:
    learning_rate: float = 1e-6   # paper appendix A.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0     # paper appendix A.1
    grad_clip: float = 1.0
    warmup_steps: int = 20        # paper appendix A.1


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the tensors of nested dicts/lists, keeping the shape."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def init_opt_state(params) -> Dict[str, Any]:
    """``step`` is a host int; master is an fp32 copy of every leaf."""
    return {
        "step": 0,
        "master": tree_map(lambda p: p.detach().to(torch.float32, copy=True), params),
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params),
    }


def global_norm(tree) -> torch.Tensor:
    """sqrt of the fp32 sum of squares over every leaf."""
    return torch.sqrt(sum(g.float().square().sum() for g in tree_leaves(tree)))


_SLICE = 1 << 26


def adamw_update(grads, opt_state, cfg: OptConfig, param_dtypes=None):
    """Returns (new_params_in_model_dtype, new_opt_state, metrics).

    param_dtypes: tree of torch dtypes matching params (norm scales stay
    fp32, weights bf16). Defaults to bf16 everywhere if not given.
    ``opt_state``'s master/m/v are updated in place and returned in the
    new state; the params are new tensors."""
    step = opt_state["step"] + 1
    lr = cfg.learning_rate * min(1.0, step / max(cfg.warmup_steps, 1))

    if shd.ON_DTENSORS:
        # each gradient reduced to its master's placements, the norm's sum
        # of squares one reduction over the mesh
        grads = tree_map(shd.placed_like, grads, opt_state["master"])
        gnorm = shd.global_norm(tree_leaves(grads))
    else:
        gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
             if cfg.grad_clip else 1.0)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step
    bc2 = 1 - b2 ** step
    if param_dtypes is None:
        param_dtypes = tree_map(lambda _: torch.bfloat16, opt_state["master"])

    # one leaf at a time, in flat slices of at most _SLICE elements: only
    # one slice's fp32 temporaries are alive at once (an MoE expert leaf
    # holds ~0.8 B elements); the arithmetic is elementwise, so slicing
    # changes no bit
    def upd_leaf(master, m, v, g, dt):
        if shd.ON_DTENSORS:
            # elementwise: each device updates its own shards
            like = master
            master, m, v, g = (t.to_local() for t in (master, m, v, g))
            new = upd_local(master, m, v, g, dt, shd.local_value(scale))
            return shd.placed_as(new, like)
        return upd_local(master, m, v, g, dt, scale)

    def upd_local(master, m, v, g, dt, scale):
        flat = (master.view(-1), m.view(-1), v.view(-1), g.reshape(-1))
        for lo in range(0, flat[0].numel(), _SLICE):
            ms, mo, vo, gs = (t[lo:lo + _SLICE] for t in flat)
            gf = gs.float() * scale
            mo.mul_(b1).add_(gf, alpha=1 - b1)
            vo.mul_(b2).addcmul_(gf, gf, value=1 - b2)
            upd = (mo / bc1).div_((vo / bc2).sqrt_().add_(cfg.eps))
            if cfg.weight_decay:
                upd.add_(ms, alpha=cfg.weight_decay)
            ms.sub_(upd.mul_(lr))
        return master.to(dt, copy=True)

    params = tree_map(upd_leaf, opt_state["master"], opt_state["m"],
                      opt_state["v"], grads, param_dtypes)
    new_state = {"step": step, "master": opt_state["master"],
                 "m": opt_state["m"], "v": opt_state["v"]}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
