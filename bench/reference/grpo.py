"""The reference train step: the batch built from samples, GRPO advantages,
the decoupled-PPO loss with the engine-mismatch weight (the paper's eq. 12)
and AdamW with fp32 master weights, global-norm clipping and warm-up, in
plain PyTorch over ``bench.reference.qwen3``.  It follows the port's
``HostTrainer.train_on_samples`` as the paper and the port's configuration
describe it: per call, proximal logprobs from the weights at the call's
start, then one optimizer step per minibatch of consecutive rows.

Rows run one at a time, each block's activations recomputed in the
backward, so a minibatch of 16 rows of 1,024 tokens fits beside the fp32
weights, gradients and moments.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from bench.reference.qwen3 import Qwen3


@dataclasses.dataclass(frozen=True)
class Settings:
    max_seq_len: int
    group_size: int
    minibatches: int
    learning_rate: float
    warmup_steps: int
    epsilon: float = 0.2            # decoupled-PPO clip
    mismatch_cap: float = 5.0       # eq. 12's C
    b1: float = 0.9
    b2: float = 0.95
    adam_eps: float = 1e-8
    grad_clip: float = 1.0


def rows(samples: List[dict], s: Settings) -> List[dict]:
    """Each sample as the train step sees it: the prompt's last tokens and
    the response cut to ``max_seq_len``, its rollout logprobs, and its
    advantage: normalised within its group (population std, eps 1e-6) when
    the batch is whole groups, else over the batch."""
    out = []
    for x in samples:
        p = np.asarray(x["prompt"], np.int64)[-s.max_seq_len:]
        r = np.asarray(x["response"], np.int64)[:s.max_seq_len - len(p)]
        out.append({"prompt": p, "response": r,
                    "old": np.asarray(x["logprobs"], np.float32)[:len(r)]})
    rewards = np.asarray([x["reward"] for x in samples], np.float32)
    gids = [x["group_id"] for x in samples]
    n, g = len(samples), s.group_size
    if n % g == 0 and len(set(gids)) == n // g:
        order = np.argsort(gids, kind="stable")
        grouped = rewards[order].reshape(-1, g)
        adv = ((grouped - grouped.mean(1, keepdims=True))
               / (grouped.std(1, keepdims=True) + np.float32(1e-6))).reshape(-1)
        adv = adv[np.argsort(order)]
    else:
        adv = (rewards - rewards.mean()) / (rewards.std() + 1e-6)
    for row, a in zip(out, adv):
        row["adv"] = float(a)
    return out


def seq_objective(lp, old, prox, adv: float, cap: float, eps: float):
    """Mean over the response of min(A' r, A' (prox/old) clip(r_prox)),
    with A' = A min(exp(lp - old), C) taken without gradient."""
    if lp.numel() == 0:
        return lp.sum()
    a = adv * torch.clamp(torch.exp(lp.detach() - old), max=cap)
    ratio = torch.exp(lp - old)
    behaviour = torch.exp(prox - old)
    clipped = torch.clamp(torch.exp(lp - prox), 1.0 - eps, 1.0 + eps)
    return torch.minimum(ratio * a, behaviour * clipped * a).mean()


class Follower:
    """Holds fp32 master weights (stacked, by name), AdamW's moments, and
    follows optimizer steps on rows.  ``history`` keeps each step's loss;
    ``first_grads`` the first step's clipped gradient by leaf."""

    def __init__(self, cfg: dict, weights: Dict[str, torch.Tensor], s: Settings,
                 precision: str = "fp32"):
        self.s = s
        self.initial = weights
        self.w = {k: v.detach().float().clone().requires_grad_(True) for k, v in weights.items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.w.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.w.items()}
        self.model = Qwen3(cfg, self.w, precision)
        self.step_count = 0
        self.history: List[float] = []
        self.first_grads: Dict[str, torch.Tensor] = {}

    def _tensors(self, row, device):
        return (torch.as_tensor(row["prompt"], device=device),
                torch.as_tensor(row["response"], device=device),
                torch.as_tensor(row["old"], device=device))

    def logprobs(self, batch: List[dict]) -> List[torch.Tensor]:
        device = self.w["embed"].device
        with torch.no_grad():
            out = []
            for row in batch:
                p, r, _ = self._tensors(row, device)
                out.append(self.model.response_logprobs(p, r) if len(r) else
                           torch.zeros(0, device=device))
            return out

    def step(self, mini: List[dict], prox: List[torch.Tensor]) -> float:
        device = self.w["embed"].device
        n = len(mini)
        loss = 0.0
        for row, pr in zip(mini, prox):
            p, r, old = self._tensors(row, device)
            if len(r) == 0:
                continue
            lp = self.model.response_logprobs(p, r, remat=True)
            term = -seq_objective(lp, old, pr, row["adv"], self.s.mismatch_cap,
                                  self.s.epsilon) / n
            term.backward()
            loss += float(term.detach())
        self._adamw()
        self.history.append(loss)
        return loss

    @torch.no_grad()
    def _adamw(self) -> None:
        s = self.s
        self.step_count += 1
        t = self.step_count
        lr = s.learning_rate * min(1.0, t / max(s.warmup_steps, 1))
        grads = {k: (w.grad if w.grad is not None else torch.zeros_like(w))
                 for k, w in self.w.items()}
        gnorm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
        scale = torch.clamp(s.grad_clip / (gnorm + 1e-9), max=1.0)
        bc1, bc2 = 1 - s.b1 ** t, 1 - s.b2 ** t
        for k, w in self.w.items():
            g = grads[k] * scale
            if t == 1:
                self.first_grads[k] = g.clone()
            self.m[k].mul_(s.b1).add_(g, alpha=1 - s.b1)
            self.v[k].mul_(s.b2).addcmul_(g, g, value=1 - s.b2)
            w.sub_(lr * (self.m[k] / bc1) / ((self.v[k] / bc2).sqrt() + s.adam_eps))
            w.grad = None


def follow(cfg: dict, weights: Dict[str, torch.Tensor], calls: List[List[dict]], s: Settings,
           steps: int = 3, precision: str = "fp32",
           at_step: Optional[Callable[[Follower], None]] = None) -> Follower:
    """The reference through the first ``steps`` optimizer steps of the
    trainer's calls (each a list of samples); ``at_step`` sees the follower
    after each step."""
    f = Follower(cfg, weights, s, precision)
    for samples in calls:
        batch = rows(samples, s)
        prox = f.logprobs(batch)
        n, mb = len(batch), s.minibatches
        for j in range(mb):
            if f.step_count >= steps:
                return f
            lo, hi = j * n // mb, (j + 1) * n // mb
            f.step(batch[lo:hi], prox[lo:hi])
            if at_step is not None:
                at_step(f)
    return f
