"""What decides ``correct``: the program's outputs against the reference's.

* Served tokens: the gap between the logprob the engine reported for a
  token it served and the reference's logprob of that token after the
  same prompt and tokens, the widest (``logprob_gap``) and the mean over
  the tokens compared (``logprob_mean_gap``).  It catches a wrong forward
  and a token altered after it was drawn alike.
* A train step, by leaf (``leaves``' names): each optimizer step's loss
  (``loss_gap``, the widest absolute gap); the first step's gradient as
  the optimizer takes it (clipped), read from the program's first moment
  after one step (m = (1 - b1) g) (``grad_gap``); the change of the fp32
  master weights over the first three steps (``update_gap``).  Both by
  the worst leaf: |program's norm - reference's| over the larger of the
  reference's norm of that leaf and of the median leaf.  Leaves whose
  reference gradient is under a thousandth of the median leaf's move by
  round-off alone and are left out of ``update_gap``.
"""
from __future__ import annotations

import statistics
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

B1 = 0.9                # AdamW's first-moment decay (the port's OptConfig)
STILL = 1e-3            # a leaf under this share of the median gradient stands still


def leaves(tree) -> List[Tuple[str, torch.Tensor]]:
    """(name, tensor) of the port's parameter tree (or a tree of its
    shape) under ``bench.lib.weights``' names: ``wq.3`` is layer 3's."""
    out = [("embed", tree["embed"]), ("final_norm", tree["final_norm"]["scale"])]
    if "lm_head" in tree:                   # an untied head
        out.append(("lm_head", tree["lm_head"]))
    for i, b in enumerate(tree["blocks"]):
        a, m = b["attn"], b["mlp"]
        out += [(f"ln1.{i}", b["ln1"]["scale"]), (f"ln2.{i}", b["ln2"]["scale"]),
                (f"wq.{i}", a["wq"]), (f"wk.{i}", a["wk"]), (f"wv.{i}", a["wv"]),
                (f"wo.{i}", a["wo"]), (f"q_norm.{i}", a["q_norm"]), (f"k_norm.{i}", a["k_norm"]),
                (f"wi_gate.{i}", m["wi_gate"]), (f"wi_up.{i}", m["wi_up"]),
                (f"w_down.{i}", m["wo"])]
    return out


def stacked_leaves(w: Dict[str, torch.Tensor]) -> Iterable[Tuple[str, torch.Tensor]]:
    """The same names over ``bench.lib.weights``' stacked layout."""
    for name, t in w.items():
        if name in ("embed", "lm_head", "final_norm"):
            yield name, t
        else:
            for i in range(t.shape[0]):
                yield f"{name}.{i}", t[i]


def norms(items: Iterable[Tuple[str, torch.Tensor]], scale: float = 1.0) -> Dict[str, float]:
    return {k: float(t.detach().float().norm()) * scale for k, t in items}


def worst_leaf(program: Dict[str, float], reference: Dict[str, float],
               keys: Iterable[str] = None) -> float:
    keys = list(reference if keys is None else keys)
    if set(keys) - set(program):
        raise ValueError(f"the program lacks leaves {sorted(set(keys) - set(program))[:5]}")
    median = statistics.median(reference[k] for k in keys)
    return max(abs(program[k] - reference[k]) / max(reference[k], median, 1e-30) for k in keys)


def moving(first_grads: Dict[str, float]) -> List[str]:
    median = statistics.median(first_grads.values())
    return [k for k, g in first_grads.items() if g >= STILL * median]


class TrainProbe:
    """Reads the program's first optimizer steps as they pass: wraps the
    trainer's step function, keeps each step's loss, the first step's
    clipped gradient norms by leaf (from the first moment) and, after
    ``steps`` steps, the fp32 master's change by leaf from ``w0`` (the
    initial weights' leaves).  It reads and passes everything on."""

    def __init__(self, trainer, w0: Dict[str, torch.Tensor], steps: int = 3):
        self.trainer, self.w0, self.steps = trainer, w0, steps
        self.losses: List[float] = []
        self.first_grads: Dict[str, float] = {}
        self.change: Dict[str, float] = {}
        self._inner = trainer._train_step
        trainer._train_step = self._step

    def _step(self, state, mini):
        new_state, metrics = self._inner(state, mini)
        k = len(self.losses) + 1
        if k <= self.steps:
            self.losses.append(float(metrics["loss"]))
            opt = new_state["opt"]
            if k == 1:
                self.first_grads = norms(leaves(opt["m"]), 1.0 / (1.0 - B1))
            if k == self.steps:
                self.change = {key: float((t - self.w0[key].float()).norm())
                               for key, t in leaves(opt["master"])}
                self.w0 = None
        return new_state, metrics

    def release(self) -> None:
        self.trainer._train_step = self._inner
        self.w0 = None


class FollowerReadings:
    """A reference follower's readings in a ``TrainProbe``'s form: the
    reference put in the program's place (the control)."""

    def __init__(self, follower):
        self.steps = follower.step_count
        self.losses = list(follower.history)
        self.first_grads = norms(stacked_leaves(follower.first_grads))
        initial = dict(stacked_leaves(follower.initial))
        self.change = {k: float((t.detach() - initial[k].float()).norm())
                       for k, t in stacked_leaves(follower.w)}


def train_gaps(probe: TrainProbe, follower) -> Dict[str, float]:
    """``loss_gap``, ``grad_gap`` and ``update_gap`` of the program's first
    steps against the reference ``follower``'s (``bench.reference.grpo``),
    the median leaf's ``update_gap``, and how many leaves ``update_gap``
    left out as standing still."""
    ref_grads = norms(stacked_leaves(follower.first_grads))
    initial = dict(stacked_leaves(follower.initial))
    ref_change = {k: float((t.detach() - initial[k].float()).norm())
                  for k, t in stacked_leaves(follower.w)}
    n = min(len(probe.losses), len(follower.history))
    if n < probe.steps or not probe.change:
        raise ValueError(f"{n} steps compared, {probe.steps} wanted")
    live = moving(ref_grads)
    median = statistics.median(ref_change[k] for k in live)
    return {
        "loss_gap": max(abs(a - b) for a, b in zip(probe.losses[:n], follower.history[:n])),
        "grad_gap": worst_leaf(probe.first_grads, ref_grads),
        "update_gap": worst_leaf(probe.change, ref_change, live),
        # the median leaf's gap: steadier than the worst leaf's, which the
        # tied embedding sets on some seeds
        "update_median_gap": statistics.median(
            abs(probe.change[k] - ref_change[k]) / max(ref_change[k], median) for k in live),
        "still_leaves": len(ref_grads) - len(live),
    }


def served_gaps(served: List[np.ndarray], reference: List[np.ndarray]) -> Dict[str, float]:
    """The widest (``logprob_gap``) and the mean (``logprob_mean_gap``)
    absolute gap between the logprobs the engine reported for the tokens
    it served and the reference's logprobs of those tokens."""
    gaps = np.concatenate([np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
                           for a, b in zip(served, reference)]) if served else np.zeros(0)
    if gaps.size == 0:
        raise ValueError("no served token to compare")
    return {"logprob_gap": float(gaps.max()), "logprob_mean_gap": float(gaps.mean())}
