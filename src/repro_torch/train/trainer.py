"""Policy-gradient trainer.

``make_train_step`` builds the train step; ``HostTrainer`` is the host-side
wrapper the controller drives: it pads Sample batches, computes GRPO
advantages and proximal/reference logprobs, runs (optionally minibatched)
train steps, and serves fresh weights to the LLMProxy on weight sync.

The JAX package's ``lax.scan`` over microbatches is a Python loop here,
``jax.checkpoint`` is ``torch.utils.checkpoint`` and ``stop_gradient`` is
``.detach()``.  The model's attention runs through ``FlashAttention``
(``attn_impl="kernel"``, the default) or plain ``attend`` (``"ref"``).
The WKV and RG-LRU scan kernels have no backward: the train step runs the
scans' plain versions under autograd, the logprob passes (no gradient)
follow ``attn_impl``.  An MoE config trains and scores in
``moe_mode="dense"`` (every expert on every token, as in the reference),
its router losses weighted into the RL loss.  A VLM's batch carries zero
``patches`` and its logprobs drop the image positions' features; an
enc-dec's carries zero ``frames`` and unembeds through ``lm_head``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.algos import LossConfig, rl_loss, token_logprobs
from repro_torch.core.types import Sample
from repro_torch.models.api import ModelAPI
from repro_torch.models.transformer import unembedding_matrix
from repro_torch.train.optimizer import (OptConfig, adamw_update, init_opt_state,
                                         tree_leaves, tree_map)


def make_train_state(api: ModelAPI, seed: int) -> Dict[str, Any]:
    params = api.init(seed)
    return {"params": params, "opt": init_opt_state(params)}


_CE_CHUNK = 512


def _unembed_matrix(api: ModelAPI, params):
    if api.cfg.family == "audio":
        return params["lm_head"]
    return unembedding_matrix(params, api.cfg)


def text_features(cfg, features):
    """The token positions' features: a VLM's image prefix dropped."""
    if cfg.family == "vlm":
        return features[:, cfg.num_image_tokens:]
    return features


def live_leaves(tree):
    """(the leaves detached and requiring grad, the same tree over them):
    the inputs of one ``torch.autograd.grad``."""
    live = [t.detach().requires_grad_(True) for t in tree_leaves(tree)]
    return live, unflatten(tree, live)


def unflatten(tree, leaves):
    """``leaves`` (in ``tree_leaves`` order) in ``tree``'s structure."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _chunk_logprobs(xi, head, ti):
    return token_logprobs((xi @ head).float(), ti)


def chunked_token_logprobs(features, head, tokens, *, chunk: int = _CE_CHUNK):
    """Fused unembed + gather over sequence chunks.

    Never keeps (B, S, V) logits: each chunk's (B, C, V) logits (the
    product in the model dtype, then fp32) are consumed into (B, C)
    logprobs and, under autograd, recomputed in the backward pass.
    features: (B, S, D) final-norm hidden states; returns (B, S) logprobs
    aligned with ``tokens`` (position 0 zero — never a response token).
    """
    b = features.shape[0]
    x, tg = features[:, :-1], tokens[:, 1:]
    parts = []
    for lo in range(0, x.shape[1], chunk):
        xi, ti = x[:, lo:lo + chunk], tg[:, lo:lo + chunk]
        if torch.is_grad_enabled():
            parts.append(checkpoint(_chunk_logprobs, xi, head, ti,
                                    use_reentrant=False))
        else:
            parts.append(_chunk_logprobs(xi, head, ti))
    zero = torch.zeros((b, 1), dtype=torch.float32, device=features.device)
    return torch.cat([zero] + parts, dim=1)


def _policy_logprobs(api: ModelAPI, params, batch, *, attn_impl: str,
                     scan_impl: str, moe_mode: str, remat: bool = False):
    """logprobs (B, S) aligned with batch['tokens'] (position t = logprob of
    token t given <t); position 0 is zero (never a response token)."""
    features, aux = api.apply(params, batch, return_features=True,
                              attn_impl=attn_impl, scan_impl=scan_impl,
                              moe_mode=moe_mode, remat=remat)
    features = text_features(api.cfg, features)
    head = _unembed_matrix(api, params)
    return chunked_token_logprobs(features, head, batch["tokens"]), aux


def make_loss_and_grad(api: ModelAPI, loss_cfg: LossConfig, *,
                       attn_impl: str = "kernel", moe_mode: str = "ep",
                       remat: bool = False):
    """``(params, batch) -> (loss, metrics, grads)``: the train step's RL
    loss and its gradient, without the optimizer.  ``attn_impl`` picks the
    attention; the recurrent families' scans run their plain versions,
    which autograd differentiates (the scan kernels have no backward and
    refuse inputs that need one).  ``remat`` recomputes each block's
    activations in the backward (``transformer.remat_block``)."""
    def loss_and_grad(params, batch):
        live, p_req = live_leaves(params)
        logprobs, aux = _policy_logprobs(api, p_req, batch, attn_impl=attn_impl,
                                         scan_impl="ref", moe_mode=moe_mode,
                                         remat=remat)
        loss, metrics = rl_loss(logprobs, batch, loss_cfg, aux)
        grads = unflatten(params, torch.autograd.grad(loss, live))
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    return loss_and_grad


def make_train_step(api: ModelAPI, loss_cfg: LossConfig, opt_cfg: OptConfig,
                    *, remat: bool = True, microbatches: int = 1,
                    attn_impl: str = "kernel", moe_mode: str = "ep"):
    """Build the train step ``(state, batch) -> (new_state, metrics)``:
    ``make_loss_and_grad``, then AdamW.

    ``remat`` (the reference's default, True) recomputes every block's
    activations in the backward: the same loss and gradients for about one
    forward more, and only the blocks' inputs kept.  ``HostTrainer`` passes
    False, as the reference's does.

    ``microbatches > 1`` accumulates gradients over batch slices in an fp32
    accumulator divided by m: the same mean loss, 1/m the activations.
    The optimizer updates the state's fp32 master/m/v in place; the params
    of the new state are new tensors.  Metrics are 0-dim tensors (``lr`` a
    float)."""
    loss_and_grad = make_loss_and_grad(api, loss_cfg, attn_impl=attn_impl,
                                       moe_mode=moe_mode, remat=remat)

    def train_step(state, batch):
        params = state["params"]
        if microbatches > 1:
            m = microbatches
            n = batch["tokens"].shape[0]
            if n % m:
                raise ValueError(f"batch of {n} does not split into {m} microbatches")
            acc = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
            losses, metricses = [], []
            for j in range(m):
                mb = {k: v[j * n // m:(j + 1) * n // m] for k, v in batch.items()}
                loss_j, metrics_j, g = loss_and_grad(params, mb)
                tree_map(lambda a, gi: a.add_(gi.float() / m), acc, g)
                del g
                losses.append(loss_j)
                metricses.append(metrics_j)
            grads = acc
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([mt[k] for mt in metricses]).mean()
                       for k in metricses[0]}
        else:
            loss, metrics, grads = loss_and_grad(params, batch)

        dtypes = tree_map(lambda p: p.dtype, params)
        new_params, opt, opt_metrics = adamw_update(grads, state["opt"], opt_cfg,
                                                    dtypes)
        metrics = dict(metrics, **opt_metrics, loss=loss)
        return {"params": new_params, "opt": opt}, metrics

    return train_step


def make_logprob_fn(api: ModelAPI, *, attn_impl: str = "kernel",
                    moe_mode: str = "ep"):
    def logprob_fn(params, batch):
        with torch.no_grad():
            lp, _ = _policy_logprobs(api, params, batch, attn_impl=attn_impl,
                                     scan_impl=attn_impl, moe_mode=moe_mode)
        return lp

    return logprob_fn


# ---------------------------------------------------------------------------
# host-side wrapper: Samples -> padded arrays -> train steps
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainerConfig:
    max_seq_len: int = 64
    group_size: int = 8
    minibatches: int = 1           # gradient_accumulation-style splits
    ppo_epochs: int = 1            # sample reuse E
    adv_estimator: str = "grpo"    # grpo (critic-free, paper default) | gae


def _group_normalized_advantage(rewards: np.ndarray, group_size: int,
                                eps: float = 1e-6) -> np.ndarray:
    """GRPO eq. 2 in numpy, fp32, population std (as the reference's jnp)."""
    g = rewards.reshape(-1, group_size)
    mean = g.mean(axis=1, keepdims=True)
    std = g.std(axis=1, keepdims=True)
    return ((g - mean) / (std + np.float32(eps))).reshape(-1)


class HostTrainer:
    """``attn_impl`` ("kernel" or "ref") reaches both the train step and
    the logprob passes; the train step runs the recurrent families' scans
    plain (``make_train_step``).  An MoE config runs both in
    ``moe_mode="dense"``, as the reference's trainer does.
    ``adv_estimator="gae"`` trains with the critic (``train/critic.py``):
    the state gains the value head and its optimizer state."""

    def __init__(self, api: ModelAPI, seed: int, loss_cfg: LossConfig,
                 opt_cfg: OptConfig, tcfg: TrainerConfig, *,
                 ref_params=None, attn_impl: str = "kernel"):
        if attn_impl not in ("kernel", "ref"):
            raise ValueError(f"unknown attn_impl {attn_impl!r} (expected kernel | ref)")
        self.api = api
        self.loss_cfg = loss_cfg
        self.tcfg = tcfg
        moe_mode = "dense" if api.cfg.is_moe else "ep"
        if tcfg.adv_estimator == "gae":
            from repro_torch.train.critic import (make_critic_train_state,
                                                  make_critic_train_step)
            self.state = make_critic_train_state(api, seed)
            self._train_step = make_critic_train_step(
                api, loss_cfg, opt_cfg, attn_impl=attn_impl, moe_mode=moe_mode)
        elif tcfg.adv_estimator == "grpo":
            self.state = make_train_state(api, seed)
            self._train_step = make_train_step(api, loss_cfg, opt_cfg, remat=False,
                                               attn_impl=attn_impl, moe_mode=moe_mode)
        else:
            raise ValueError(f"unknown adv_estimator {tcfg.adv_estimator!r} "
                             "(expected grpo | gae)")
        self.ref_params = ref_params  # frozen copy for KL (None = no KL)
        self._logprob_fn = make_logprob_fn(api, attn_impl=attn_impl,
                                           moe_mode=moe_mode)
        self.steps_done = 0
        self.history: List[Dict[str, float]] = []

    # ------------------------------------------------------------- batching
    def build_batch(self, samples: List[Sample]) -> Dict[str, np.ndarray]:
        s_len = self.tcfg.max_seq_len
        n = len(samples)
        tokens = np.zeros((n, s_len), np.int32)
        mask = np.zeros((n, s_len), np.float32)
        old_lp = np.zeros((n, s_len), np.float32)
        for i, s in enumerate(samples):
            p = np.asarray(s.prompt_tokens, np.int32).ravel()
            r = np.asarray(s.response_tokens, np.int32).ravel()
            lp = np.asarray(s.logprobs, np.float32).ravel()
            p = p[-s_len:]
            r = r[: s_len - len(p)]
            lp = lp[: len(r)]
            tokens[i, : len(p)] = p
            tokens[i, len(p): len(p) + len(r)] = r
            mask[i, len(p): len(p) + len(r)] = 1.0
            old_lp[i, len(p): len(p) + len(r)] = lp

        rewards = np.asarray([s.reward or 0.0 for s in samples], np.float32)
        # GRPO: group-normalize within same-prompt groups; fall back to batch
        # norm when groups are ragged (agentic trajectories).
        gids = [s.group_id for s in samples]
        if n % self.tcfg.group_size == 0 and len(set(gids)) == n // self.tcfg.group_size:
            order = np.argsort(gids, kind="stable")
            inv = np.argsort(order)
            seq_adv = _group_normalized_advantage(rewards[order],
                                                  self.tcfg.group_size)[inv]
        else:
            seq_adv = (rewards - rewards.mean()) / (rewards.std() + 1e-6)
        adv = seq_adv[:, None] * mask

        batch = {
            "tokens": tokens, "mask": mask, "advantages": adv.astype(np.float32),
            "rewards": rewards,
            "old_logprobs": old_lp,
            "prox_logprobs": old_lp.copy(),
            "ref_logprobs": np.zeros_like(old_lp),
            "is_positive": (rewards > 0).astype(np.float32),
        }
        cfg = self.api.cfg
        if cfg.family == "vlm":
            batch["patches"] = np.zeros((n, cfg.num_image_tokens, cfg.d_model), np.float32)
        if cfg.family == "audio":
            batch["frames"] = np.zeros((n, cfg.encoder_frames, cfg.d_model), np.float32)
        return batch

    # --------------------------------------------------------------- train
    def train_on_samples(self, samples: List[Sample]) -> Dict[str, float]:
        device = self.api.device
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in self.build_batch(samples).items()}

        # proximal logprobs: the policy at batch-fetch time (before updates)
        if self.loss_cfg.pg_variant == "decoupled_ppo" or self.tcfg.minibatches > 1:
            batch["prox_logprobs"] = self._logprob_fn(self.state["params"], batch)
        if self.loss_cfg.kl_beta and self.ref_params is not None:
            batch["ref_logprobs"] = self._logprob_fn(self.ref_params, batch)

        n = batch["tokens"].shape[0]
        mb = max(1, self.tcfg.minibatches)
        if n % mb:
            raise ValueError(f"{n} samples do not split into {mb} minibatches")
        metrics: Dict[str, float] = {}
        for _ in range(self.tcfg.ppo_epochs):
            for j in range(mb):
                sl = slice(j * n // mb, (j + 1) * n // mb)
                mini = {k: v[sl] for k, v in batch.items()}
                self.state, m = self._train_step(self.state, mini)
                metrics = {k: float(v) for k, v in m.items()}
        self.steps_done += 1
        metrics["reward_mean"] = float(np.mean([s.reward or 0.0 for s in samples]))
        self.history.append(metrics)
        return metrics

    def get_weights(self):
        """The current params.  Each train step replaces them with new
        tensors, so a tree handed to an engine never changes under it."""
        return self.state["params"]
