"""Off-policy objectives from the paper's §2.2 loss box.

All losses are token-level with per-sequence 1/|o| normalization (the
paper's GRPO-style averaging), masked to response tokens, and return
(scalar loss, metrics).  Sign convention: these are *losses* (minimize), the
negation of the J objectives in the paper.  ``.detach()`` stands where the
reference writes ``stop_gradient``.

Variants (``pg_variant`` in the launch config, as in the paper's appendix):
    ppo            standard clipped surrogate
    decoupled_ppo  Hilton et al. 2022: behaviour/proximal decoupling
    tis            Truncated IS (Munos et al. 2016): sg(clip(r, 0, c)) A log pi
    cispo          sg(clip(r, 1-eps_low, 1+eps_high)) A log pi
    topr           TOPR: T+ untruncated, T- truncated IS
    weighted_topr  ROLL Flash's stabilized TOPR with pos/neg weights
"""
from __future__ import annotations

import dataclasses

import torch

VARIANTS = ("ppo", "decoupled_ppo", "tis", "cispo", "topr", "weighted_topr")


@dataclasses.dataclass(frozen=True)
class LossConfig:
    pg_variant: str = "ppo"
    epsilon: float = 0.2           # PPO / decoupled-PPO clip
    eps_low: float = 0.2           # CISPO lower
    eps_high: float = 0.2          # CISPO upper (asymmetric allowed)
    c: float = 5.0                 # TIS / TOPR truncation threshold
    kl_beta: float = 0.0           # GRPO KL regularization weight
    topr_pos_weight: float = 1.0   # weighted TOPR
    topr_neg_weight: float = 1.0
    engine_mismatch_cap: float = 5.0  # eq. 12 (train-engine vs rollout-engine)
    # TIS cap for QUANTIZED rollouts (FlashRL): tightens the eq. 12
    # truncation threshold when the rollout engine generates from int8/fp8
    # weights.  None = use engine_mismatch_cap unchanged; typical quantized
    # setting: 2.0.
    tis_clip: "float | None" = None
    aux_loss_weight: float = 0.01  # MoE load-balance
    z_loss_weight: float = 0.001


def _masked_seq_mean(x, mask):
    """Per-sequence 1/|o| token average, then batch mean."""
    tok = (x * mask).sum(-1) / torch.clamp(mask.sum(-1), min=1.0)
    return tok.mean()


def kl_k3(logprobs, ref_logprobs, mask):
    """Schulman k3 estimator of KL(pi_theta || pi_ref), per-token >= 0."""
    d = ref_logprobs - logprobs
    return _masked_seq_mean(torch.exp(d) - d - 1.0, mask)


def engine_mismatch_weight(train_logprobs, rollout_logprobs, cap,
                           tis_clip=None):
    """Eq. 12: min(pi_train/pi_rollout, C), no gradient.

    ``tis_clip`` tightens the cap when set: the effective threshold is
    min(cap, tis_clip), or tis_clip alone when ``cap`` is None."""
    if tis_clip is not None:
        cap = tis_clip if cap is None else min(cap, tis_clip)
    r = torch.exp(train_logprobs.detach() - rollout_logprobs)
    return torch.clamp(r, max=cap)


def policy_loss(logprobs, old_logprobs, prox_logprobs, advantages, mask,
                is_positive, cfg: LossConfig):
    """Token-level off-policy policy-gradient loss.

    logprobs:      (B,S) log pi_theta(o_t|...)   — differentiable
    old_logprobs:  (B,S) behaviour policy (stale rollout policy), constant
    prox_logprobs: (B,S) proximal policy (decoupled PPO), constant
    advantages:    (B,S) token advantages (already broadcast)
    mask:          (B,S) response-token mask
    is_positive:   (B,)  TOPR T+/T- indicator (1.0 = positive trajectory)
    """
    v = cfg.pg_variant
    ratio = torch.exp(logprobs - old_logprobs)
    metrics = {}

    if v == "ppo":
        clipped = torch.clamp(ratio, 1.0 - cfg.epsilon, 1.0 + cfg.epsilon)
        obj = torch.minimum(ratio * advantages, clipped * advantages)
        metrics["clip_frac"] = _masked_seq_mean(
            ((ratio - 1.0).abs() > cfg.epsilon).float(), mask)
    elif v == "decoupled_ppo":
        # min( R r_theta/old , R (prox/old) clip(r_theta/prox, 1±eps) )
        behaviour = torch.exp(prox_logprobs - old_logprobs)  # constant
        r_prox = torch.exp(logprobs - prox_logprobs)
        clipped = torch.clamp(r_prox, 1.0 - cfg.epsilon, 1.0 + cfg.epsilon)
        obj = torch.minimum(ratio * advantages, behaviour * clipped * advantages)
        metrics["clip_frac"] = _masked_seq_mean(
            ((r_prox - 1.0).abs() > cfg.epsilon).float(), mask)
    elif v == "tis":
        w = torch.clamp(ratio, 0.0, cfg.c).detach()
        obj = w * advantages * logprobs
        metrics["trunc_frac"] = _masked_seq_mean((ratio > cfg.c).float(), mask)
    elif v == "cispo":
        w = torch.clamp(ratio, 1.0 - cfg.eps_low, 1.0 + cfg.eps_high).detach()
        obj = w * advantages * logprobs
        metrics["trunc_frac"] = _masked_seq_mean(
            ((ratio > 1.0 + cfg.eps_high) | (ratio < 1.0 - cfg.eps_low)).float(),
            mask)
    elif v in ("topr", "weighted_topr"):
        w_pos = cfg.topr_pos_weight if v == "weighted_topr" else 1.0
        w_neg = cfg.topr_neg_weight if v == "weighted_topr" else 1.0
        trunc = torch.clamp(ratio, 0.0, cfg.c).detach()
        pos = is_positive[:, None]
        w = w_pos * pos + w_neg * (1.0 - pos) * trunc
        obj = w * advantages * logprobs
        metrics["trunc_frac"] = _masked_seq_mean(
            ((1.0 - pos) * (ratio > cfg.c)).float(), mask)
    else:
        raise ValueError(f"unknown pg_variant {v!r}")

    loss = -_masked_seq_mean(obj, mask)
    metrics.update(
        ratio_mean=_masked_seq_mean(ratio, mask),
        ratio_max=torch.where(mask > 0, ratio, torch.zeros_like(ratio)).max(),
    )
    return loss, metrics
