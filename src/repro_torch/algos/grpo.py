"""Full RL objective (GRPO eq. 3 generalized over pg_variants).

loss = policy_loss(variant) + beta * KL(pi || pi_ref) + moe aux losses
with optional engine-mismatch truncated IS (eq. 12) folded into advantages.
"""
from __future__ import annotations

from repro_torch.algos.off_policy import (LossConfig, engine_mismatch_weight,
                                          kl_k3, policy_loss)
from repro_torch.models import sharding as shd


def token_logprobs(logits, tokens):
    """Gather log-softmax probabilities of realized tokens, with the
    reference's max-shifted log-sum-exp.

    logits: (B, S, V) fp32 *aligned with tokens* (logits[t] predicts tokens[t])
    tokens: (B, S) int
    """
    if shd.ON_DTENSORS:
        return shd.vocab_logprobs(logits, tokens)
    mx = logits.max(-1, keepdim=True).values
    logz = (logits - mx).exp().sum(-1).log()
    picked = logits.gather(-1, tokens[..., None].long())[..., 0]
    return picked - (logz + mx[..., 0])


def rl_loss(logprobs, batch, cfg: LossConfig, aux=None):
    """batch: dict with old_logprobs, prox_logprobs, ref_logprobs, advantages,
    mask, is_positive."""
    adv = batch["advantages"]
    if cfg.engine_mismatch_cap is not None or cfg.tis_clip is not None:
        adv = adv * engine_mismatch_weight(logprobs, batch["old_logprobs"],
                                           cfg.engine_mismatch_cap,
                                           tis_clip=cfg.tis_clip)
    loss, metrics = policy_loss(
        logprobs, batch["old_logprobs"], batch["prox_logprobs"], adv,
        batch["mask"], batch["is_positive"], cfg)
    if cfg.kl_beta:
        kl = kl_k3(logprobs, batch["ref_logprobs"], batch["mask"])
        loss = loss + cfg.kl_beta * kl
        metrics["kl"] = kl
    if aux is not None:
        # zero for dense models, added all the same, as in the reference
        loss = (loss
                + cfg.aux_loss_weight * aux["load_balance_loss"]
                + cfg.z_loss_weight * aux["router_z_loss"])
        metrics["load_balance_loss"] = aux["load_balance_loss"]
    metrics["policy_loss"] = loss
    return loss, metrics
