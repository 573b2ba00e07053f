"""Advantage estimation: GAE (PPO) and group-normalized rewards (GRPO, eq. 2)."""
from __future__ import annotations

import torch


def gae(rewards, values, mask, *, gamma: float = 1.0, lam: float = 1.0):
    """Generalized Advantage Estimation.

    rewards/values/mask: (B, S).  values[:, t] = V(s_t); bootstrap value 0 at
    episode end (token-level MDP with terminal at last response token).
    Returns (advantages, returns), both (B, S).
    """
    b, s = rewards.shape
    next_values = torch.cat([values[:, 1:], values.new_zeros((b, 1))], dim=1)
    deltas = (rewards + gamma * next_values * mask - values) * mask
    carry = rewards.new_zeros((b,))
    advs = [None] * s
    for t in range(s - 1, -1, -1):      # the reference's reverse lax.scan
        carry = deltas[:, t] + gamma * lam * mask[:, t] * carry
        advs[t] = carry
    advantages = torch.stack(advs, dim=1) * mask
    return advantages, advantages + values


def group_normalized_advantage(rewards, group_size: int, *, eps: float = 1e-6):
    """GRPO (eq. 2): A_i = (r_i - mean_group) / std_group.

    rewards: (N,) with N = num_prompts * group_size, grouped contiguously.
    Returns per-sequence advantages (N,).  std is the population std, as
    ``jnp.std``.
    """
    n = rewards.shape[0]
    if n % group_size:
        raise ValueError(f"{n} rewards do not split into groups of {group_size}")
    g = rewards.reshape(n // group_size, group_size)
    mean = g.mean(dim=1, keepdim=True)
    std = g.std(dim=1, keepdim=True, correction=0)
    return ((g - mean) / (std + eps)).reshape(n)


def sequence_to_token_advantage(seq_adv, mask):
    """Broadcast per-sequence advantage over response tokens. mask: (B,S)."""
    return seq_adv[:, None] * mask


def reward_normalize(rewards, mode: str = "group", group_size: int = 1):
    if mode == "none":
        return rewards
    if mode == "group":
        return group_normalized_advantage(rewards, group_size)
    if mode == "batch":
        return (rewards - rewards.mean()) / (rewards.std(correction=0) + 1e-6)
    raise ValueError(mode)
