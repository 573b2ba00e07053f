"""Token sampling.

Rollout uses temperature=1, top_p=1 so the engine emits the *raw* token
distribution — the recorded logprobs are the true behaviour policy.
Temperature/top-k/top-p are still supported for evaluation-time decoding.

Random draws come from an explicit ``torch.Generator`` (Gumbel-max over the
masked, tempered logits), so sampling never synchronises with the host.
The tokens differ from ``jax.random``'s for the same seed; the logprob of
whichever token is drawn follows the same rules as the JAX package.
"""
from __future__ import annotations

import torch


def sample_tokens(gen: torch.Generator, logits, *, temperature: float = 1.0,
                  top_k: int = 0, top_p: float = 1.0):
    """logits: (B, V) fp32. Returns (tokens (B,) int64, logprobs (B,) fp32).

    logprobs are of the *untempered* distribution when temperature == 1.0
    and top_p == 1.0 (the paper's raw-logits requirement); otherwise of the
    sampling distribution actually used.  Greedy picks the first index among
    ties.
    """
    if temperature <= 0.0:  # greedy
        tokens = torch.argmax(logits, dim=-1)
        lp = torch.log_softmax(logits, dim=-1)
        return tokens, torch.gather(lp, 1, tokens[:, None])[:, 0]

    scaled = logits / temperature
    if top_k and top_k < logits.shape[-1]:
        kth = torch.sort(scaled, dim=-1).values[:, -top_k][:, None]
        scaled = torch.where(scaled < kth, -torch.inf, scaled)
    if top_p < 1.0:
        # nucleus: mask tokens outside the smallest set with cum prob >= p
        sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # keep everything strictly before the cutoff plus the cutoff token
        cutoff_idx = torch.argmax((cum >= top_p).to(torch.int32), dim=-1)
        cutoff_logit = torch.gather(sorted_logits, 1, cutoff_idx[:, None])
        scaled = torch.where(scaled < cutoff_logit, -torch.inf, scaled)
    u = torch.rand(scaled.shape, generator=gen, device=scaled.device,
                   dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u))
    tokens = torch.argmax(scaled + gumbel, dim=-1)
    lp = torch.log_softmax(scaled, dim=-1)
    return tokens, torch.gather(lp, 1, tokens[:, None])[:, 0]
