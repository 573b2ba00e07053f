"""Actor-critic PPO (the paper's §2.1 PPO formulation, with GAE).

GRPO is the paper's default (critic-free); this module provides the PPO
alternative: a value head on the trunk features, GAE token advantages from
the terminal verifiable reward, and a clipped value loss — selectable via
``TrainerConfig.adv_estimator = "gae"``.

The port of the JAX package's ``train/critic.py``, in the idiom of
``make_train_step``: ``jax.random`` keys are ``torch.Generator`` seeds,
``stop_gradient`` is ``.detach()``, and one ``torch.autograd.grad`` gives
the gradients of the params and of the value head, so the value loss
reaches the trunk too.  The recurrent families' scans run plain in the
step (their kernels have no backward), an MoE config runs
``moe_mode="dense"``, a VLM drops its image positions' features before
the value head and the logprobs, and an enc-dec unembeds through
``lm_head``, as in the reference.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.algos import LossConfig, gae, rl_loss
from repro_torch.models.api import ModelAPI
from repro_torch.train.optimizer import OptConfig, adamw_update, init_opt_state, tree_map
from repro_torch.train.trainer import (_unembed_matrix, chunked_token_logprobs,
                                       live_leaves, text_features, unflatten)


def init_value_head(generator: torch.Generator, d_model: int, device) -> Dict[str, Any]:
    w = torch.randn((d_model, 1), generator=generator, dtype=torch.float32,
                    device=device) * (d_model ** -0.5)
    return {"w": w, "b": torch.zeros((1,), dtype=torch.float32, device=device)}


def value_apply(vh, features):
    """features: (B, S, D) -> values (B, S) fp32."""
    return (features.float() @ vh["w"] + vh["b"])[..., 0]


def make_critic_train_step(api: ModelAPI, loss_cfg: LossConfig,
                           opt_cfg: OptConfig, *, gamma: float = 1.0,
                           lam: float = 1.0, vf_coef: float = 0.5,
                           attn_impl: str = "kernel", moe_mode: str = "ep",
                           remat: bool = False):
    """PPO train step with a learned critic.

    State: {"params", "value", "opt", "vopt"}.  The batch carries `rewards`
    (B,) terminal rewards instead of precomputed `advantages`; GAE runs
    inside the step (token reward = terminal reward at the last response
    token).  Metrics are 0-dim tensors (``lr`` a float).
    """
    cfg = api.cfg

    def train_step(state, batch):
        mask = batch["mask"]
        b, s = mask.shape
        # terminal token reward: the last response position of each row
        pos = torch.arange(s, device=mask.device, dtype=mask.dtype)
        last = (mask * pos[None, :]).amax(dim=1).clamp(min=0).long()
        token_rewards = torch.zeros_like(mask)
        token_rewards[torch.arange(b, device=mask.device), last] = batch["rewards"]
        denom = mask.sum().clamp(min=1.0)

        live_p, params = live_leaves(state["params"])
        live_v, vh = live_leaves(state["value"])
        features, aux = api.apply(params, batch, return_features=True,
                                  attn_impl=attn_impl, scan_impl="ref",
                                  moe_mode=moe_mode, remat=remat)
        features = text_features(cfg, features)
        head = _unembed_matrix(api, params)
        logprobs = chunked_token_logprobs(features, head, batch["tokens"])
        values = value_apply(vh, features) * mask

        advantages, returns = gae(token_rewards, values.detach(), mask,
                                  gamma=gamma, lam=lam)
        mean = (advantages * mask).sum() / denom
        var = ((advantages - mean).square() * mask).sum() / denom
        adv_batch = dict(batch)
        adv_batch["advantages"] = (advantages - mean) * torch.rsqrt(var + 1e-8) * mask

        pg_loss, metrics = rl_loss(logprobs, adv_batch, loss_cfg, aux)
        v_loss = ((values - returns).square() * mask).sum() / denom
        metrics["value_loss"] = v_loss
        metrics["explained_value"] = values.sum() / denom
        loss = pg_loss + vf_coef * v_loss

        grads = torch.autograd.grad(loss, live_p + live_v)
        g_p = unflatten(state["params"], grads[:len(live_p)])
        g_v = unflatten(state["value"], grads[len(live_p):])
        del grads, features, values, logprobs
        dtypes = tree_map(lambda p: p.dtype, state["params"])
        params, opt, m1 = adamw_update(g_p, state["opt"], opt_cfg, dtypes)
        vdtypes = tree_map(lambda p: p.dtype, state["value"])
        value, vopt, _ = adamw_update(g_v, state["vopt"], opt_cfg, vdtypes)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics = dict(metrics, **m1, loss=loss.detach())
        return {"params": params, "value": value, "opt": opt, "vopt": vopt}, metrics

    return train_step


def make_critic_train_state(api: ModelAPI, seed: int) -> Dict[str, Any]:
    """The params from ``api.init(seed)``, the value head from a generator
    of its own seeded with ``seed + 1`` on the API's device."""
    params = api.init(seed)
    gen = torch.Generator(device=api.device).manual_seed(seed + 1)
    vh = init_value_head(gen, api.cfg.d_model, api.device)
    return {"params": params, "value": vh,
            "opt": init_opt_state(params), "vopt": init_opt_state(vh)}
