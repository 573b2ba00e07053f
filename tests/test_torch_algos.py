"""The port's RL objectives and advantages against the JAX package's, on the
same numpy inputs.  Values, metrics and gradients with respect to the
logprobs agree within 1e-6 (fp32, elementwise math and short reductions:
only the summation order differs)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import algos as jalgos
from repro_torch import algos

# tiny shapes: one torch thread, so the suite's parallel workers keep their
# cores (torch's pool would otherwise spin on all of them)
torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-6)


def _batch(seed, b=4, s=12):
    rng = np.random.default_rng(seed)
    mask = np.zeros((b, s), np.float32)
    for i in range(b):
        lo = int(rng.integers(1, s // 2))
        mask[i, lo:lo + int(rng.integers(1, s - lo + 1))] = 1.0
    mask[0] = 0.0           # an empty row: the 1/max(|o|, 1) guard
    old = (rng.normal(size=(b, s)) - 2.0).astype(np.float32)
    return {
        "logprobs": (old + rng.normal(scale=0.5, size=(b, s))).astype(np.float32),
        "old_logprobs": old,
        "prox_logprobs": (old + rng.normal(scale=0.3, size=(b, s))).astype(np.float32),
        "ref_logprobs": (old + rng.normal(scale=0.3, size=(b, s))).astype(np.float32),
        "advantages": (rng.normal(size=(b, 1)) * mask).astype(np.float32),
        "mask": mask,
        "is_positive": (rng.random(b) > 0.5).astype(np.float32),
    }


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close_metrics(want, got):
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_allclose(np.asarray(want[k]), got[k].detach().numpy(),
                                   err_msg=k, **TOL)


@pytest.mark.parametrize("variant", jalgos.VARIANTS)
def test_policy_loss_values_metrics_and_grad(variant):
    assert algos.VARIANTS == jalgos.VARIANTS
    b = _batch(0)
    jcfg = jalgos.LossConfig(pg_variant=variant, topr_pos_weight=0.7,
                             topr_neg_weight=1.3, c=1.5)
    tcfg = algos.LossConfig(**dataclasses.asdict(jcfg))
    keys = ("old_logprobs", "prox_logprobs", "advantages", "mask", "is_positive")

    def jloss(lp):
        return jalgos.policy_loss(lp, *(jnp.asarray(b[k]) for k in keys), jcfg)

    (want, wm), wgrad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(b["logprobs"]))
    lp = torch.from_numpy(b["logprobs"]).requires_grad_(True)
    got, gm = algos.policy_loss(lp, *(torch.from_numpy(b[k]) for k in keys), tcfg)
    got.backward()
    np.testing.assert_allclose(np.asarray(want), got.item(), **TOL)
    _close_metrics(wm, gm)
    np.testing.assert_allclose(np.asarray(wgrad), lp.grad.numpy(), **TOL)


def test_policy_loss_refuses_unknown_variant():
    b = _t(_batch(1))
    with pytest.raises(ValueError, match="pg_variant"):
        algos.policy_loss(b["logprobs"], b["old_logprobs"], b["prox_logprobs"],
                          b["advantages"], b["mask"], b["is_positive"],
                          algos.LossConfig(pg_variant="reinforce"))


@pytest.mark.parametrize("kl_beta,tis_clip,cap,aux", [
    (0.0, None, 5.0, False),
    (0.05, None, 5.0, True),      # KL on, MoE aux terms added (zero for dense)
    (0.05, 1.2, 5.0, False),      # tis_clip tightens the eq. 12 cap
    (0.0, 1.1, None, True),       # tis_clip alone
    (0.0, None, None, False),     # no mismatch weight at all
])
@pytest.mark.parametrize("variant", ["ppo", "decoupled_ppo", "topr"])
def test_rl_loss_matches(variant, kl_beta, tis_clip, cap, aux):
    b = _batch(2)
    jcfg = jalgos.LossConfig(pg_variant=variant, kl_beta=kl_beta,
                             tis_clip=tis_clip, engine_mismatch_cap=cap)
    tcfg = algos.LossConfig(**dataclasses.asdict(jcfg))
    jb, tb = _j(b), _t(b)
    jaux = ({"load_balance_loss": jnp.float32(0.3), "router_z_loss": jnp.float32(0.2)}
            if aux else None)
    taux = ({"load_balance_loss": torch.tensor(0.3), "router_z_loss": torch.tensor(0.2)}
            if aux else None)

    (want, wm), wgrad = jax.value_and_grad(
        lambda lp: jalgos.rl_loss(lp, jb, jcfg, jaux), has_aux=True)(jb["logprobs"])
    lp = tb["logprobs"].clone().requires_grad_(True)
    got, gm = algos.rl_loss(lp, tb, tcfg, taux)
    got.backward()
    np.testing.assert_allclose(np.asarray(want), got.item(), **TOL)
    _close_metrics(wm, gm)
    np.testing.assert_allclose(np.asarray(wgrad), lp.grad.numpy(), **TOL)


def test_token_logprobs_and_kl_k3():
    rng = np.random.default_rng(3)
    logits = (rng.normal(size=(3, 7, 11)) * 4).astype(np.float32)
    toks = rng.integers(0, 11, (3, 7)).astype(np.int32)
    want = jalgos.token_logprobs(jnp.asarray(logits), jnp.asarray(toks))
    got = algos.token_logprobs(torch.from_numpy(logits), torch.from_numpy(toks))
    np.testing.assert_allclose(np.asarray(want), got.numpy(), **TOL)
    b = _batch(4)
    np.testing.assert_allclose(
        np.asarray(jalgos.kl_k3(*(jnp.asarray(b[k]) for k in
                                  ("logprobs", "ref_logprobs", "mask")))),
        algos.kl_k3(*(torch.from_numpy(b[k]) for k in
                      ("logprobs", "ref_logprobs", "mask"))).item(), **TOL)


@pytest.mark.parametrize("gamma,lam", [(1.0, 1.0), (0.99, 0.95)])
def test_gae(gamma, lam):
    b = _batch(5)
    rng = np.random.default_rng(6)
    rewards = (rng.normal(size=b["mask"].shape) * b["mask"]).astype(np.float32)
    values = rng.normal(size=b["mask"].shape).astype(np.float32)
    wa, wr = jalgos.gae(jnp.asarray(rewards), jnp.asarray(values),
                        jnp.asarray(b["mask"]), gamma=gamma, lam=lam)
    ga, gr = algos.gae(torch.from_numpy(rewards), torch.from_numpy(values),
                       torch.from_numpy(b["mask"]), gamma=gamma, lam=lam)
    np.testing.assert_allclose(np.asarray(wa), ga.numpy(), **TOL)
    np.testing.assert_allclose(np.asarray(wr), gr.numpy(), **TOL)


@pytest.mark.parametrize("mode", ["none", "group", "batch"])
def test_advantage_helpers(mode):
    rng = np.random.default_rng(7)
    rewards = rng.normal(size=(12,)).astype(np.float32)
    rewards[4:8] = 1.0                                   # a constant group
    want = jalgos.reward_normalize(jnp.asarray(rewards), mode, group_size=4)
    got = algos.reward_normalize(torch.from_numpy(rewards), mode, group_size=4)
    np.testing.assert_allclose(np.asarray(want), got.numpy(), **TOL)
    seq = rng.normal(size=(3,)).astype(np.float32)
    mask = (rng.random((3, 5)) > 0.5).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(jalgos.sequence_to_token_advantage(jnp.asarray(seq), jnp.asarray(mask))),
        algos.sequence_to_token_advantage(torch.from_numpy(seq),
                                          torch.from_numpy(mask)).numpy(), **TOL)
    with pytest.raises(ValueError):
        algos.reward_normalize(torch.from_numpy(rewards), "rank")
