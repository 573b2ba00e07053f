"""The port's sampler against the JAX package's.

Greedy is deterministic, so tokens and logprobs must match.  Stochastic
draws cannot match token for token (``jax.random`` and ``torch.Generator``
differ), so for those the logprob the port returns for its own token must
equal the one the JAX sampler gives that same token: the JAX sampler is run
with its categorical draw replaced by the port's tokens."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.rollout import sampler as jsampler
from repro_torch.rollout.sampler import sample_tokens

# tiny shapes: one torch thread, so the suite's parallel workers keep their
# cores (torch's pool would otherwise spin on all of them)
torch.set_num_threads(1)


def _logits(seed=0, b=6, v=50):
    logits = np.random.default_rng(seed).normal(size=(b, v)).astype(np.float32) * 3
    logits[1, [4, 9]] = logits[1].max() + 1.0      # a tie: first index wins
    return logits


def test_greedy_tokens_and_logprobs_match():
    logits = _logits()
    jt, jl = jsampler.sample_tokens(jax.random.PRNGKey(0), jnp.asarray(logits),
                                    temperature=0.0)
    tt, tl = sample_tokens(torch.Generator().manual_seed(0), torch.from_numpy(logits),
                           temperature=0.0)
    assert tt.tolist() == np.asarray(jt).tolist()
    assert int(tt[1]) == 4
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, 0, 1.0),       # rollout: raw distribution
    (0.7, 0, 1.0),
    (1.0, 5, 1.0),
    (0.8, 0, 0.9),
    (1.3, 10, 0.8),
])
def test_sampled_logprobs_follow_the_jax_masked_distribution(
        monkeypatch, temperature, top_k, top_p):
    logits = _logits(1)
    tt, tl = sample_tokens(torch.Generator().manual_seed(7), torch.from_numpy(logits),
                           temperature=temperature, top_k=top_k, top_p=top_p)
    monkeypatch.setattr(jax.random, "categorical",
                        lambda key, lg, axis=-1: jnp.asarray(tt.numpy()))
    jt, jl = jsampler.sample_tokens(jax.random.PRNGKey(0), jnp.asarray(logits),
                                    temperature=temperature, top_k=top_k,
                                    top_p=top_p)
    assert np.asarray(jt).tolist() == tt.tolist()
    assert np.isfinite(tl.numpy()).all(), "the port drew a masked-out token"
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)


def test_sampling_is_seeded_and_follows_the_distribution():
    logits = torch.log(torch.tensor([[0.7, 0.2, 0.1, 0.0]])).expand(20000, 4)
    a, _ = sample_tokens(torch.Generator().manual_seed(3), logits)
    b, _ = sample_tokens(torch.Generator().manual_seed(3), logits)
    assert torch.equal(a, b)
    freq = torch.bincount(a, minlength=4).float() / a.numel()
    np.testing.assert_allclose(freq.numpy(), [0.7, 0.2, 0.1, 0.0], atol=0.015)
