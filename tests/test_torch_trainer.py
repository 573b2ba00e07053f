"""The port's trainer against the JAX package's, from the same params and
the same batch: one ``make_train_step`` per loss variant (and with
microbatches), ``HostTrainer.build_batch`` and two ``train_on_samples``
calls; plus the weight-sync hazard an in-place optimizer would bring.

Tolerance: 1e-5 relative / 1e-6 absolute on every number (fp32 tiny
config; only the summation order of the forward, the backward and the
global norm differs).  build_batch is exact."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny
from repro import algos as jalgos
from repro.core.types import Sample as JSample
from repro.models import get_api as jget_api
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch import algos
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core.types import Sample
from repro_torch.models import get_api
from repro_torch.models.config import ModelConfig
from repro_torch.rollout import PagedDecodeEngine
from repro_torch.train import HostTrainer, OptConfig, TrainerConfig, make_train_step
from repro_torch.train.optimizer import init_opt_state

# tiny shapes: one torch thread, so the suite's parallel workers keep their
# cores (torch's pool would otherwise spin on all of them)
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
# A step large enough to move fp32 params visibly, weight decay on.  Adam
# divides each gradient by its own size: the update is lr * g / (|g| + eps)
# at the first step, so the summation-order noise of the gradients (~1e-8
# absolute here, measured) reaches the params as lr * noise / eps.  With
# eps 1e-3 that is ~1e-7, inside TOL, while the updates themselves are
# ~1e-3: the params are compared at a scale where a wrong update shows.
OPT = dict(learning_rate=1e-2, warmup_steps=2, weight_decay=0.1, eps=1e-3)


@pytest.fixture(scope="module")
def models():
    cfg = tiny("qwen3-4b", dtype="float32")
    japi = jget_api(cfg)
    jp = japi.init(jax.random.PRNGKey(0))
    npp = jax.tree_util.tree_map(np.asarray, jp)
    tapi = get_api(ModelConfig(**dataclasses.asdict(cfg)), device="cpu")
    return cfg, japi, jp, npp, tapi


def _batch(japi, jp, seed, b=4, s=16):
    """A train batch whose behaviour logprobs sit near the policy's."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, japi.cfg.vocab_size, (b, s)).astype(np.int32)
    mask = np.zeros((b, s), np.float32)
    for i in range(b):
        lo = int(rng.integers(3, 8))
        mask[i, lo:lo + int(rng.integers(2, s - lo + 1))] = 1.0
    lp = np.asarray(jtrainer.make_logprob_fn(japi)(jp, {"tokens": jnp.asarray(tokens)}))
    old = ((lp + rng.normal(scale=0.2, size=lp.shape)) * mask).astype(np.float32)
    rewards = rng.normal(size=(b,)).astype(np.float32)
    return {
        "tokens": tokens, "mask": mask,
        "advantages": (rewards[:, None] * mask).astype(np.float32),
        "rewards": rewards,
        "old_logprobs": old,
        "prox_logprobs": ((lp + rng.normal(scale=0.1, size=lp.shape)) * mask
                          ).astype(np.float32),
        "ref_logprobs": ((lp + rng.normal(scale=0.1, size=lp.shape)) * mask
                         ).astype(np.float32),
        "is_positive": (rewards > 0).astype(np.float32),
    }


def _close_tree(want, got, what):
    jl = jax.tree_util.tree_leaves_with_path(want)
    gl = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(jl) == len(gl), what
    for path, w in jl:
        np.testing.assert_allclose(np.asarray(w, np.float32), gl[path],
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}", **TOL)


@pytest.mark.parametrize("variant,microbatches", [(v, 1) for v in jalgos.VARIANTS]
                         + [("decoupled_ppo", 2)])
def test_train_step_matches(models, variant, microbatches):
    cfg, japi, jp, npp, tapi = models
    jloss = jalgos.LossConfig(pg_variant=variant, kl_beta=0.05, tis_clip=3.0)
    jstep = jax.jit(jtrainer.make_train_step(
        japi, jloss, jopt.OptConfig(**OPT), remat=False, microbatches=microbatches))
    batch = _batch(japi, jp, 1)
    jstate, jm = jstep({"params": jp, "opt": jopt.init_opt_state(jp)},
                       {k: jnp.asarray(v) for k, v in batch.items()})

    tp = params_from_jax(npp, "cpu")
    tstep = make_train_step(tapi, algos.LossConfig(**dataclasses.asdict(jloss)),
                            OptConfig(**OPT), microbatches=microbatches)
    tstate, tm = tstep({"params": tp, "opt": init_opt_state(tp)},
                       {k: torch.from_numpy(v) for k, v in batch.items()})

    assert set(jm) == set(tm)
    for k in jm:
        np.testing.assert_allclose(np.asarray(jm[k]), float(tm[k]), err_msg=k, **TOL)
    assert float(tm["lr"]) == pytest.approx(5e-3)
    _close_tree(jstate["params"], params_to_numpy(tstate["params"]), "params")
    for key in ("master", "m", "v"):
        _close_tree(jstate["opt"][key], params_to_numpy(tstate["opt"][key]), key)
    assert tstate["opt"]["step"] == int(jstate["opt"]["step"]) == 1
    # new params are new tensors; norm scales stay fp32
    assert tstate["params"]["blocks"][0]["attn"]["wq"] is not tp["blocks"][0]["attn"]["wq"]
    assert tstate["params"]["blocks"][0]["attn"]["q_norm"].dtype == torch.float32


def test_optimizer_keeps_each_leaf_dtype_and_never_aliases_the_master():
    params = {"w": torch.ones(3, 2, dtype=torch.bfloat16),
              "blocks": [{"scale": torch.ones(2)}]}
    from repro_torch.train.optimizer import adamw_update
    state = init_opt_state(params)
    grads = {"w": torch.full((3, 2), 0.5, dtype=torch.bfloat16),
             "blocks": [{"scale": torch.full((2,), -0.5)}]}
    dtypes = {"w": torch.bfloat16, "blocks": [{"scale": torch.float32}]}
    new, state, m = adamw_update(grads, state, OptConfig(learning_rate=0.1,
                                                         warmup_steps=1), dtypes)
    assert new["w"].dtype == torch.bfloat16 and new["blocks"][0]["scale"].dtype == torch.float32
    assert new["blocks"][0]["scale"].data_ptr() != state["master"]["blocks"][0]["scale"].data_ptr()
    assert float(m["grad_norm"]) == pytest.approx(np.sqrt(6 * 0.25 + 2 * 0.25))
    assert m["lr"] == pytest.approx(0.1) and state["step"] == 1


# ---------------------------------------------------------------------------
# HostTrainer
# ---------------------------------------------------------------------------

def _samples(vocab, seed, groups=2, group_size=4, ragged=False):
    rng = np.random.default_rng(seed)
    out = []
    for g in range(groups):
        prompt = rng.integers(0, vocab, int(rng.integers(3, 9))).astype(np.int32)
        for j in range(group_size - (1 if ragged and g == 0 else 0)):
            r = rng.integers(0, vocab, int(rng.integers(2, 12))).astype(np.int32)
            out.append(dict(sample_id=len(out), prompt_id=g, replica_idx=j,
                            prompt_tokens=prompt, response_tokens=r,
                            logprobs=(-rng.random(len(r)) * 3).astype(np.float32),
                            reward=float(rng.integers(0, 2)), group_id=g))
    rng.shuffle(out)                  # groups interleaved: the argsort path
    return out


def _trainers(models, tcfg_kw, loss_kw, ref=False):
    cfg, japi, jp, npp, tapi = models
    ref_j = jax.tree_util.tree_map(lambda x: x * 0.9, jp) if ref else None
    jt = jtrainer.HostTrainer(japi, jax.random.PRNGKey(1),
                              jalgos.LossConfig(**loss_kw), jopt.OptConfig(**OPT),
                              jtrainer.TrainerConfig(**tcfg_kw), ref_params=ref_j)
    jt.state = {"params": jp, "opt": jopt.init_opt_state(jp)}
    ref_t = (params_from_jax(jax.tree_util.tree_map(np.asarray, ref_j), "cpu")
             if ref else None)
    tt = HostTrainer(tapi, 1, algos.LossConfig(**loss_kw), OptConfig(**OPT),
                     TrainerConfig(**tcfg_kw), ref_params=ref_t)
    tp = params_from_jax(npp, "cpu")
    tt.state = {"params": tp, "opt": init_opt_state(tp)}
    return jt, tt


@pytest.mark.parametrize("ragged", [False, True])
def test_build_batch_is_exact(models, ragged):
    jt, tt = _trainers(models, dict(max_seq_len=12, group_size=4), {})
    raw = _samples(64, 2, ragged=ragged)
    want = jt.build_batch([JSample(**s) for s in raw])
    got = tt.build_batch([Sample(**s) for s in raw])
    assert set(want) == set(got)
    for k in want:
        assert want[k].dtype == got[k].dtype, k
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)


def test_train_on_samples_matches_twice(models):
    tcfg = dict(max_seq_len=16, group_size=4, minibatches=2)
    loss = dict(pg_variant="decoupled_ppo", kl_beta=0.05)
    jt, tt = _trainers(models, tcfg, loss, ref=True)
    for call in range(2):
        raw = _samples(64, 10 + call)
        wm = jt.train_on_samples([JSample(**s) for s in raw])
        gm = tt.train_on_samples([Sample(**s) for s in raw])
        assert set(wm) == set(gm)
        for k in wm:
            np.testing.assert_allclose(wm[k], gm[k], err_msg=f"call {call} {k}", **TOL)
    _close_tree(jt.get_weights(), params_to_numpy(tt.get_weights()), "params")
    assert tt.steps_done == 2 and tt.state["opt"]["step"] == 4


def test_gae_estimator_is_a_later_slice(models):
    with pytest.raises(NotImplementedError, match="critic"):
        HostTrainer(models[4], 0, algos.LossConfig(), OptConfig(),
                    TrainerConfig(adv_estimator="gae"))


def test_a_synced_engine_keeps_its_weights_through_a_train_step(models):
    """JAX arrays are immutable, so the reference's get_weights() hands out
    a tree no later step can change.  The port's optimizer updates master,
    m and v in place: the tree an engine was synced with must stay
    bit-unchanged while the trainer moves on."""
    cfg, japi, jp, npp, tapi = models
    tt = HostTrainer(tapi, 3, algos.LossConfig(), OptConfig(**OPT),
                     TrainerConfig(max_seq_len=16, group_size=4))
    eng = PagedDecodeEngine(tapi, tt.get_weights(), num_slots=2, max_total_len=32,
                            page_size=8, prefill_chunk=8, device="cpu")
    held = eng.params
    snapshot = [t.clone() for t in jax.tree_util.tree_leaves(held)]
    tt.train_on_samples([Sample(**s) for s in _samples(64, 4)])
    after = jax.tree_util.tree_leaves(eng.params)
    assert eng.params is held
    assert all(torch.equal(a, b) for a, b in zip(snapshot, after))
    new = jax.tree_util.tree_leaves(tt.get_weights())
    assert not all(torch.equal(a, b) for a, b in zip(snapshot, new))
    eng.update_weights(tt.get_weights())
    assert all(torch.equal(a, b) for a, b in
               zip(jax.tree_util.tree_leaves(eng.params), new))


@pytest.mark.parametrize("chunk", [4, 7, 512])
def test_chunked_token_logprobs_and_grads_match(chunk):
    from repro_torch.train.trainer import chunked_token_logprobs
    rng = np.random.default_rng(8)
    feats = rng.normal(size=(2, 15, 8)).astype(np.float32)
    head = rng.normal(size=(8, 11)).astype(np.float32)
    toks = rng.integers(0, 11, (2, 15)).astype(np.int32)
    w = rng.normal(size=(2, 15)).astype(np.float32)

    def jf(f, h):
        return (jtrainer.chunked_token_logprobs(f, h, jnp.asarray(toks), chunk=chunk)
                * w).sum()

    want, (gf, gh) = jax.value_and_grad(jf, argnums=(0, 1))(jnp.asarray(feats),
                                                            jnp.asarray(head))
    tf, th = (torch.from_numpy(a).requires_grad_(True) for a in (feats, head))
    lp = chunked_token_logprobs(tf, th, torch.from_numpy(toks), chunk=chunk)
    assert lp.shape == (2, 15) and not lp[:, 0].detach().any()
    total = (lp * torch.from_numpy(w)).sum()
    total.backward()
    np.testing.assert_allclose(np.asarray(want), total.item(), **TOL)
    np.testing.assert_allclose(np.asarray(gf), tf.grad.numpy(), **TOL)
    np.testing.assert_allclose(np.asarray(gh), th.grad.numpy(), **TOL)
