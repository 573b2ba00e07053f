"""The port's VLM family (PaliGemma: ``family="vlm"``) against the JAX
package, on the same weights (carried across by ``params_from_jax``) and
the same numpy-seeded inputs: ``apply`` with patches (fp32 and bf16, the
Gemma embed scale rounded to bf16 bit for bit), prefill with patches (and
right-padded ``valid``) then decode at ``t + P``, the slot engine's greedy
tokens (text-only, on a cache widened by ``num_image_tokens``), pass@k,
one ``HostTrainer`` step (GRPO and GAE), the zero patches' gradient
overflow at full depth (a property of the reference, pinned) and one
pipeline step.

Tolerances: fp32 logits, caches and logprobs 1e-5; bf16 logits 2e-2;
tokens exact; trainer params 1e-5 relative / 1e-6 absolute at AdamW eps
1e-3 (``test_torch_trainer.py`` says why)."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny
from repro import algos as jalgos
from repro.core.types import Sample as JSample
from repro.eval.passk import evaluate_passk as jevaluate_passk
from repro.launch import pipeline as jpipeline
from repro.models import get_api as jget_api
from repro.models import transformer as jtransformer
from repro.rollout.engine import DecodeEngine as JaxEngine
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch import algos
from repro_torch.convert import params_from_jax, params_to_numpy, state_from_jax
from repro_torch.core.types import Sample
from repro_torch.eval import evaluate_passk
from repro_torch.launch.pipeline import PipelineSettings, build_rlvr_pipeline
from repro_torch.models import ModelConfig, get_api, transformer
from repro_torch.rollout import DecodeEngine
from repro_torch.train import HostTrainer, OptConfig, TrainerConfig
from repro_torch.train.trainer import make_train_step

torch.set_num_threads(1)
pytestmark = pytest.mark.timeout(240)

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-5
TRAIN_TOL = dict(rtol=1e-5, atol=1e-6)
OPT = dict(learning_rate=1e-2, warmup_steps=2, weight_decay=0.1, eps=1e-3)
ENGINE = dict(num_slots=3, max_total_len=32, eos_id=99, temperature=0.0)


def _port(cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(cfg))


def _models(**overrides):
    cfg = tiny("paligemma-3b", **{"dtype": "float32", **overrides})
    japi = jget_api(cfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    tapi = get_api(_port(cfg), device="cpu")
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return cfg, (japi, jparams), (tapi, tparams)


@pytest.fixture(scope="module")
def vlm():
    return _models()


def _inputs(cfg, b=2, s=6, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    patches = rng.normal(size=(b, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    return tokens, patches


def _close(j, t, tol=TOL):
    np.testing.assert_allclose(np.asarray(j, np.float32), t.float().numpy(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("attn_impl", ["kernel", "ref"])
def test_apply_with_patches_matches_jax(vlm, attn_impl):
    cfg, (japi, jparams), (tapi, tparams) = vlm
    tokens, patches = _inputs(cfg)
    jlogits, _ = japi.apply(jparams, {"tokens": jnp.asarray(tokens),
                                      "patches": jnp.asarray(patches)})
    tlogits, aux = tapi.apply(tparams, {"tokens": torch.from_numpy(tokens),
                                        "patches": torch.from_numpy(patches)},
                              attn_impl=attn_impl)
    assert tlogits.shape == (2, cfg.num_image_tokens + 6, cfg.vocab_size)
    assert tlogits.dtype == torch.float32
    _close(jlogits, tlogits)
    assert float(aux["load_balance_loss"]) == 0.0
    # without patches: text only, scaled embeddings
    jl, _ = japi.apply(jparams, {"tokens": jnp.asarray(tokens)})
    tl, _ = tapi.apply(tparams, {"tokens": torch.from_numpy(tokens)}, attn_impl=attn_impl)
    assert tl.shape == (2, 6, cfg.vocab_size)
    _close(jl, tl)


def test_bf16_apply_and_the_rounded_embed_scale():
    # d_model 72: sqrt(72) = 8.485 rounds to 8.5 in bf16 (tiny's 64 gives 8)
    cfg, (japi, jparams), (tapi, tparams) = _models(dtype="bfloat16", d_model=72)
    tokens, patches = _inputs(cfg, seed=1)
    # the scale is sqrt(d_model) rounded to bf16 before the multiply: the
    # embeddings equal the reference's bit for bit
    jx = np.asarray(jtransformer._embed(jparams, cfg, jnp.asarray(tokens),
                                        jnp.asarray(patches)).astype(jnp.float32))
    tx = transformer._embed(tparams, tapi.cfg, torch.from_numpy(tokens),
                            torch.from_numpy(patches))
    assert tx.dtype == torch.bfloat16
    np.testing.assert_array_equal(jx, tx.float().numpy())
    jlogits, _ = japi.apply(jparams, {"tokens": jnp.asarray(tokens),
                                      "patches": jnp.asarray(patches)})
    for impl in ("kernel", "ref"):
        tlogits, _ = tapi.apply(tparams, {"tokens": torch.from_numpy(tokens),
                                          "patches": torch.from_numpy(patches)},
                                attn_impl=impl)
        np.testing.assert_allclose(np.asarray(jlogits), tlogits.numpy(), rtol=2e-2,
                                   atol=2e-2)


@pytest.mark.parametrize("attn_impl", ["kernel", "ref"])
def test_prefill_with_patches_then_decode_matches(vlm, attn_impl):
    """Prefill with patches and right-padded rows, then one decode step at
    ``t + P``: logits and caches against the JAX package; the decode
    logits against the port's own ``apply`` of the sequence."""
    cfg, (japi, jparams), (tapi, tparams) = vlm
    p = cfg.num_image_tokens
    b, s, max_len = 2, 6, 12
    tokens, patches = _inputs(cfg, b, s, seed=2)
    valid = np.ones((b, s), bool)
    valid[1, 4:] = False                       # row 1: 4 real tokens
    jcache = japi.init_cache(b, max_len)
    tcache = tapi.init_cache(b, max_len)
    assert tcache.k.shape[2] == max_len + p == jcache.k.shape[2]
    jl, jcache = japi.prefill(jparams, {"tokens": jnp.asarray(tokens),
                                        "patches": jnp.asarray(patches),
                                        "valid": jnp.asarray(valid)}, jcache)
    tl, tcache = tapi.prefill(tparams, {"tokens": torch.from_numpy(tokens),
                                        "patches": torch.from_numpy(patches),
                                        "valid": torch.from_numpy(valid)}, tcache,
                              attn_impl=attn_impl)
    _close(jl, tl)
    np.testing.assert_array_equal(np.asarray(jcache.pos), tcache.pos.numpy())
    _close(jcache.k, tcache.k)
    _close(jcache.v, tcache.v)

    lengths = valid.sum(axis=1)
    token = np.asarray(jl).argmax(-1).astype(np.int32)
    pos = (lengths + p).astype(np.int32)
    jd, jcache = japi.decode_step(jparams, jnp.asarray(token), jnp.asarray(pos), jcache)
    td, tcache = tapi.decode_step(tparams, torch.from_numpy(token), torch.from_numpy(pos),
                                  tcache, attn_impl=attn_impl)
    _close(jd, td)
    _close(jcache.k, tcache.k)
    # the port's own apply over patches + each row's real tokens + the token
    for row in range(b):
        seq = np.concatenate([tokens[row, :lengths[row]], token[row:row + 1]])[None]
        full, _ = tapi.apply(tparams, {"tokens": torch.from_numpy(seq),
                                       "patches": torch.from_numpy(patches[row:row + 1])},
                             attn_impl="ref")
        np.testing.assert_allclose(full[0, -1].numpy(), td[row].numpy(), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(full[0, -2].numpy(), tl[row].numpy(), rtol=TOL,
                                   atol=TOL)


def _greedy(engine, prompts, max_new=6):
    for rid, prompt in enumerate(prompts):
        engine.add_request(rid, prompt, max_new)
    out = {}
    for _ in range(100):
        for rid, toks, lps in engine.step():
            out[rid] = (toks.tolist(), lps)
        if len(out) == len(prompts):
            return out
    raise AssertionError("engine stalled")


@pytest.mark.parametrize("attn_impl", ["kernel", "ref"])
def test_slot_engine_serves_text_only_as_the_jax_engine(vlm, attn_impl):
    cfg, (japi, jparams), (tapi, tparams) = vlm
    rng = np.random.default_rng(5)
    prompts = [rng.integers(3, cfg.vocab_size, n).astype(np.int32) for n in (5, 9, 14)]
    jeng = JaxEngine(japi, jparams, **ENGINE)
    teng = DecodeEngine(tapi, tparams, device="cpu", attn_impl=attn_impl, **ENGINE)
    assert teng.cache.k.shape[2] == ENGINE["max_total_len"] + cfg.num_image_tokens
    assert tapi.init_paged_cache is None and teng.prefill_bucket == 16
    want, got = _greedy(jeng, prompts), _greedy(teng, prompts)
    assert sorted(got) == sorted(want)
    for rid in want:
        assert got[rid][0] == want[rid][0], f"request {rid} diverged"
        np.testing.assert_allclose(got[rid][1], want[rid][1], rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(np.asarray(jeng.cache.pos), teng.cache.pos.numpy())
    assert teng.total_decode_steps == jeng.total_decode_steps


def test_evaluate_passk_takes_the_vlm(vlm):
    _, (japi, jparams), (tapi, tparams) = vlm
    kw = dict(num_prompts=4, n_per_prompt=2, ks=(1, 2), num_slots=4, temperature=0.0,
              seed=3)
    want = jevaluate_passk(japi, jparams, **kw)
    got = dataclasses.asdict(evaluate_passk(tapi, tparams, device="cpu", **kw))
    assert got.pop("decode_steps") > 0
    assert got == dataclasses.asdict(want)


def _samples(vocab, seed, groups=2, group_size=4):
    rng = np.random.default_rng(seed)
    out = []
    for g in range(groups):
        prompt = rng.integers(0, vocab, int(rng.integers(3, 9))).astype(np.int32)
        for j in range(group_size):
            r = rng.integers(0, vocab, int(rng.integers(2, 8))).astype(np.int32)
            out.append(dict(sample_id=len(out), prompt_id=g, replica_idx=j,
                            prompt_tokens=prompt, response_tokens=r,
                            logprobs=(-rng.random(len(r)) * 3).astype(np.float32),
                            reward=float(rng.integers(0, 2)), group_id=g))
    rng.shuffle(out)
    return out


def _close_tree(want, got, what):
    jl = jax.tree_util.tree_leaves_with_path(want)
    gl = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(jl) == len(gl), what
    for path, w in jl:
        np.testing.assert_allclose(np.asarray(w, np.float32), gl[path],
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}",
                                   **TRAIN_TOL)


@pytest.mark.parametrize("adv_estimator", ["grpo", "gae"])
def test_host_trainer_step_matches(adv_estimator):
    """One ``train_on_samples`` (``decoupled_ppo``: a proximal pass, then
    the step) from one carried-across state: zero patches in the batch,
    the image positions' features dropped before the logprobs (and the
    value head)."""
    cfg = tiny("paligemma-3b", dtype="float32")
    japi = jget_api(cfg)
    tcfg = dict(max_seq_len=16, group_size=4, adv_estimator=adv_estimator)
    loss = dict(pg_variant="decoupled_ppo")
    jt = jtrainer.HostTrainer(japi, jax.random.PRNGKey(1), jalgos.LossConfig(**loss),
                              jopt.OptConfig(**OPT), jtrainer.TrainerConfig(**tcfg))
    tt = HostTrainer(get_api(_port(cfg), device="cpu"), 1, algos.LossConfig(**loss),
                     OptConfig(**OPT), TrainerConfig(**tcfg))
    tt.state = state_from_jax(jax.tree_util.tree_map(np.asarray, jt.state), "cpu")
    raw = _samples(cfg.vocab_size, 10)
    batch = tt.build_batch([Sample(**s) for s in raw])
    jbatch = jt.build_batch([JSample(**s) for s in raw])
    assert batch["patches"].shape == jbatch["patches"].shape == (8, 8, cfg.d_model)
    assert batch["patches"].dtype == np.float32 and not batch["patches"].any()
    wm = jt.train_on_samples([JSample(**s) for s in raw])
    gm = tt.train_on_samples([Sample(**s) for s in raw])
    assert set(wm) == set(gm)
    for k in wm:
        np.testing.assert_allclose(wm[k], gm[k], err_msg=k, **TRAIN_TOL)
    _close_tree(jt.state["params"], params_to_numpy(tt.state["params"]), "params")
    if adv_estimator == "gae":
        _close_tree(jt.state["value"], {k: v.numpy() for k, v in tt.state["value"].items()},
                    "value")


def test_zero_patches_overflow_the_gradient_at_full_depth():
    """A property of the reference, pinned: the trainer's zero patches stay
    exactly zero through every layer, and each norm scales their residual
    gradient by rsqrt(eps) = 1000.  It multiplies zero activations, so it
    adds nothing to the parameters' gradients until, at PaliGemma's 18
    layers, it overflows and inf x 0 makes them NaN: in the JAX package as
    in the port.  Seeded patches give a finite gradient in both."""
    cfg = tiny("paligemma-3b", dtype="float32", num_layers=18)
    japi = jget_api(cfg)
    jstate = jtrainer.make_train_state(japi, jax.random.PRNGKey(0))
    jstep = jax.jit(jtrainer.make_train_step(japi, jalgos.LossConfig(),
                                             jopt.OptConfig(**OPT)))
    tapi = get_api(_port(cfg), device="cpu")
    tstep = make_train_step(tapi, algos.LossConfig(), OptConfig(**OPT), attn_impl="ref")
    rng = np.random.default_rng(4)
    b, s = 4, 12
    mask = np.zeros((b, s), np.float32)
    mask[:, 6:] = 1.0
    lp = (-rng.random((b, s)) * mask).astype(np.float32)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
             "mask": mask, "advantages": (rng.normal(size=(b, 1)) * mask).astype(np.float32),
             "rewards": np.ones(b, np.float32), "old_logprobs": lp, "prox_logprobs": lp,
             "ref_logprobs": lp, "is_positive": np.ones(b, np.float32)}
    seeded = rng.normal(size=(b, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    for patches, finite in ((seeded, True), (np.zeros_like(seeded), False)):
        full = dict(batch, patches=patches)
        _, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in full.items()})
        tstate = state_from_jax(jax.tree_util.tree_map(np.asarray, jstate), "cpu")
        _, tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in full.items()})
        assert np.isfinite(float(jm["loss"])) and np.isfinite(float(tm["loss"]))
        assert bool(np.isfinite(float(jm["grad_norm"]))) is finite
        assert bool(np.isfinite(float(tm["grad_norm"]))) is finite
        if finite:
            np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                       **TRAIN_TOL)


def _reward(sample) -> float:
    return float(sample.replica_idx) + 0.1 * float(np.sum(sample.response_tokens) % 5)


def _record(pipe) -> list:
    batches, train = [], pipe.controller.train_fn

    def recorded(samples):
        batches.append(list(samples))
        return train(samples)
    pipe.controller.train_fn = recorded
    return batches


def test_pipeline_step_on_the_slot_engine_matches_the_jax_pipeline():
    """alpha = 0, one replica, greedy, the critic: ``auto`` picks the slot
    engine for the VLM; the same first batch and loss as the JAX pipeline
    from one state; the engine then holds the trainer's new tree."""
    jcfg = tiny("paligemma-3b", vocab_size=32, dtype="float32")
    kw = dict(rollout_batch_size=4, num_return_sequences_in_group=2, num_slots=4,
              max_new_tokens=4, max_seq_len=32, async_generation_ratio=0,
              adv_estimator="gae")
    jpipe = jpipeline.build_rlvr_pipeline(jcfg, jpipeline.PipelineSettings(**kw),
                                          reward_fn=_reward)
    tpipe = build_rlvr_pipeline(_port(jcfg), PipelineSettings(**kw), reward_fn=_reward,
                                device="cpu")
    assert isinstance(tpipe.engine, DecodeEngine)
    assert tpipe.engine.cache.k.shape[2] == 32 + jcfg.num_image_tokens
    tpipe.trainer.state = state_from_jax(
        jax.tree_util.tree_map(np.asarray, jpipe.trainer.state), "cpu")
    for e in tpipe.engines:
        e.update_weights(tpipe.trainer.get_weights())
    for pipe in (jpipe, tpipe):
        pipe.engine.temperature = 0.0
    jbatches, tbatches = _record(jpipe), _record(tpipe)
    jstats, tstats = jpipe.run(1, timeout=120), tpipe.run(1, timeout=120)

    def keyed(batch):
        return sorted((tuple(np.asarray(s.prompt_tokens).tolist()),
                       tuple(np.asarray(s.response_tokens).tolist()), s.reward)
                      for s in batch)
    assert len(tbatches[0]) == 4 and keyed(jbatches[0]) == keyed(tbatches[0])
    assert abs(jstats[0].loss) > 1e-4
    assert tstats[0].loss == pytest.approx(jstats[0].loss, rel=1e-5)
    assert tpipe.buffer.version == 1
    assert tpipe.engine.params is tpipe.trainer.get_weights()


def test_train_command_line_runs_the_vlm():
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--device",
                          "cpu", "--arch", "paligemma-3b", "--steps", "1"],
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "arch=paligemma-3b" in res.stdout and "1 steps" in res.stdout
