"""The port's enc-dec family (Seamless-M4T: ``family="audio"``,
``models/encdec.py``) against the JAX package, on the same weights
(carried across by ``params_from_jax``) and the same numpy-seeded frames
and tokens: ``encode`` (non-causal self-attention), ``apply``, prefill
(right-padded ``valid`` included: the logits stay position -1's) and
decode, ``attention.cross_attention``, the converted tree and cache, one
``HostTrainer`` step (GRPO and GAE), and the refusals: no engine serves
the family, in the port (a ``ValueError`` at construction) as in the
reference (a ``KeyError`` at the first request).

Tolerances: fp32 outputs, logits and caches 1e-5; trainer params 1e-5
relative / 1e-6 absolute at AdamW eps 1e-3 (``test_torch_trainer.py``
says why)."""
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
from repro.models import attention as jattention
from repro.models import encdec as jencdec
from repro.models import get_api as jget_api
from repro.rollout.engine import DecodeEngine as JaxEngine
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch import algos
from repro_torch.convert import (params_from_jax, params_to_numpy, slot_cache_from_jax,
                                 state_from_jax)
from repro_torch.core.types import Sample
from repro_torch.launch.pipeline import (PipelineSettings, build_agentic_pipeline,
                                         build_rlvr_pipeline)
from repro_torch.models import ModelConfig, attention, encdec, get_api
from repro_torch.rollout import DecodeEngine, PagedDecodeEngine
from repro_torch.train import HostTrainer, OptConfig, TrainerConfig

torch.set_num_threads(1)
pytestmark = pytest.mark.timeout(240)

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-5
TRAIN_TOL = dict(rtol=1e-5, atol=1e-6)
OPT = dict(learning_rate=1e-2, warmup_steps=2, weight_decay=0.1, eps=1e-3)


def _port(cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def audio():
    cfg = tiny("seamless-m4t-medium", dtype="float32")
    japi = jget_api(cfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    tapi = get_api(_port(cfg), device="cpu")
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return cfg, (japi, jparams), (tapi, tparams)


def _inputs(cfg, b=2, s=7, seed=0):
    rng = np.random.default_rng(seed)
    frames = rng.normal(size=(b, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return frames, tokens


def _close(j, t, tol=TOL):
    np.testing.assert_allclose(np.asarray(j, np.float32), t.float().numpy(),
                               rtol=tol, atol=tol)


def test_converted_tree_and_layout(audio):
    cfg, (_, jparams), (tapi, tparams) = audio
    assert len(tparams["encoder"]) == cfg.num_encoder_layers == 2
    assert len(tparams["decoder"]) == cfg.num_layers
    assert "q_norm" not in tparams["decoder"][0]["cross"]
    back = params_to_numpy(tparams)
    want = jax.tree_util.tree_leaves_with_path(jparams)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(want) == len(got)
    for path, w in want:
        np.testing.assert_array_equal(np.asarray(w), got[path])
    # the port's own init has the reference's structure and shapes
    mine = jax.tree_util.tree_map(np.shape, params_to_numpy(tapi.init(0)))
    assert mine == jax.tree_util.tree_map(np.shape, back)


@pytest.mark.parametrize("attn_impl", ["kernel", "ref"])
def test_encode_and_apply_match_jax(audio, attn_impl):
    cfg, (japi, jparams), (tapi, tparams) = audio
    frames, tokens = _inputs(cfg)
    jmem = jencdec.encode(jparams, cfg, jnp.asarray(frames))
    tmem = encdec.encode(tparams, tapi.cfg, torch.from_numpy(frames), attn_impl=attn_impl)
    _close(jmem, tmem)
    batch = {"frames": frames, "tokens": tokens}
    jlogits, jaux = japi.apply(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tlogits, taux = tapi.apply(tparams, {k: torch.from_numpy(v) for k, v in batch.items()},
                               attn_impl=attn_impl)
    assert tlogits.shape == (2, 7, cfg.vocab_size) and tlogits.dtype == torch.float32
    _close(jlogits, tlogits)
    assert set(taux) == set(jaux) and all(float(v) == 0.0 for v in taux.values())
    jf, _ = japi.apply(jparams, {k: jnp.asarray(v) for k, v in batch.items()},
                       return_features=True)
    tf, _ = tapi.apply(tparams, {k: torch.from_numpy(v) for k, v in batch.items()},
                       return_features=True, attn_impl=attn_impl)
    _close(jf, tf)


def test_encoder_attention_is_not_causal(audio):
    """A later frame moves an earlier frame's encoding (it would not under
    a causal mask)."""
    cfg, _, (tapi, tparams) = audio
    frames, _ = _inputs(cfg, b=1)
    other = frames.copy()
    other[0, -1] += 1.0
    a, b = (encdec.encode(tparams, tapi.cfg, torch.from_numpy(f)) for f in (frames, other))
    assert (a[0, 0] - b[0, 0]).abs().max() > 1e-4


@pytest.mark.parametrize("attn_impl", ["kernel", "ref"])
def test_prefill_then_decode_match_jax(audio, attn_impl):
    """Prefill (a right-padded ``valid`` in the batch: neither package reads
    it, so the logits are position -1's) then three decode steps: logits,
    the self cache and the cross K/V against the JAX package, and the
    port's own ``apply``."""
    cfg, (japi, jparams), (tapi, tparams) = audio
    b, s, max_len = 2, 7, 12
    frames, tokens = _inputs(cfg, b, s, seed=1)
    valid = np.ones((b, s), bool)
    valid[1, 3:] = False
    batch = {"frames": frames, "tokens": tokens, "valid": valid}
    jcache = japi.init_cache(b, max_len)
    tcache = tapi.init_cache(b, max_len)
    jl, jcache = japi.prefill(jparams, {k: jnp.asarray(v) for k, v in batch.items()},
                              jcache)
    tl, tcache = tapi.prefill(tparams, {k: torch.from_numpy(v) for k, v in batch.items()},
                              tcache, attn_impl=attn_impl)
    _close(jl, tl)
    full, _ = tapi.apply(tparams, {"frames": torch.from_numpy(frames),
                                   "tokens": torch.from_numpy(tokens)}, attn_impl="ref")
    np.testing.assert_allclose(full[:, -1].numpy(), tl.numpy(), rtol=TOL, atol=TOL)
    # the JAX cache, carried across, is the port's
    carried = slot_cache_from_jax(jax.tree_util.tree_map(np.asarray, jcache), "cpu")
    assert isinstance(carried, encdec.EncDecCache)
    for name in ("cross_k", "cross_v"):
        _close(getattr(carried, name), getattr(tcache, name))
    _close(carried.self_kv.k, tcache.self_kv.k)
    np.testing.assert_array_equal(carried.self_kv.pos.numpy(), tcache.self_kv.pos.numpy())

    seq = tokens.copy()
    token = np.asarray(jl).argmax(-1).astype(np.int32)
    for step in range(3):
        pos = np.full((b,), s + step, np.int32)
        jd, jcache = japi.decode_step(jparams, jnp.asarray(token), jnp.asarray(pos), jcache)
        td, tcache = tapi.decode_step(tparams, torch.from_numpy(token),
                                      torch.from_numpy(pos), tcache, attn_impl=attn_impl)
        _close(jd, td)
        seq = np.concatenate([seq, token[:, None]], axis=1)
        token = np.asarray(jd).argmax(-1).astype(np.int32)
    _close(jcache["self"].k, tcache.self_kv.k)
    np.testing.assert_array_equal(np.asarray(jcache["self"].pos), tcache.self_kv.pos.numpy())
    full, _ = tapi.apply(tparams, {"frames": torch.from_numpy(frames),
                                   "tokens": torch.from_numpy(seq)}, attn_impl="ref")
    np.testing.assert_allclose(full[:, -1].numpy(), td.numpy(), rtol=TOL, atol=TOL)


def test_prefill_refuses_frames_the_cache_was_not_made_for(audio):
    cfg, _, (tapi, tparams) = audio
    frames, tokens = _inputs(cfg, b=1)
    with pytest.raises(ValueError, match="cross K/V"):
        tapi.prefill(tparams, {"frames": torch.from_numpy(frames[:, :8]),
                               "tokens": torch.from_numpy(tokens)}, tapi.init_cache(1, 12))


def test_cross_attention_matches_jax(audio):
    cfg, (_, jparams), (_, tparams) = audio
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, cfg.d_model)).astype(np.float32)
    memory = rng.normal(size=(2, 9, cfg.d_model)).astype(np.float32)
    memory_valid = np.ones((2, 9), bool)
    memory_valid[1, 6:] = False
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["decoder"]["cross"])
    tp = tparams["decoder"][0]["cross"]
    for mv in (None, memory_valid):
        want = jattention.cross_attention(jp, cfg, jnp.asarray(x), jnp.asarray(memory),
                                          None if mv is None else jnp.asarray(mv))
        got = attention.cross_attention(tp, _port(cfg), torch.from_numpy(x),
                                        torch.from_numpy(memory),
                                        None if mv is None else torch.from_numpy(mv))
        _close(want, got)


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
    """One ``train_on_samples`` (``decoupled_ppo``) from one carried-across
    state: zero frames of the reference's shape in the batch, ``lm_head``
    as the unembedding."""
    cfg = tiny("seamless-m4t-medium", dtype="float32")
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
    assert batch["frames"].shape == (8, cfg.encoder_frames, cfg.d_model)
    assert batch["frames"].dtype == np.float32 and not batch["frames"].any()
    wm = jt.train_on_samples([JSample(**s) for s in raw])
    gm = tt.train_on_samples([Sample(**s) for s in raw])
    assert set(wm) == set(gm)
    for k in wm:
        np.testing.assert_allclose(wm[k], gm[k], err_msg=k, **TRAIN_TOL)
    _close_tree(jt.state["params"], params_to_numpy(tt.state["params"]), "params")
    for key in ("master", "m", "v"):
        _close_tree(jt.state["opt"][key], params_to_numpy(tt.state["opt"][key]), key)


def test_no_engine_serves_the_family(audio):
    """The port refuses at construction; the reference's slot engine builds
    and then fails at the first request, for want of frames."""
    cfg, (japi, jparams), (tapi, tparams) = audio
    assert tapi.init_paged_cache is None and tapi.decode_paged is None
    with pytest.raises(ValueError, match="frames"):
        DecodeEngine(tapi, tparams, device="cpu", num_slots=2, max_total_len=32)
    with pytest.raises(ValueError, match="paged"):
        PagedDecodeEngine(tapi, tparams, device="cpu", num_slots=2, max_total_len=32)
    s = PipelineSettings(rollout_batch_size=4, num_return_sequences_in_group=2,
                         num_slots=4, max_new_tokens=4, max_seq_len=32)
    for build in (lambda: build_rlvr_pipeline(_port(cfg), s, device="cpu"),
                  lambda: build_agentic_pipeline(_port(cfg), s, make_env=None,
                                                 num_env_groups=1, group_size=2,
                                                 device="cpu")):
        with pytest.raises(ValueError, match="frames"):
            build()
    # a property of the reference, pinned: its engine cannot prefill either
    jeng = JaxEngine(japi, jparams, num_slots=2, max_total_len=32)
    with pytest.raises(KeyError, match="frames"):
        jeng.add_request(0, np.arange(3, 8, dtype=np.int32), 4)


def test_train_command_line_exits_with_the_engines_error():
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--device",
                          "cpu", "--arch", "seamless-m4t-medium", "--steps", "1"],
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 1
    assert "seamless-m4t-medium" in res.stderr and "frames" in res.stderr
