"""The MoE family (Qwen3-MoE-235B-A22B and DBRX-132B, tiny: 4 experts,
top-2, ``moe_d_ff`` 64) through the port against the JAX package, on the
same weights (carried across by ``params_from_jax``): the layer's two
paths and its capacity drops, ``lm_apply``'s logits and router losses, the
paged and slot engines (greedy tokens and counters), one ``HostTrainer``
step with the router losses in the loss, int8 quantize-on-sync, and the
RLVR pipeline's engine choice.

Tolerances (fp32): layer outputs and logits 1e-5, router losses 1e-6 (the
two frameworks reduce in different orders); the kept and dropped
(token, k) assignments, greedy tokens, engine counters and int8 codes and
scales exact; the trainer at the trainer tests' 1e-5 relative / 1e-6
absolute, with AdamW eps 1e-3 (``test_torch_trainer.py`` says why)."""
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
from repro.models import moe as jmoe
from repro.quant import core as jquant
from repro.rollout.engine import DecodeEngine as JaxSlotEngine
from repro.rollout.paged_engine import PagedDecodeEngine as JaxPagedEngine
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch import algos, quant
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core.types import Sample
from repro_torch.launch.pipeline import PipelineSettings, build_rlvr_pipeline
from repro_torch.models import ModelConfig, get_api, moe
from repro_torch.rollout import DecodeEngine, PagedDecodeEngine
from repro_torch.train import HostTrainer, OptConfig, TrainerConfig
from repro_torch.train.optimizer import init_opt_state

torch.set_num_threads(1)

ARCHS = ["qwen3-moe-235b-a22b", "dbrx-132b"]
TOL = dict(rtol=1e-5, atol=1e-5)
AUX_TOL = dict(rtol=1e-6, atol=1e-6)
TRAIN_TOL = dict(rtol=1e-5, atol=1e-6)
OPT = dict(learning_rate=1e-2, warmup_steps=2, weight_decay=0.1, eps=1e-3)


def _port(cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    cfg = tiny(request.param, dtype="float32", vocab_size=32)
    japi = jget_api(cfg)
    jparams = [japi.init(jax.random.PRNGKey(i)) for i in (0, 1)]
    tapi = get_api(_port(cfg), device="cpu")
    tparams = [params_from_jax(jax.tree_util.tree_map(np.asarray, p), "cpu")
               for p in jparams]
    return cfg, (japi, jparams), (tapi, tparams)


# the reference layer, compiled once per shape (its op-by-op run compiles
# every primitive anew)
_jmoe_apply = jax.jit(jmoe.moe_apply, static_argnums=1, static_argnames="mode")


def _layer(jparams, tparams, i=0):
    return (jax.tree_util.tree_map(lambda a: a[i], jparams["blocks"]["moe"]),
            tparams["blocks"][i]["moe"])


# ------------------------------------------------------------------- layer
@pytest.mark.parametrize("capacity_factor,seq", [(1.25, 16), (0.5, 16), (1.25, 1)])
def test_moe_paths_match_the_jax_layer(models, capacity_factor, seq):
    cfg, (_, jparams), (_, tparams) = models
    cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    jp, tp = _layer(jparams[0], tparams[0])
    x = np.random.default_rng(1).normal(size=(3, seq, cfg.d_model)).astype(np.float32)
    for mode in moe.MODES:
        want, waux = _jmoe_apply(jp, cfg, jnp.asarray(x), mode=mode)
        got, gaux = moe.moe_apply(tp, _port(cfg), torch.from_numpy(x), mode=mode)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=mode, **TOL)
        assert set(gaux) == set(waux) == {"load_balance_loss", "router_z_loss"}
        for k in waux:
            np.testing.assert_allclose(float(gaux[k]), float(waux[k]),
                                       err_msg=f"{mode} {k}", **AUX_TOL)
    with pytest.raises(ValueError, match="moe_mode"):
        moe.moe_apply(tp, _port(cfg), torch.from_numpy(x), mode="sparse")


def _jax_keep(cfg, jp, x):
    """The reference's kept (token, k) assignments (``moe_ep``'s ``pos`` and
    ``keep``, over its router's top-k), shaped (B, groups, gs, k)."""
    b, s, d = x.shape
    gs = min(s, jmoe._GROUP)
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    cap = max(1, int(gs * k / e * cfg.capacity_factor))
    _, _, _, idx = jmoe._router(jp, cfg, jnp.asarray(x).reshape(b, s // gs, gs, d))
    onehot = jax.nn.one_hot(idx, e, dtype=jnp.float32)
    pos = (jnp.cumsum(onehot.reshape(b, s // gs, gs * k, e), axis=2) - 1.0
           ).reshape(onehot.shape)
    keep = ((pos < cap) & (onehot > 0)).any(-1)
    return np.asarray(keep), np.asarray(idx)


@pytest.mark.parametrize("capacity_factor", [0.5, 1.25])
def test_capacity_drops_are_the_reference_drops(models, capacity_factor):
    """16-token chunks (the pipeline's default prefill chunk) and two
    512-token groups: the same (token, k) assignments are kept and
    dropped; at capacity factor 0.5 the reference drops some in both."""
    cfg, (_, jparams), (_, tparams) = models
    cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    jp, tp = _layer(jparams[0], tparams[0], 1)
    rng = np.random.default_rng(2)
    for b, s in ((4, 16), (1, 1024)):
        x = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
        want_keep, want_idx = _jax_keep(cfg, jp, x)
        gs = min(s, moe._GROUP)
        _, _, _, idx = moe._router(tp, _port(cfg), torch.from_numpy(x).view(-1, gs,
                                                                           cfg.d_model))
        _, keep = moe.dispatch_plan(_port(cfg), idx)
        assert np.array_equal(idx.numpy(), want_idx.reshape(idx.shape))
        assert np.array_equal(keep.numpy(), want_keep.reshape(keep.shape))
        assert want_keep.any()
        if capacity_factor < 1:
            assert not want_keep.all(), f"no drop at {b}x{s}"


def test_top_k_takes_the_lower_expert_on_a_tie(models):
    """Equal router probabilities: ``lax.top_k``'s order (lower index
    first), and the layer's output with it."""
    cfg, (_, jparams), (_, tparams) = models
    jp, tp = _layer(jparams[0], tparams[0])
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    x = np.random.default_rng(3).normal(size=(1, 8, cfg.d_model)).astype(np.float32)
    _, _, _, idx = moe._router(tp, _port(cfg), torch.from_numpy(x))
    assert (idx == torch.arange(cfg.num_experts_per_tok)).all()
    for mode in moe.MODES:
        want, _ = _jmoe_apply(jp, cfg, jnp.asarray(x), mode=mode)
        got, _ = moe.moe_apply(tp, _port(cfg), torch.from_numpy(x), mode=mode)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ------------------------------------------------------------------- model
@pytest.mark.parametrize("moe_mode", moe.MODES)
def test_lm_apply_logits_and_router_losses_match(models, moe_mode):
    cfg, (japi, jparams), (tapi, tparams) = models
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    want, waux = japi.apply(jparams[0], {"tokens": jnp.asarray(tokens)}, moe_mode=moe_mode)
    for attn_impl in ("kernel", "ref"):
        got, gaux = tapi.apply(tparams[0], {"tokens": torch.from_numpy(tokens)},
                               moe_mode=moe_mode, attn_impl=attn_impl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for k in waux:
            assert float(gaux[k]) > 0
            np.testing.assert_allclose(float(gaux[k]), float(waux[k]), err_msg=k,
                                       **AUX_TOL)


# ----------------------------------------------------------------- engines
PAGED = dict(num_slots=8, max_total_len=64, page_size=8, prefill_chunk=16,
             eos_id=99, temperature=0.0, prefix_cache=True)
COUNTERS = ("total_prefill_tokens", "total_prefill_chunks", "cache_hit_tokens",
            "total_groups_forked", "total_pages_copied", "peak_pages_in_use",
            "total_decode_steps", "total_tokens_decoded", "cache_lookups",
            "cache_hits", "cache_ext_hits", "cache_evicted_pages")


def _prompts(vocab):
    rng = np.random.default_rng(5)
    pre = rng.integers(1, vocab - 2, 16)
    prompts = [np.concatenate([pre, rng.integers(1, vocab - 2, n)]).astype(np.int32)
               for n in (3, 9, 21)]
    prompts.append(rng.integers(1, vocab - 2, 13).astype(np.int32))
    return prompts


def _paged_workload(engine, params2, vocab):
    """Prompts over one or two 16-token chunks (a partial last chunk), a
    shared preamble under the prefix cache, a COW group of 4, abort(retain)
    -> resume and a weight update; the page audit after every step."""
    p = _prompts(vocab)
    engine.add_request(0, p[0], 10)
    engine.add_request(1, p[1], 12)
    engine.submit_group([10, 11, 12, 13], p[3], 6)
    finished, partial = {}, {}
    for step in range(300):
        if step == 3:
            engine.add_request(2, p[2], 8)
        if step == 6:
            res = engine.abort(1, retain=True)
            partial[1] = res.tokens.tolist()
        if step == 8:
            engine.resume_request(1, 21, 12 - len(partial[1]))
        if step == 10:
            engine.update_weights(params2)
        if step == 12:
            engine.add_request(3, p[0], 6)
        for rid, toks, lps in engine.step():
            finished[rid] = (toks.tolist(), lps)
        engine.audit_pages()
        if len(finished) == 8:
            return finished, partial
    raise AssertionError(f"engine stalled: {sorted(finished)}")


def _same_tokens(got, want):
    assert sorted(got) == sorted(want)
    for rid in want:
        assert got[rid][0] == want[rid][0], f"request {rid} diverged"
        np.testing.assert_allclose(got[rid][1], want[rid][1], **TOL)


def test_paged_engine_is_byte_identical_with_equal_counters(models):
    cfg, (japi, jparams), (tapi, tparams) = models
    jeng = JaxPagedEngine(japi, jparams[0], **PAGED)
    teng = PagedDecodeEngine(tapi, tparams[0], device="cpu", **PAGED)
    jfin, jpart = _paged_workload(jeng, jparams[1], cfg.vocab_size)
    tfin, tpart = _paged_workload(teng, tparams[1], cfg.vocab_size)
    assert tpart == jpart
    _same_tokens(tfin, jfin)
    for name in COUNTERS:
        assert getattr(teng, name) == getattr(jeng, name), name
    assert teng.cache_hit_tokens > 0 and teng.total_groups_forked == 1
    assert teng.cache_pages_held == jeng.cache_pages_held
    pages = range(teng.pool.num_pages)
    assert [teng.pool.refcount(i) for i in pages] == [jeng.pool.refcount(i) for i in pages]
    assert teng.pool.pages_free == jeng.pool.pages_free


def test_slot_engine_is_byte_identical(models):
    """The slot engine pads each prompt to its 16-token bucket; the pads
    are routed and take expert capacity in both packages."""
    cfg, (japi, jparams), (tapi, tparams) = models
    kw = dict(num_slots=4, max_total_len=64, eos_id=99, temperature=0.0)
    prompts = _prompts(cfg.vocab_size)
    out = []
    for eng in (JaxSlotEngine(japi, jparams[0], **kw),
                DecodeEngine(tapi, tparams[0], device="cpu", **kw)):
        assert eng.prefill_bucket == 16
        for rid, p in enumerate(prompts):
            eng.add_request(rid, p, 8)
        fin = {}
        for _ in range(100):
            for rid, toks, lps in eng.step():
                fin[rid] = (toks.tolist(), lps)
            if len(fin) == len(prompts):
                break
        out.append((fin, eng.total_decode_steps, eng.total_tokens_decoded))
    _same_tokens(out[1][0], out[0][0])
    assert out[1][1:] == out[0][1:]


# ----------------------------------------------------------------- trainer
def _samples(vocab, seed):
    rng = np.random.default_rng(seed)
    out = []
    for g in range(2):
        prompt = rng.integers(0, vocab, int(rng.integers(3, 9))).astype(np.int32)
        for j in range(4):
            r = rng.integers(0, vocab, int(rng.integers(2, 8))).astype(np.int32)
            out.append(dict(sample_id=len(out), prompt_id=g, replica_idx=j,
                            prompt_tokens=prompt, response_tokens=r,
                            logprobs=(-rng.random(len(r)) * 3).astype(np.float32),
                            reward=float(rng.integers(0, 2)), group_id=g))
    return out


def _close_tree(want, got):
    jl = jax.tree_util.tree_leaves_with_path(want)
    gl = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(jl) == len(gl)
    for path, w in jl:
        np.testing.assert_allclose(np.asarray(w, np.float32), gl[path],
                                   err_msg=jax.tree_util.keystr(path), **TRAIN_TOL)


def test_host_trainer_step_matches_with_the_router_losses(models, monkeypatch):
    cfg, (japi, jparams), (tapi, tparams) = models
    tcfg = dict(max_seq_len=16, group_size=4)
    loss = dict(pg_variant="decoupled_ppo", kl_beta=0.05)
    ref_j = jax.tree_util.tree_map(lambda x: x * 0.9, jparams[0])
    jt = jtrainer.HostTrainer(japi, jax.random.PRNGKey(1), jalgos.LossConfig(**loss),
                              jopt.OptConfig(**OPT), jtrainer.TrainerConfig(**tcfg),
                              ref_params=ref_j)
    jt.state = {"params": jparams[0], "opt": jopt.init_opt_state(jparams[0])}
    tt = HostTrainer(tapi, 1, algos.LossConfig(**loss), OptConfig(**OPT),
                     TrainerConfig(**tcfg),
                     ref_params=params_from_jax(jax.tree_util.tree_map(np.asarray, ref_j),
                                                "cpu"))
    tt.state = {"params": tparams[0], "opt": init_opt_state(tparams[0])}
    modes = []
    apply = moe.moe_apply

    def recorded(p, cfg_, x, *, mode="ep"):
        modes.append(mode)
        return apply(p, cfg_, x, mode=mode)
    monkeypatch.setattr(moe, "moe_apply", recorded)

    raw = _samples(cfg.vocab_size, 10)
    want = jt.train_on_samples([JSample(**s) for s in raw])
    got = tt.train_on_samples([Sample(**s) for s in raw])
    # prox and ref passes, then the train step: every layer in dense mode
    assert modes == ["dense"] * 3 * cfg.num_layers
    assert set(want) == set(got) and got["load_balance_loss"] > 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TRAIN_TOL)
    _close_tree(jt.get_weights(), params_to_numpy(tt.get_weights()))

    # the router losses enter the loss with their weights
    batch = {k: torch.from_numpy(v) for k, v in tt.build_batch(
        [Sample(**s) for s in raw]).items()}
    lp = torch.zeros(batch["tokens"].shape)
    aux = {"load_balance_loss": torch.tensor(2.0), "router_z_loss": torch.tensor(3.0)}
    lcfg = algos.LossConfig(**loss)
    with_aux, _ = algos.rl_loss(lp, batch, lcfg, aux)
    without, _ = algos.rl_loss(lp, batch, lcfg, None)
    assert float(with_aux - without) == pytest.approx(
        2.0 * lcfg.aux_loss_weight + 3.0 * lcfg.z_loss_weight, abs=1e-6)


# ------------------------------------------------------------ quantization
@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantize_params_codes_and_scales_match(models, mode):
    """Every MoE leaf, the fp32 router included, quantized as the reference
    quantizes its stacked (L, ...) leaf: one scale per output column,
    shared by every layer and every expert."""
    cfg, (_, jparams), (_, tparams) = models
    jq = jquant.quantize_params(jparams[0], mode)["blocks"]["moe"]
    tq = quant.quantize_params(tparams[0], mode)["blocks"]
    for key in ("router", "w_gate", "w_up", "w_down"):
        jleaf = jq[key]
        assert isinstance(jleaf, jquant.QuantLeaf), key
        for layer in range(cfg.num_layers):
            tleaf = tq[layer]["moe"][key]
            assert isinstance(tleaf, quant.QuantLeaf), key
            assert np.array_equal(np.asarray(jleaf.codes)[layer].view(np.int8),
                                  tleaf.codes.view(torch.int8).numpy()), (key, layer)
            assert np.array_equal(np.asarray(jleaf.scale)[0], tleaf.scale.numpy()), key
            assert tleaf.dtype == tparams[0]["blocks"][layer]["moe"][key].dtype
    scale = tq[0]["moe"]["w_gate"].scale
    assert scale.shape == (1, 1, cfg.moe_d_ff)
    assert tq[0]["moe"]["router"].scale.shape == (1, cfg.num_experts)


def test_int8_engine_matches_the_jax_engine(models):
    cfg, (japi, jparams), (tapi, tparams) = models
    kw = dict(PAGED, quant_mode="int8", kv_quant="int8")
    jeng = JaxPagedEngine(japi, jparams[0], **kw)
    teng = PagedDecodeEngine(tapi, tparams[0], device="cpu", **kw)
    out = []
    for eng in (jeng, teng):
        for rid, p in enumerate(_prompts(cfg.vocab_size)):
            eng.add_request(rid, p, 6)
        fin = {}
        for _ in range(60):
            for rid, toks, lps in eng.step():
                fin[rid] = (toks.tolist(), lps)
            eng.audit_pages()
            if len(fin) == 4:
                break
        out.append(fin)
    _same_tokens(out[1], out[0])


# ---------------------------------------------------------------- pipeline
def test_rlvr_pipeline_serves_moe_on_the_paged_engine():
    cfg = _port(tiny("qwen3-moe-235b-a22b", vocab_size=32, dtype="float32"))
    s = PipelineSettings(rollout_batch_size=4, num_return_sequences_in_group=2,
                         num_slots=4, max_new_tokens=4, max_seq_len=32, page_size=8,
                         async_generation_ratio=1, pg_variant="decoupled_ppo")
    pipe = build_rlvr_pipeline(cfg, s, device="cpu")
    assert isinstance(pipe.engine, PagedDecodeEngine)
    stats = pipe.run(1, timeout=120)
    assert len(stats) == 1 and np.isfinite(stats[0].loss)
    assert pipe.engine.params is pipe.trainer.get_weights()
    pipe.engine.audit_pages()
