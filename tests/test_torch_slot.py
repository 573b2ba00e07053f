"""The slot engine's path through the port against the JAX package, on the
same weights (carried across by ``params_from_jax``) and the same inputs:
the dense cache's prefill and decode layers, the dense model's prefill and
decode steps, the slot ``DecodeEngine`` for the dense and RWKV-6 families
(greedy tokens, slots, counters, abort, caches after slot reuse,
quantize-on-sync), ``LLMProxy`` over it, and pass@k evaluation.

Tolerances (fp32): outputs and logits 1e-5 (the two frameworks reduce in
different orders); cache K/V 1e-6 (one projection and RoPE, no
reduction across tokens); positions and tokens exact; engine caches 1e-5
(they carry the decoded steps); logprobs 1e-5.  On the CPU
``attn_impl="kernel"`` runs the kernels' plain versions."""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny
from repro.data.dataset import ArithmeticTask as JaxTask
from repro.eval.passk import evaluate_passk as jax_evaluate_passk
from repro.eval.passk import pass_at_k_estimator as jax_estimator
from repro.models import attention as jattention
from repro.models import get_api as jget_api
from repro.rewards.verifier import ArithmeticVerifier as JaxVerifier
from repro.core.types import Sample as JaxSample
from repro.rollout.engine import DecodeEngine as JaxEngine
from repro_torch.convert import params_from_jax, slot_cache_from_jax
from repro_torch.core.llm_proxy import LLMProxy
from repro_torch.core.types import RolloutTask, Sample
from repro_torch.data import ArithmeticTask
from repro_torch.eval import evaluate_passk, pass_at_k_estimator
from repro_torch.models import attention, get_api
from repro_torch.models.config import ModelConfig
from repro_torch.rewards import ArithmeticVerifier
from repro_torch.rollout import DecodeEngine, PagedDecodeEngine

# tiny shapes: one torch thread, so the suite's parallel workers keep their
# cores (torch's pool would otherwise spin on all of them)
torch.set_num_threads(1)

TOL = 1e-5
ENGINE = dict(num_slots=4, max_total_len=40, eos_id=99, temperature=0.0)
# (prompt length, max new tokens) of the engine workload: more requests than
# slots, so slots are reused; three prompt lengths keep the reference's
# per-length prefill compiles few.
REQUESTS = [(5, 6), (9, 8), (13, 4), (5, 10), (9, 5), (13, 7), (5, 6)]
ABORT = (3, 4)      # (request id, engine step at which it is aborted)


def _models(arch, **overrides):
    cfg = tiny(arch, dtype="float32", **overrides)
    japi = jget_api(cfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    if cfg.family == "ssm":
        # the reference initialises the mixes to zero: perturb every leaf
        rng = np.random.default_rng(7)
        jparams = jax.tree_util.tree_map(
            lambda a: a + 0.05 * rng.normal(size=a.shape).astype(a.dtype), jparams)
    tapi = get_api(ModelConfig(**dataclasses.asdict(cfg)), device="cpu")
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return cfg, (japi, jparams), (tapi, tparams)


@pytest.fixture(scope="module")
def dense():
    return _models("qwen3-4b", vocab_size=32)


@pytest.fixture(scope="module")
def ssm():
    return _models("rwkv6-3b", vocab_size=32)


def _close(j, t, tol=TOL):
    np.testing.assert_allclose(np.asarray(j, np.float32), t.float().numpy(),
                               rtol=tol, atol=tol)


def _cache_close(jcache, tcache, tol=TOL):
    for name in jcache._fields:
        j, t = getattr(jcache, name), getattr(tcache, name)
        if name == "pos":
            np.testing.assert_array_equal(np.asarray(j), t.numpy())
        else:
            _close(j, t, tol)


# ---------------------------------------------------------------------------
# layers and model (dense)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("attn_impl", ["kernel", "ref"])
def test_prefill_then_decode_attention_match_jax(dense, attn_impl):
    cfg, (_, jparams), (_, tparams) = dense
    rng = np.random.default_rng(0)
    b, s, smax = 3, 8, 24
    x = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    positions = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    valid = np.ones((b, s), bool)
    valid[1, 5:] = False                       # a right-padded prompt
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["blocks"]["attn"])
    tp = tparams["blocks"][0]["attn"]
    jcache = jattention.init_kv_cache(cfg, b, smax)
    jout, jcache = jattention.prefill_attention(
        jp, cfg, jnp.asarray(x), jnp.asarray(positions), jcache,
        valid=jnp.asarray(valid))
    tcache = attention.init_kv_cache(cfg, b, smax, "cpu").layer(0)
    tout, tcache = attention.prefill_attention(
        tp, cfg, torch.from_numpy(x), torch.from_numpy(positions), tcache,
        valid=torch.from_numpy(valid))
    _close(jout, tout)
    _cache_close(jcache, tcache, tol=1e-6)
    pos = np.array([8, 5, 8], np.int32)        # row 1 overwrites its padding
    for step in range(3):
        x1 = rng.normal(size=(b, 1, cfg.d_model)).astype(np.float32)
        jout, jcache = jattention.decode_attention(jp, cfg, jnp.asarray(x1),
                                                   jnp.asarray(pos + step), jcache)
        tout, tcache = attention.decode_attention(
            tp, cfg, torch.from_numpy(x1), torch.from_numpy(pos + step), tcache,
            attn_impl=attn_impl)
        _close(jout, tout)
        _cache_close(jcache, tcache, tol=1e-6)


def test_decode_attention_refuses_what_the_kernel_does_not_take(dense):
    cfg, _, (_, tparams) = dense
    p = tparams["blocks"][0]["attn"]
    x = torch.zeros(2, 1, cfg.d_model)
    pos = torch.tensor([3, 4])
    cache = attention.init_kv_cache(cfg, 2, 16, "cpu").layer(0)
    with pytest.raises(ValueError, match="attn_impl"):
        attention.decode_attention(p, cfg, x, pos, cache, attn_impl="pallas")
    capped = dataclasses.replace(cfg, attn_logit_softcap=30.0)
    with pytest.raises(ValueError, match="softcap"):
        attention.decode_attention(p, capped, x, pos, cache, attn_impl="kernel")
    ring = attention.init_kv_cache(cfg, 2, 16, "cpu", window=8)
    assert ring.ring and ring.k.shape[2] == 8
    with pytest.raises(ValueError, match="ring"):
        attention.decode_attention(p, cfg, x, pos, ring.layer(0), attn_impl="kernel")
    # the plain path takes both, as the reference does
    attention.decode_attention(p, capped, x, pos, cache, attn_impl="ref")
    attention.decode_attention(p, cfg, x, pos, ring.layer(0), attn_impl="ref")


@pytest.mark.parametrize("attn_impl", ["kernel", "ref"])
def test_dense_prefill_and_decode_steps_match_jax(dense, attn_impl):
    cfg, (japi, jparams), (tapi, tparams) = dense
    rng = np.random.default_rng(1)
    b, s = 3, 16
    tokens = rng.integers(3, cfg.vocab_size, (b, s)).astype(np.int32)
    lengths = np.array([16, 7, 11])
    valid = np.arange(s)[None, :] < lengths[:, None]
    jlog, jcache = japi.prefill(jparams, {"tokens": jnp.asarray(tokens),
                                          "valid": jnp.asarray(valid)},
                                japi.init_cache(b, 32))
    tlog, tcache = tapi.prefill(tparams, {"tokens": torch.from_numpy(tokens),
                                          "valid": torch.from_numpy(valid)},
                                tapi.init_cache(b, 32), attn_impl=attn_impl)
    _close(jlog, tlog)
    _cache_close(jcache, tcache)
    for step in range(3):
        tok = rng.integers(3, cfg.vocab_size, (b,)).astype(np.int32)
        pos = (lengths + step).astype(np.int32)
        jlog, jcache = japi.decode_step(jparams, jnp.asarray(tok), jnp.asarray(pos),
                                        jcache)
        tlog, tcache = tapi.decode_step(tparams, torch.from_numpy(tok),
                                        torch.from_numpy(pos), tcache,
                                        attn_impl=attn_impl)
        assert tlog.shape == (b, cfg.vocab_size) and tlog.dtype == torch.float32
        _close(jlog, tlog)
        _cache_close(jcache, tcache)
    # a cache carried across decodes on as the reference's does
    carried = slot_cache_from_jax(jax.tree_util.tree_map(np.asarray, jcache), "cpu",
                                  max_len=32)
    tok = np.array([4, 5, 6], np.int32)
    pos = (lengths + 3).astype(np.int32)
    jlog, _ = japi.decode_step(jparams, jnp.asarray(tok), jnp.asarray(pos), jcache)
    tlog, _ = tapi.decode_step(tparams, torch.from_numpy(tok), torch.from_numpy(pos),
                               carried, attn_impl=attn_impl)
    _close(jlog, tlog)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

def _prompts(vocab):
    rng = np.random.default_rng(5)
    return [rng.integers(3, vocab, n).astype(np.int32) for n, _ in REQUESTS]


def _workload(engine, vocab):
    """Admit requests as slots free up, abort one mid-run; returns
    (finished, abort partial, slot of each request, cache snapshot taken
    right after a reused slot's prefill)."""
    prompts = _prompts(vocab)
    queue = list(range(len(REQUESTS)))
    finished, slots, partial, snapshot = {}, {}, None, None
    used = set()
    for step in range(200):
        while queue and engine.num_free_slots > 0:
            rid = queue.pop(0)
            engine.add_request(rid, prompts[rid], REQUESTS[rid][1])
            slots[rid] = engine.req_to_slot[rid]
            if slots[rid] in used and snapshot is None:
                snapshot = jax.tree_util.tree_map(
                    lambda a: np.array(a, np.float32), tuple(engine.cache[:3]))
            used.add(slots[rid])
        if step == ABORT[1]:
            res = engine.abort(ABORT[0])
            partial = (res.tokens.tolist(), res.logprobs, res.aborted, res.partial)
        for rid, toks, lps in engine.step():
            finished[rid] = (toks.tolist(), lps)
        if len(finished) == len(REQUESTS) - 1 and not queue:
            return finished, partial, slots, snapshot
    raise AssertionError(f"engine stalled: {sorted(finished)}")


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_engine_matches_the_jax_engine(family, dense, ssm):
    cfg, (japi, jparams), (tapi, tparams) = dense if family == "dense" else ssm
    jeng = JaxEngine(japi, jparams, **ENGINE)
    teng = DecodeEngine(tapi, tparams, device="cpu", **ENGINE)
    jfin, jpart, jslots, jsnap = _workload(jeng, cfg.vocab_size)
    tfin, tpart, tslots, tsnap = _workload(teng, cfg.vocab_size)
    assert tslots == jslots and len(set(tslots.values())) == ENGINE["num_slots"]
    assert sorted(tfin) == sorted(jfin) and ABORT[0] not in tfin
    for rid in jfin:
        assert tfin[rid][0] == jfin[rid][0], f"request {rid} diverged"
        np.testing.assert_allclose(tfin[rid][1], jfin[rid][1], rtol=TOL, atol=TOL)
    assert tpart[0] == jpart[0] and tpart[2:] == jpart[2:] == (True, True)
    np.testing.assert_allclose(tpart[1], jpart[1], rtol=TOL, atol=TOL)
    assert teng.total_decode_steps == jeng.total_decode_steps
    assert teng.total_tokens_decoded == jeng.total_tokens_decoded
    assert jsnap is not None and tsnap is not None
    for j, t in zip(jsnap, tsnap):
        np.testing.assert_allclose(t, j, rtol=TOL, atol=TOL)
    _cache_close(jeng.cache, teng.cache)
    assert teng.num_free_slots == ENGINE["num_slots"] and not teng.active.any()


def test_engine_prefill_buckets_dense_prompts_and_not_recurrent_ones(dense, ssm):
    assert DecodeEngine(dense[2][0], dense[2][1], device="cpu",
                        **ENGINE).prefill_bucket == 16
    assert DecodeEngine(ssm[2][0], ssm[2][1], device="cpu",
                        **ENGINE).prefill_bucket is None


def _greedy(engine, prompts, max_new=6):
    for rid, p in enumerate(prompts):
        engine.add_request(rid, p, max_new)
    out = {}
    for _ in range(100):
        for rid, toks, lps in engine.step():
            out[rid] = (toks.tolist(), lps)
        if len(out) == len(prompts):
            return out
    raise AssertionError("engine stalled")


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantize_on_sync_matches_the_jax_engine(dense, mode):
    cfg, (japi, jparams), (tapi, tparams) = dense
    prompts = _prompts(cfg.vocab_size)[:4]
    want = _greedy(JaxEngine(japi, jparams, quant_mode=mode, **ENGINE), prompts)
    teng = DecodeEngine(tapi, tparams, quant_mode=mode, device="cpu", **ENGINE)
    got = _greedy(teng, prompts)
    assert {r: t for r, (t, _) in got.items()} == {r: t for r, (t, _) in want.items()}
    for rid in want:
        np.testing.assert_allclose(got[rid][1], want[rid][1], rtol=TOL, atol=TOL)
    # a sync re-quantizes the new tree; a mode change applies at the next sync
    teng.set_quant_mode("off")
    assert teng.quant_mode == "off"
    teng.update_weights(tparams)
    assert teng.params is tparams
    with pytest.raises(ValueError):
        teng.set_quant_mode("int4")


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_kernel_switch_gives_the_plain_path_tokens_on_the_cpu(family, dense, ssm):
    cfg, _, (tapi, tparams) = dense if family == "dense" else ssm
    prompts = _prompts(cfg.vocab_size)[:4]
    runs = {impl: _greedy(DecodeEngine(tapi, tparams, device="cpu", attn_impl=impl,
                                       **ENGINE), prompts)
            for impl in ("kernel", "ref")}
    for rid, (toks, lps) in runs["ref"].items():
        assert runs["kernel"][rid][0] == toks
        np.testing.assert_allclose(runs["kernel"][rid][1], lps, rtol=TOL, atol=TOL)


def test_engines_refuse_what_they_do_not_take(dense, ssm):
    cfg, _, (tapi, tparams) = dense
    with pytest.raises(ValueError, match="attn_impl"):
        DecodeEngine(tapi, tparams, device="cpu", attn_impl="pallas", **ENGINE)
    with pytest.raises(ValueError, match="quant_mode"):
        DecodeEngine(tapi, tparams, device="cpu", quant_mode="int4", **ENGINE)
    with pytest.raises(ValueError, match="differs"):
        DecodeEngine(tapi, tparams, device="meta", **ENGINE)
    capped = get_api(dataclasses.replace(tapi.cfg, attn_logit_softcap=30.0),
                     device="cpu")
    eng = DecodeEngine(capped, tparams, device="cpu", **ENGINE)
    eng.add_request(0, np.arange(3, 8, dtype=np.int32), 4)
    with pytest.raises(ValueError, match="softcap"):
        eng.step()
    windowed = get_api(dataclasses.replace(tapi.cfg, sliding_window=16), device="cpu")
    with pytest.raises(ValueError, match="max_total_len"):
        DecodeEngine(windowed, tparams, device="cpu", **ENGINE)
    sapi, sparams = ssm[2]
    assert sapi.init_paged_cache is None and sapi.decode_paged is None
    with pytest.raises(ValueError, match="use the slot DecodeEngine"):
        PagedDecodeEngine(sapi, sparams, device="cpu", num_slots=2, max_total_len=32)


# ---------------------------------------------------------------------------
# proxy
# ---------------------------------------------------------------------------

@pytest.mark.timeout(300)
def test_proxy_over_the_slot_engine_serves_the_bare_engine_tokens(dense):
    cfg, _, (tapi, tparams) = dense
    prompts = _prompts(cfg.vocab_size)[:4]
    bare = _greedy(DecodeEngine(tapi, tparams, device="cpu", **ENGINE), prompts)
    want = sum(4 if i == 3 else 1 for i in range(len(prompts)))
    lock, done, results, counts = threading.Lock(), threading.Event(), [], {}

    def callback(res):
        with lock:
            results.append(res)
            key = (res.task.prompt_id, res.task.replica_idx)
            counts[key] = counts.get(key, 0) + 1
            if len(results) == want:
                done.set()

    engine = DecodeEngine(tapi, tparams, device="cpu", **ENGINE)
    proxy = LLMProxy(engine).start()
    try:
        for i, p in enumerate(prompts):
            meta = {"num_return_sequences": 4} if i == 3 else {}
            proxy.generate(RolloutTask(task_id=2000 + i, prompt_id=i, replica_idx=0,
                                       prompt_tokens=p, max_new_tokens=6, meta=meta),
                           version=0, callback=callback)
        assert done.wait(120), f"{len(results)}/{want} callbacks fired"
    finally:
        proxy.stop()
    assert not proxy._thread.is_alive()
    assert len(counts) == want and set(counts.values()) == {1}
    for res in results:
        assert not res.aborted
        assert res.tokens.tolist() == bare[res.task.prompt_id][0]
    assert proxy.requests_completed == want and proxy.load() == 0
    assert engine.num_free_slots == ENGINE["num_slots"]


# ---------------------------------------------------------------------------
# pass@k, data, rewards
# ---------------------------------------------------------------------------

def _parity_reward(sample):
    """1.0 when the prompt's token sum and the first response token have
    the same parity: splits random-weight responses, unlike exact match."""
    first = int(np.asarray(sample.response_tokens)[0])
    return float((int(np.asarray(sample.prompt_tokens).sum()) + first) % 2 == 0)


def test_evaluate_passk_matches_the_jax_evaluation(dense):
    _, (japi, jparams), (tapi, tparams) = dense
    kw = dict(num_prompts=6, n_per_prompt=4, ks=(1, 2, 4), num_slots=8,
              temperature=0.0, seed=3)
    for reward in (None, _parity_reward):
        want = jax_evaluate_passk(japi, jparams, reward_fn=reward, **kw)
        got = evaluate_passk(tapi, tparams, reward_fn=reward, device="cpu", **kw)
        got_fields = dataclasses.asdict(got)
        assert got_fields.pop("decode_steps") > 0       # the port's own field
        assert got_fields == dataclasses.asdict(want)
    assert 0.0 < got.pass_at_1 < 1.0           # the parity reward splits them


def test_pass_at_k_estimator_matches_on_a_grid():
    for n in range(1, 11):
        for c in range(n + 1):
            for k in range(1, n + 1):
                assert pass_at_k_estimator(n, c, k) == jax_estimator(n, c, k)


def test_arithmetic_task_and_verifier_match_the_jax_copies():
    jt, tt = JaxTask(max_operand=30, ops=("+", "*", "-"), seed=9), \
        ArithmeticTask(max_operand=30, ops=("+", "*", "-"), seed=9)
    jv, tv = JaxVerifier(jt), ArithmeticVerifier(tt)
    rng = np.random.default_rng(2)
    for i in range(40):
        jp, tp = jt.sample_problem(), tt.sample_problem()
        assert (jp.a, jp.b, jp.op) == (tp.a, tp.b, tp.op)
        prompt = tp.prompt_tokens()
        np.testing.assert_array_equal(prompt, jp.prompt_tokens())
        response = (tp.answer_tokens() if i % 3 == 0
                    else rng.integers(0, 17, int(rng.integers(1, 5))).astype(np.int32))
        js = JaxSample(sample_id=i, prompt_id=i, replica_idx=0, prompt_tokens=prompt,
                       response_tokens=response, logprobs=np.zeros(len(response)))
        ts = Sample(sample_id=i, prompt_id=i, replica_idx=0, prompt_tokens=prompt,
                    response_tokens=response, logprobs=np.zeros(len(response)))
        assert tv(ts) == jv(js)
