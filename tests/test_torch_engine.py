"""The slice's bar: one greedy workload through the JAX engine and the
port's engine, from the same weights.  Decoded tokens must be identical,
the prefill/cache/fork counters exactly equal, and the page audit clean
after every step.  The workload mixes prompt lengths, a COW group of 4, a
shared preamble under the prefix cache, abort(retain=True) -> resume, and a
weight update that flushes the cache."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from conftest import tiny
from repro.models import get_api as jget_api
from repro.rollout.paged_engine import PagedDecodeEngine as JaxEngine
from repro_torch.convert import params_from_jax
from repro_torch.models import get_api
from repro_torch.models.config import ModelConfig
from repro_torch.rollout import PagedDecodeEngine

# tiny shapes: one torch thread, so the suite's parallel workers keep their
# cores (torch's pool would otherwise spin on all of them)
torch.set_num_threads(1)

COUNTERS = ("total_prefill_tokens", "total_prefill_chunks", "cache_hit_tokens",
            "total_groups_forked", "total_pages_copied", "peak_pages_in_use",
            "total_decode_steps", "total_tokens_decoded", "cache_lookups",
            "cache_hits", "cache_ext_hits", "cache_evicted_pages")
ENGINE = dict(num_slots=8, max_total_len=64, page_size=8, prefill_chunk=8,
              eos_id=99, temperature=0.0, prefix_cache=True)


@pytest.fixture(scope="module")
def models():
    cfg = tiny("qwen3-4b", dtype="float32", vocab_size=32)
    japi = jget_api(cfg)
    jparams = [japi.init(jax.random.PRNGKey(i)) for i in (0, 1)]
    tapi = get_api(ModelConfig(**dataclasses.asdict(cfg)), device="cpu")
    tparams = [params_from_jax(jax.tree_util.tree_map(np.asarray, p), "cpu")
               for p in jparams]
    return cfg, (japi, jparams), (tapi, tparams)


def _prompts():
    rng = np.random.default_rng(3)
    pre = rng.integers(1, 30, 16)
    tail = [rng.integers(1, 30, n) for n in (3, 9, 20)]
    prompts = [np.concatenate([pre, t]).astype(np.int32) for t in tail]
    prompts.append(rng.integers(1, 30, 13).astype(np.int32))     # group prompt
    return prompts


def _workload(engine, params2):
    """Drive the scripted workload; returns (finished, aborted partials)."""
    p = _prompts()
    engine.add_request(0, p[0], 10)
    engine.add_request(1, p[1], 12)
    engine.submit_group([10, 11, 12, 13], p[3], 6)
    finished, partial = {}, {}
    for step in range(300):
        if step == 3:
            engine.add_request(2, p[2], 8)
        if step == 6:
            res = engine.abort(1, retain=True)
            partial[1] = (res.tokens.tolist(), res.resumable)
        if step == 8:
            assert engine.can_resume(1, 12 - len(partial[1][0]))
            engine.resume_request(1, 21, 12 - len(partial[1][0]))
        if step == 10:
            engine.update_weights(params2)
        if step == 12:
            engine.add_request(3, p[0], 6)      # the preamble again, post-flush
        for rid, toks, lps in engine.step():
            finished[rid] = (toks.tolist(), lps)
        engine.audit_pages()
        if len(finished) == 8:
            return finished, partial
    raise AssertionError(f"engine stalled: {sorted(finished)}")


def test_greedy_workload_is_byte_identical_with_equal_counters(models):
    _, (japi, jparams), (tapi, tparams) = models
    jeng = JaxEngine(japi, jparams[0], **ENGINE)
    teng = PagedDecodeEngine(tapi, tparams[0], device="cpu", **ENGINE)
    jfin, jpart = _workload(jeng, jparams[1])
    tfin, tpart = _workload(teng, tparams[1])
    assert tpart == jpart and tpart[1][1] is True
    assert sorted(tfin) == sorted(jfin) == [0, 2, 3, 10, 11, 12, 13, 21]
    for rid in jfin:
        assert tfin[rid][0] == jfin[rid][0], f"request {rid} diverged"
        np.testing.assert_allclose(tfin[rid][1], jfin[rid][1], rtol=1e-5, atol=1e-5)
    for name in COUNTERS:
        assert getattr(teng, name) == getattr(jeng, name), name
    assert teng.cache_hit_tokens > 0 and teng.total_groups_forked == 1
    assert teng.retained == {} and teng.cache_pages_held == jeng.cache_pages_held


def test_transfer_between_engines_matches_the_jax_engine(models):
    """Export a retained request and a cached prefix from one engine,
    import them into another: same pages landed, same counters."""
    _, (japi, jparams), (tapi, tparams) = models
    p = _prompts()
    counts = []
    for api, params, make in (
            (japi, jparams[0], lambda a, q: JaxEngine(a, q, **ENGINE)),
            (tapi, tparams[0], lambda a, q: PagedDecodeEngine(a, q, device="cpu",
                                                              **ENGINE))):
        src, dst = make(api, params), make(api, params)
        src.add_request(0, p[0], 10)
        src.add_request(1, p[1], 10)
        for _ in range(6):
            src.step()
        src.abort(0, retain=True)
        rec = src.export_retained(0)
        assert dst.import_retained(0, rec)
        pulled = dst.import_prefix(src.export_prefix(p[1]))
        dst.resume_request(0, 5, 4)
        out = {}
        for _ in range(50):
            for rid, toks, _ in dst.step():
                out[rid] = toks.tolist()
            dst.audit_pages()
            if out:
                break
        counts.append((pulled, out, src.pages_transferred_out, dst.pages_transferred_in,
                       src.transfer_bytes_out, dst.transfer_bytes_in,
                       dst.transfer_device_ops, dst.peak_pages_in_use))
    assert counts[1] == counts[0]


def test_sampling_engine_forks_a_group_and_stays_audited(models):
    _, _, (tapi, tparams) = models
    eng = PagedDecodeEngine(tapi, tparams[0], device="cpu",
                            **dict(ENGINE, temperature=1.0, seed=5))
    eng.submit_group([0, 1, 2, 3], _prompts()[3], 6)
    done = {}
    for _ in range(100):
        for rid, toks, lps in eng.step():
            done[rid] = (toks, lps)
        eng.audit_pages()
        if len(done) == 4:
            break
    assert sorted(done) == [0, 1, 2, 3] and eng.total_groups_forked == 1
    for toks, lps in done.values():
        assert len(toks) == 6 and np.isfinite(lps).all() and (lps <= 0).all()
    # the generator is seeded: a second engine draws the same tokens
    eng2 = PagedDecodeEngine(tapi, tparams[0], device="cpu",
                             **dict(ENGINE, temperature=1.0, seed=5))
    eng2.submit_group([0, 1, 2, 3], _prompts()[3], 6)
    done2 = {}
    for _ in range(100):
        for rid, toks, _ in eng2.step():
            done2[rid] = toks.tolist()
        if len(done2) == 4:
            break
    assert done2 == {rid: t.tolist() for rid, (t, _) in done.items()}
    assert torch.is_tensor(eng.cache.k_pages)
