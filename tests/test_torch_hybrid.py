"""The port's RecurrentGemma (``hybrid``) family against the JAX package on
the same inputs and the same weights (carried across by
``params_from_jax``): the RG-LRU scan, the recurrent block and step, the
full model's apply, prefill and decode with their caches, the slot engine
(greedy tokens, counters, abort, the cache after slot reuse) and
quantize-on-sync (codes and scales bit-equal, the tail unquantized).

The model is one pattern group (rglru, rglru, attn) plus a two-layer tail,
so the tail's path and its unquantized leaves are exercised.  The
reference initialises ``lam`` to 2 and ``ba``/``bi``/``conv_b`` to 0, so
that a = exp(-8 softplus(2) r) ~ 2e-4 and the recurrence carries almost no
state: those leaves are redrawn before anything is compared.

Tolerance: fp32 2e-5 for the scan (as tests/test_kernels.py), 1e-5 for
model outputs, logits and caches (the two frameworks reduce in different
orders); tokens, positions, codes and scales exact.  On the CPU
``attn_impl="kernel"`` runs the kernels' plain versions, so both values of
the switch are held to the reference."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny
from repro.kernels import ref as jref
from repro.kernels.rglru_scan import rglru_scan as jax_rglru_scan
from repro.models import get_api as jget_api
from repro.models import rglru as jrglru
from repro.quant import core as jquant
from repro.rollout.engine import DecodeEngine as JaxEngine
from repro_torch import quant
from repro_torch.convert import params_from_jax, params_to_numpy, slot_cache_from_jax
from repro_torch.kernels import decode_attention as da_mod
from repro_torch.kernels import rglru_scan as scan_mod
from repro_torch.kernels.ref import rglru_scan_ref
from repro_torch.models import attention, get_api, rglru, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.rollout import DecodeEngine

# tiny shapes: one torch thread, so the suite's parallel workers keep their
# cores (torch's pool would otherwise spin on all of them)
torch.set_num_threads(1)

TOL = 1e-5
SCAN_TOL = 2e-5
# the window is the sequence budget: the slot engine refuses a ring cache
ENGINE = dict(num_slots=4, max_total_len=24, eos_id=99, temperature=0.0)
REQUESTS = [(5, 6), (9, 8), (13, 4), (5, 10), (9, 5), (13, 7), (5, 6)]
ABORT = (3, 4)      # (request id, engine step at which it is aborted)


def _perturb(jparams, seed=7):
    """Redraw the recurrence's gate leaves so that the state carries."""
    rng = np.random.default_rng(seed)

    def one(path, a):
        name = getattr(path[-1], "key", None)
        if name == "lam":
            return jnp.asarray(rng.uniform(-8.0, -1.0, a.shape), a.dtype)
        if name in ("ba", "bi", "conv_b"):
            return jnp.asarray(rng.normal(scale=0.5, size=a.shape), a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(one, jparams)


@pytest.fixture(scope="module")
def models():
    cfg = tiny("recurrentgemma-9b", num_layers=5, sliding_window=24,
               vocab_size=32, dtype="float32")
    japi = jget_api(cfg)
    jparams = _perturb(japi.init(jax.random.PRNGKey(0)))
    tapi = get_api(ModelConfig(**dataclasses.asdict(cfg)), device="cpu")
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return cfg, (japi, jparams), (tapi, tparams)


def _close(j, t, tol=TOL):
    np.testing.assert_allclose(np.asarray(j, np.float32), t.float().numpy(),
                               rtol=tol, atol=tol)


def _jax_layer(cfg, jparams, i):
    """The JAX tree of layer ``i`` in execution order."""
    pattern, n_groups, _ = transformer._hybrid_layout(cfg)
    if i >= n_groups * len(pattern):
        return jparams["tail"][i - n_groups * len(pattern)]
    g, pos = divmod(i, len(pattern))
    return jax.tree_util.tree_map(lambda a: a[g],
                                  jparams["blocks"][f"{pos}_{pattern[pos]}"])


def _cache_close(jcache, tcache, tol=TOL):
    """A JAX hybrid cache (dict of stacked groups + tail) against the
    port's ``HybridCache``, leaf by leaf in execution order."""
    want = slot_cache_from_jax(jax.tree_util.tree_map(np.asarray, jcache), "cpu")
    assert want.kinds == tcache.kinds
    np.testing.assert_array_equal(want.kv.pos.numpy(), tcache.kv.pos.numpy())
    for w, t in ((want.kv.k, tcache.kv.k), (want.kv.v, tcache.kv.v),
                 (want.rglru.h, tcache.rglru.h), (want.rglru.conv, tcache.rglru.conv)):
        torch.testing.assert_close(t, w, rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------

def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        return {path: shape for k, v in tree.items()
                for path, shape in _shapes(v, f"{prefix}/{k}").items()}
    return {prefix: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}


def test_layers_run_in_the_reference_order_with_its_leaves(models):
    cfg, (_, jparams), (tapi, tparams) = models
    kinds = transformer.layer_kinds(cfg)
    assert kinds == (("rglru", 0), ("rglru", 1), ("attn", 0), ("rglru", 2), ("rglru", 3))
    assert transformer.block_groups(cfg) == [0, 1, 2, None, None]
    fresh = tapi.init(0)["blocks"]
    for i, (kind, _) in enumerate(kinds):
        jlayer = _jax_layer(cfg, jparams, i)
        assert ("rec" in tparams["blocks"][i]) == (kind == "rglru")
        # the same leaf names, shapes and dtypes as the reference's init
        assert _shapes(fresh[i]) == _shapes(jlayer)
        for path, a in jax.tree_util.tree_leaves_with_path(jlayer):
            t = tparams["blocks"][i]
            for k in path:
                t = t[k.key]
            np.testing.assert_array_equal(np.asarray(a), t.numpy())
    assert tparams["blocks"][1]["rec"]["lam"].dtype == torch.float32
    back = params_to_numpy(tparams, cfg)
    want = jax.tree_util.tree_leaves_with_path(jparams)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, w in want:
        np.testing.assert_array_equal(np.asarray(w), got[path])
    with pytest.raises(ValueError, match="cfg"):
        params_to_numpy(tparams)


def test_cache_stacks_each_kind_and_rows_are_views(models):
    cfg, _, (tapi, _) = models
    cache = tapi.init_cache(3, 24)
    assert isinstance(cache, transformer.HybridCache)
    assert cache.kv.k.shape == (1, 3, 24, cfg.num_kv_heads, cfg.resolved_head_dim)
    assert cache.rglru.h.shape == (4, 3, cfg.lru_width)
    assert cache.rglru.conv.shape == (4, 3, cfg.conv_width - 1, cfg.lru_width)
    assert cache.rglru.h.dtype == torch.float32
    assert not cache.kv.ring and (cache.kv.pos == -1).all()
    row = cache.rows(1, 2)
    row.rglru.h.fill_(3.0)
    row.kv.pos.fill_(7)
    assert (cache.rglru.h[:, 1] == 3.0).all() and (cache.rglru.h[:, 0] == 0).all()
    assert (cache.kv.pos[:, 1] == 7).all() and (cache.kv.pos[:, 2] == -1).all()
    assert cache.kinds == transformer.layer_kinds(cfg)


# ---------------------------------------------------------------------------
# the RG-LRU scan
# ---------------------------------------------------------------------------

def _scan_inputs(seed, b, t, w):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.01, 0.99, size=(b, t, w)).astype(np.float32)
    bb = (rng.normal(size=(b, t, w)) * 0.5).astype(np.float32)
    h0 = (rng.normal(size=(b, w)) * 0.5).astype(np.float32)
    return a, bb, h0


@pytest.mark.parametrize("b,t,w", [(2, 64, 96), (3, 32, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scan_matches_the_pallas_kernel_and_the_oracle(b, t, w, dtype):
    a, bb, h0 = _scan_inputs(t, b, t, w)
    tdt = getattr(torch, dtype)
    ta, tb = torch.from_numpy(a).to(tdt), torch.from_numpy(bb).to(tdt)
    hs, h_last = scan_mod.rglru_scan(ta, tb, torch.from_numpy(h0))
    assert hs.dtype == h_last.dtype == torch.float32 and hs.shape == (b, t, w)
    # the same (rounded) inputs on the JAX side: fp32 arithmetic on both
    ja, jb = (jnp.asarray(x.float().numpy()).astype(getattr(jnp, dtype)) for x in (ta, tb))
    for jhs, jlast in (jax_rglru_scan(ja, jb, jnp.asarray(h0), block_t=32, block_w=32,
                                      interpret=True),
                       jref.rglru_scan_ref(ja, jb, jnp.asarray(h0))):
        _close(jhs, hs, SCAN_TOL)
        _close(jlast, h_last, SCAN_TOL)


def test_scan_takes_any_length_and_continues_a_carried_state():
    """T = 37 is no multiple of the TPU kernel's block: held to the oracle;
    scanning [0:T] equals scanning [0:19] then [19:T] from the carried
    state."""
    a, bb, h0 = (torch.from_numpy(x) for x in _scan_inputs(3, 2, 37, 48))
    hs, h_last = scan_mod.rglru_scan(a, bb, h0)
    jhs, jlast = jref.rglru_scan_ref(*(jnp.asarray(x.numpy()) for x in (a, bb, h0)))
    _close(jhs, hs, SCAN_TOL)
    _close(jlast, h_last, SCAN_TOL)
    hs1, h_mid = scan_mod.rglru_scan(a[:, :19], bb[:, :19], h0)
    hs2, h_end = scan_mod.rglru_scan(a[:, 19:], bb[:, 19:], h_mid)
    torch.testing.assert_close(torch.cat([hs1, hs2], dim=1), hs, rtol=0, atol=0)
    torch.testing.assert_close(h_end, h_last, rtol=0, atol=0)


@pytest.mark.parametrize("t", [1, 5, 16, 33])
def test_doubling_scan_matches_the_reference_associative_scan(t):
    a, bb, h0 = _scan_inputs(t + 10, 2, t, 24)
    want = jrglru.rglru_scan(jnp.asarray(a), jnp.asarray(bb), jnp.asarray(h0))
    got = rglru.doubling_scan(*(torch.from_numpy(x) for x in (a, bb, h0)))
    _close(want, got, SCAN_TOL)
    torch.testing.assert_close(got, rglru_scan_ref(*(torch.from_numpy(x)
                                                     for x in (a, bb, h0)))[0],
                               rtol=SCAN_TOL, atol=SCAN_TOL)


# ---------------------------------------------------------------------------
# block, step and model
# ---------------------------------------------------------------------------

def _state(cfg, rng, b):
    w = cfg.lru_width
    return (rng.normal(size=(b, w)).astype(np.float32),
            rng.normal(size=(b, cfg.conv_width - 1, w)).astype(np.float32))


@pytest.mark.parametrize("attn_impl", ["kernel", "ref"])
@pytest.mark.parametrize("t", [7, 1])
def test_recurrent_block_and_step_match_jax(models, attn_impl, t):
    cfg, (_, jparams), (_, tparams) = models
    rng = np.random.default_rng(t)
    b = 2
    x = rng.normal(size=(b, t, cfg.d_model)).astype(np.float32)
    h, conv = _state(cfg, rng, b)
    jp = _jax_layer(cfg, jparams, 3)["rec"]            # a tail layer
    tp = tparams["blocks"][3]["rec"]
    jstate = jrglru.RGLRUState(jnp.asarray(h), jnp.asarray(conv))
    tstate = rglru.RGLRUState(torch.from_numpy(h), torch.from_numpy(conv))
    fns = [(jrglru.recurrent_block, rglru.recurrent_block)]
    if t == 1:
        fns.append((jrglru.recurrent_step, rglru.recurrent_step))
    for jfn, tfn in fns:
        jy, jst = jfn(jp, cfg, jnp.asarray(x), jstate)
        ty, tst = tfn(tp, cfg, torch.from_numpy(x), tstate, attn_impl=attn_impl)
        _close(jy, ty)
        _close(jst.h, tst.h)
        _close(jst.conv, tst.conv)
    # the block is functional: the state it was given is untouched
    np.testing.assert_array_equal(tstate.h.numpy(), h)


@pytest.mark.parametrize("attn_impl", ["kernel", "ref"])
def test_prefill_decode_and_apply_match_jax(models, attn_impl):
    cfg, (japi, jparams), (tapi, tparams) = models
    rng = np.random.default_rng(2)
    b, s = 2, 9
    tokens = rng.integers(3, cfg.vocab_size, (b, s)).astype(np.int32)
    valid = np.ones((b, s), bool)          # exact length, as the engine feeds
    jcache = japi.init_cache(b, 24)
    jlog, jcache = japi.prefill(jparams, {"tokens": jnp.asarray(tokens),
                                          "valid": jnp.asarray(valid)}, jcache)
    tcache = tapi.init_cache(b, 24)
    tlog, tcache = tapi.prefill(tparams, {"tokens": torch.from_numpy(tokens),
                                          "valid": torch.from_numpy(valid)},
                                tcache, attn_impl=attn_impl)
    _close(jlog, tlog)
    _cache_close(jcache, tcache)
    for step in range(3):
        tok = rng.integers(3, cfg.vocab_size, (b,)).astype(np.int32)
        pos = np.full((b,), s + step, np.int32)
        jlog, jcache = japi.decode_step(jparams, jnp.asarray(tok),
                                        jnp.asarray(pos), jcache)
        tlog, tcache = tapi.decode_step(tparams, torch.from_numpy(tok),
                                        torch.from_numpy(pos), tcache,
                                        attn_impl=attn_impl)
        assert tlog.shape == (b, cfg.vocab_size) and tlog.dtype == torch.float32
        _close(jlog, tlog)
        _cache_close(jcache, tcache)
    # a full forward longer than the window: the attention layers mask it
    long = rng.integers(3, cfg.vocab_size, (b, 30)).astype(np.int32)
    jfull, _ = japi.apply(jparams, {"tokens": jnp.asarray(long)})
    tfull, _ = tapi.apply(tparams, {"tokens": torch.from_numpy(long)},
                          attn_impl=attn_impl)
    _close(jfull, tfull)


def test_decode_continues_a_cache_carried_across(models):
    """A JAX cache carried across by ``slot_cache_from_jax`` decodes on in
    the port exactly as it does in the reference."""
    cfg, (japi, jparams), (tapi, tparams) = models
    rng = np.random.default_rng(4)
    tokens = rng.integers(3, cfg.vocab_size, (3, 5)).astype(np.int32)
    _, jcache = japi.prefill(jparams, {"tokens": jnp.asarray(tokens)},
                             japi.init_cache(3, 16))
    tcache = slot_cache_from_jax(jax.tree_util.tree_map(np.asarray, jcache), "cpu")
    assert tcache.kv.max_len == 16
    tok = rng.integers(3, cfg.vocab_size, (3,)).astype(np.int32)
    pos = np.full((3,), 5, np.int32)
    jlog, jcache = japi.decode_step(jparams, jnp.asarray(tok), jnp.asarray(pos), jcache)
    tlog, tcache = tapi.decode_step(tparams, torch.from_numpy(tok),
                                    torch.from_numpy(pos), tcache)
    _close(jlog, tlog)
    _cache_close(jcache, tcache)


def test_kernel_switch_reaches_both_wrappers(models, monkeypatch):
    """``attn_impl="kernel"`` goes through the ``rglru_scan`` wrapper once
    per RG-LRU layer and forward and through the decode-attention wrapper
    once per attention layer and decode step; ``"ref"`` through neither."""
    cfg, _, (tapi, tparams) = models
    calls = []

    def counted(real, name):
        def fn(*a, **k):
            calls.append((name, tuple(a[0].shape)))
            return real(*a, **k)
        return fn

    monkeypatch.setattr(rglru, "rglru_scan", counted(scan_mod.rglru_scan, "scan"))
    monkeypatch.setattr(attention, "decode_attention_kernel",
                        counted(da_mod.decode_attention, "decode"))
    tokens = torch.arange(3, 9, dtype=torch.int32)[None]
    cache = tapi.init_cache(1, 16)
    tapi.prefill(tparams, {"tokens": tokens}, cache, attn_impl="kernel")
    w = cfg.lru_width
    assert calls == [("scan", (1, 6, w))] * 4
    tapi.decode_step(tparams, tokens[:, 0], torch.tensor([6]), cache, attn_impl="kernel")
    assert calls[4:] == [("scan", (1, 1, w))] * 2 + [("decode", (1, cfg.num_heads,
                                                                 cfg.resolved_head_dim))] \
        + [("scan", (1, 1, w))] * 2
    tapi.decode_step(tparams, tokens[:, 0], torch.tensor([7]), cache, attn_impl="ref")
    assert len(calls) == 9
    with pytest.raises(ValueError, match="attn_impl"):
        transformer.lm_decode_step(tparams, cfg, tokens[:, 0], torch.tensor([8]),
                                   cache, attn_impl="pallas")


def test_lm_apply_attention_layers_run_flash_attention(models, monkeypatch):
    """``lm_apply(attn_impl="kernel")`` sends each attention layer through
    ``flash_attention`` (its plain version on the CPU), once per forward,
    with the config's window, and its logits equal the JAX package's
    ``lm_apply`` (fp32, 1e-5) over a sequence longer than the window."""
    from repro.models import transformer as jtransformer

    cfg, (_, jparams), (tapi, tparams) = models
    calls = []

    def counted(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), kw["window"]))
        return flash(q, k, v, **kw)

    flash = attention.flash_attention
    monkeypatch.setattr(attention, "flash_attention", counted)
    tokens = np.random.default_rng(6).integers(3, cfg.vocab_size, (2, 30)).astype(np.int32)
    want, _ = jtransformer.lm_apply(jparams, cfg, jnp.asarray(tokens))
    got, _ = transformer.lm_apply(tparams, tapi.cfg, torch.from_numpy(tokens),
                                  attn_impl="kernel")
    _close(want, got)
    n_attn = sum(kind == "attn" for kind, _ in transformer.layer_kinds(tapi.cfg))
    assert n_attn >= 1
    d = cfg.resolved_head_dim
    assert calls == [((2, cfg.num_heads, 30, d), (2, cfg.num_kv_heads, 30, d),
                      cfg.sliding_window)] * n_attn
    transformer.lm_apply(tparams, tapi.cfg, torch.from_numpy(tokens), attn_impl="ref")
    assert len(calls) == n_attn
    with pytest.raises(ValueError, match="positions"):
        transformer.lm_apply(tparams, tapi.cfg, torch.from_numpy(tokens),
                             positions=torch.arange(30)[None].expand(2, 30))


def test_the_scan_kernel_refuses_a_gradient_and_the_plain_scan_takes_one(models):
    """The RG-LRU kernel has no backward: a differentiable forward on
    ``attn_impl="kernel"`` raises on every device; ``"ref"`` (the doubling
    scan) gives gradients that reach the recurrence's leaves."""
    cfg, _, (tapi, tparams) = models
    params = {k: v for k, v in tparams.items()}
    params["blocks"] = [dict(lp) for lp in tparams["blocks"]]
    lam = params["blocks"][0]["rec"] = dict(params["blocks"][0]["rec"])
    lam["lam"] = lam["lam"].clone().requires_grad_(True)
    tokens = torch.arange(3, 12, dtype=torch.int32)[None]
    with pytest.raises(RuntimeError, match="no backward"):
        tapi.apply(params, {"tokens": tokens})
    logits, _ = tapi.apply(params, {"tokens": tokens}, attn_impl="ref")
    logits.sum().backward()
    assert lam["lam"].grad is not None and lam["lam"].grad.abs().sum() > 0


# ---------------------------------------------------------------------------
# engine and quantize-on-sync
# ---------------------------------------------------------------------------

def _prompts(vocab):
    rng = np.random.default_rng(5)
    return [rng.integers(3, vocab, n).astype(np.int32) for n, _ in REQUESTS]


def _cache_snapshot(cache):
    """Host copies of every leaf, JAX dict or port ``HybridCache``."""
    if isinstance(cache, dict):
        cache = slot_cache_from_jax(jax.tree_util.tree_map(np.asarray, cache), "cpu")
    return [t.clone() for t in (cache.kv.k, cache.kv.v, cache.kv.pos, cache.rglru.h,
                                cache.rglru.conv)]


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
                snapshot = _cache_snapshot(engine.cache)
            used.add(slots[rid])
        if step == ABORT[1]:
            res = engine.abort(ABORT[0])
            partial = (res.tokens.tolist(), res.logprobs, res.aborted, res.partial)
        for rid, toks, lps in engine.step():
            finished[rid] = (toks.tolist(), lps)
        if len(finished) == len(REQUESTS) - 1 and not queue:
            return finished, partial, slots, snapshot
    raise AssertionError(f"engine stalled: {sorted(finished)}")


def test_engine_matches_the_jax_engine(models):
    cfg, (japi, jparams), (tapi, tparams) = models
    jeng = JaxEngine(japi, jparams, **ENGINE)
    teng = DecodeEngine(tapi, tparams, device="cpu", **ENGINE)
    assert teng.prefill_bucket is None           # exact-length prefill
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
    # the reused slot's row was replaced whole: k/v, positions, h and conv
    for j, t in zip(jsnap, tsnap):
        torch.testing.assert_close(t.float(), j.float(), rtol=TOL, atol=TOL)
    _cache_close(jeng.cache, teng.cache)
    assert teng.num_free_slots == ENGINE["num_slots"] and not teng.active.any()


def _code_bits(codes):
    """Codes as raw bytes: int8 as it is, fp8 as its bit pattern."""
    if isinstance(codes, torch.Tensor):
        return codes.view(torch.int8).numpy()
    return np.asarray(codes).view(np.int8)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantize_on_sync_matches_the_jax_package(models, mode):
    """Codes and scales bit-equal to the reference's, each pattern position
    with its own scales over the groups, 1-D leaves of the stacked groups
    (lam, ba, bi, conv_b) quantized, the tail left as it is; then the slot
    engine's tokens equal the JAX engine's."""
    cfg, (japi, jparams), (tapi, tparams) = models
    jq = jquant.quantize_params(jparams, mode)
    tq = quant.quantize_params(tparams, mode, groups=transformer.block_groups(cfg))
    assert not jquant.is_quantized_tree(jq["tail"])
    for i in (3, 4):
        assert tq["blocks"][i] is tparams["blocks"][i]
    pattern, n_groups, _ = transformer._hybrid_layout(cfg)
    seen = 0
    for pos, kind in enumerate(pattern):
        jtree = jq["blocks"][f"{pos}_{kind}"]
        for path, jleaf in jax.tree_util.tree_leaves_with_path(
                jtree, is_leaf=lambda x: isinstance(x, jquant.QuantLeaf)):
            names = [k.key for k in path]
            for g in range(n_groups):
                tleaf = tq["blocks"][g * len(pattern) + pos]
                for k in names:
                    tleaf = tleaf[k]
                if not isinstance(jleaf, jquant.QuantLeaf):
                    assert not isinstance(tleaf, quant.QuantLeaf), names
                    continue
                seen += 1
                assert np.array_equal(_code_bits(jleaf.codes)[g], _code_bits(tleaf.codes))
                np.testing.assert_array_equal(np.asarray(jleaf.scale).reshape(-1),
                                              tleaf.scale.numpy().reshape(-1))
    assert isinstance(tq["blocks"][0]["rec"]["lam"], quant.QuantLeaf)
    assert isinstance(tq["blocks"][0]["rec"]["conv_w"], quant.QuantLeaf)
    assert not isinstance(tq["blocks"][0]["ln1"]["scale"], quant.QuantLeaf)
    assert seen > 20
    # the engine quantizes in the same groups and decodes the reference's tokens
    prompts = _prompts(cfg.vocab_size)[:4]

    def greedy(engine):
        for rid, p in enumerate(prompts):
            engine.add_request(rid, p, 6)
        out = {}
        for _ in range(100):
            for rid, toks, lps in engine.step():
                out[rid] = (toks.tolist(), lps)
            if len(out) == len(prompts):
                return out
        raise AssertionError("engine stalled")

    want = greedy(JaxEngine(japi, jparams, quant_mode=mode, **ENGINE))
    teng = DecodeEngine(tapi, tparams, quant_mode=mode, device="cpu", **ENGINE)
    got = greedy(teng)
    assert {r: t for r, (t, _) in got.items()} == {r: t for r, (t, _) in want.items()}
    for rid in want:
        np.testing.assert_allclose(got[rid][1], want[rid][1], rtol=TOL, atol=TOL)
    assert teng.params["blocks"][4] is tparams["blocks"][4]
