"""The port's quantized rollouts against the JAX package, on the CPU.

Weight quantization (int8, fp8) and ``quantize_kv`` must give bit-equal
codes and scales from the same inputs; the paged engine under
``kv_quant="int8"`` and ``quant_mode`` int8/fp8 must decode the same greedy
tokens with the same page and cache counters; int8 pages must move
between engines with their scales.  The JAX side runs as
``tests/test_quant.py`` runs it (CPU, Pallas in interpret mode).

Tolerances: weight codes, scales and dequantized weights, and the codes
and scales ``quantize_kv`` makes from shared inputs, are compared exactly
(the same fp32 arithmetic on both sides); KV scales written by a forward at
1e-6 relative (absmax of K/V from fp32 matmuls summed in another order);
logits and logprobs at 1e-5 (fp32 reduction order); greedy tokens and
counters exactly."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny
from repro.kernels.paged_decode_attention import (
    paged_decode_attention as jax_paged_decode_attention)
from repro.models import get_api as jget_api
from repro.models import paged as jpaged
from repro.quant import core as jquant
from repro.rollout.paged_engine import PagedDecodeEngine as JaxEngine
from repro_torch import quant
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.kernels import paged_decode_attention as pda
from repro_torch.kernels import ref
from repro_torch.models import get_api, paged
from repro_torch.models.config import ModelConfig
from repro_torch.rollout import PagedDecodeEngine
from test_torch_engine import COUNTERS, ENGINE, _workload

# tiny shapes: one torch thread, so the suite's parallel workers keep their
# cores (torch's pool would otherwise spin on all of them)
torch.set_num_threads(1)

QMAX = {"int8": 127, "fp8": 448}


def _outlier_tree(np_params):
    """The tree with one column's absmax planted in layer 1 of
    ``blocks.attn.wq`` (column 5, negative) and of ``blocks.mlp.wo``
    (column 2, positive): after the shared per-column scaling those
    elements land exactly on -qmax / +qmax."""
    tree = jax.tree_util.tree_map(np.array, np_params)
    tree["blocks"]["attn"]["wq"][1, 3, 5] = -4.0
    tree["blocks"]["mlp"]["wo"][1, 7, 2] = 3.0
    return tree


@pytest.fixture(scope="module")
def models():
    cfg = tiny("qwen3-4b", dtype="float32", vocab_size=32)
    japi = jget_api(cfg)
    np_params = [_outlier_tree(jax.tree_util.tree_map(
        np.asarray, japi.init(jax.random.PRNGKey(i)))) for i in (0, 1)]
    jparams = [jax.tree_util.tree_map(jnp.asarray, p) for p in np_params]
    tapi = get_api(ModelConfig(**dataclasses.asdict(cfg)), device="cpu")
    tparams = [params_from_jax(p, "cpu") for p in np_params]
    return cfg, (japi, jparams), (tapi, tparams)


def _code_bits(codes):
    """Codes as raw bytes: int8 as it is, fp8 as its bit pattern."""
    if isinstance(codes, torch.Tensor):
        return codes.view(torch.int8).numpy()
    return np.asarray(codes).view(np.int8)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


# ------------------------------------------------------------- primitives

@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantize_params_matches_the_jax_package_bit_for_bit(models, mode):
    cfg, (_, jparams), (_, tparams) = models
    jq = jquant.quantize_params(jparams[0], mode)
    tq = quant.quantize_params(tparams[0], mode)
    assert quant.is_quantized_tree(tq) and jquant.is_quantized_tree(jq)
    jdeq = jquant.dequantize_params(jq)
    tdeq = quant.dequantize_params(tq)

    # top-level leaves (embed, final_norm, lm_head): the skip set
    for key in ("embed", "lm_head"):
        assert not isinstance(tq[key], quant.QuantLeaf)
        assert tq[key] is tparams[0][key]
    quantized = {"j": set(), "t": set()}
    for path, jleaf in _leaves(jq["blocks"]):
        if isinstance(jleaf, jquant.QuantLeaf):
            quantized["j"].add(path)
        for layer in range(cfg.num_layers):
            tleaf = tq["blocks"][layer]
            for k in path:
                tleaf = tleaf[k]
            if not isinstance(tleaf, quant.QuantLeaf):
                continue
            quantized["t"].add(path)
            assert np.array_equal(_code_bits(jleaf.codes)[layer],
                                  _code_bits(tleaf.codes)), (path, layer)
            # one scale per column, shared by every layer: (L=1, 1, d_out)
            assert np.asarray(jleaf.scale).shape[0] == 1
            assert np.array_equal(np.asarray(jleaf.scale)[0],
                                  tleaf.scale.numpy()), (path, layer)
            assert tleaf.dtype == torch.float32
            jw = jdeq["blocks"]
            tw = tdeq["blocks"][layer]
            for k in path:
                jw, tw = jw[k], tw[k]
            assert np.array_equal(np.asarray(jw)[layer], tw.numpy())
    assert quantized["t"] == quantized["j"] == {
        ("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
        ("mlp", "wi_gate"), ("mlp", "wi_up"), ("mlp", "wo")}

    # the planted absmax elements land on the grid's ends
    wq = tq["blocks"][1]["attn"]["wq"]
    wo = tq["blocks"][1]["mlp"]["wo"]
    assert float(wq.codes[3, 5].float()) == -QMAX[mode]
    assert float(wo.codes[7, 2].float()) == QMAX[mode]
    # and set the shared scale of their column in the other layer too
    assert torch.equal(tq["blocks"][0]["attn"]["wq"].scale, wq.scale)
    assert float(wq.scale[0, 5]) == np.float32(4.0) / np.float32(QMAX[mode])


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_bf16_weights_dequantize_to_the_jax_packages_bits(mode):
    """bf16 leaves: one fp32 product, rounded once to bf16, on both sides."""
    rng = np.random.default_rng(7)
    w = (rng.normal(size=(3, 48, 40)) * 0.05).astype(np.float32)
    jl = jquant.quantize_array(jnp.asarray(w, jnp.bfloat16), mode)
    tw = torch.from_numpy(w).to(torch.bfloat16)
    tl = quant.quantize_array(tw, mode)
    assert tl.dtype == torch.bfloat16
    assert np.array_equal(_code_bits(jl.codes), _code_bits(tl.codes))
    assert np.array_equal(np.asarray(jl.scale), tl.scale.numpy())
    jw = np.asarray(jquant.dequantize_array(jl)).view(np.int16)
    got = quant.dequantize_array(tl)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(jw, got.view(torch.int16).numpy())


def test_quantize_off_and_unknown_modes(models):
    _, _, (_, tparams) = models
    assert quant.quantize_params(tparams[0], "off") is tparams[0]
    assert not quant.is_quantized_tree(tparams[0])
    with pytest.raises(ValueError):
        quant.quantize_params(tparams[0], "int4")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_matches_the_jax_package(dtype):
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(6, 5, 2, 16)) * 3).astype(np.float32)
    x[0, 0, 0] = 0.0                              # the zero-row guard
    x[1, 2, 1, :4] = [127.0, -63.5, 0.5, 1.5]     # ties on the int8 grid
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jc, js = jpaged.quantize_kv(jx)
    tc, ts = paged.quantize_kv(tx)
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(np.asarray(jc), tc.numpy())
    assert np.array_equal(np.asarray(js), ts.numpy())


def test_int8_forwards_match_from_one_jax_pool(models):
    """Prefill on the JAX side, carry its int8 pool across, then decode on
    both: same logits, same codes and scales written."""
    cfg, (japi, jparams), (tapi, tparams) = models
    page_size, chunk = 8, 8
    rows = np.asarray([[3, 7, 1, 5], [2, 8, 6, 4], [-1, -1, -1, -1]], np.int32)
    jcache = japi.init_paged_cache(9, page_size, kv_quant="int8")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32) for n in (11, 5)]
    first = []
    for r, prompt in enumerate(prompts):
        for start in range(0, len(prompt), chunk):
            piece = prompt[start:start + chunk]
            toks = np.zeros((1, chunk), np.int32)
            toks[0, :len(piece)] = piece
            valid = np.zeros((1, chunk), bool)
            valid[0, :len(piece)] = True
            jl, jcache = japi.prefill_chunk(jparams[0], jnp.asarray(toks),
                                            jnp.asarray(valid), jnp.int32(start),
                                            jnp.asarray(rows[r]), jcache)
        first.append(int(np.argmax(np.asarray(jl))))
    tcache = cache_from_jax(jax.tree_util.tree_map(np.asarray, jcache), "cpu")
    assert tcache.k_pages.dtype == torch.int8 and tcache.k_scales is not None
    token = np.asarray(first + [0], np.int32)
    pos = np.asarray([len(p) for p in prompts] + [0], np.int32)
    for _ in range(3):
        jl, jcache = japi.decode_paged(jparams[0], jnp.asarray(token),
                                       jnp.asarray(pos), jcache,
                                       jnp.asarray(rows), attn_impl="ref")
        tl, tcache = tapi.decode_paged(tparams[0], torch.from_numpy(token),
                                       torch.from_numpy(pos), tcache,
                                       torch.from_numpy(rows), attn_impl="kernel")
        # row 2 is a masked slot: it reads only the garbage page
        np.testing.assert_allclose(np.asarray(jl)[:2], tl.numpy()[:2],
                                   rtol=1e-5, atol=1e-5)
        token = np.asarray(np.argmax(np.asarray(jl), axis=-1), np.int32)
        pos = pos + 1
    # the decode steps' K/V come from fp32 matmuls summed in another order:
    # the codes written agree exactly here, the scales (absmax / 127) to an
    # ulp or two
    for j, t in zip(jcache[:2], tcache[:2]):
        assert np.array_equal(np.asarray(j)[:, 1:], t.numpy()[:, 1:])
    for j, t in zip(jcache[2:], tcache[2:]):
        np.testing.assert_allclose(np.asarray(j)[:, 1:], t.numpy()[:, 1:],
                                   rtol=1e-6, atol=0)
    k, v, valid = tapi.cache_view(tcache.layer_pages(1), torch.from_numpy(rows[0]))
    jk, jv, jvalid = jpaged.gather_request_view(
        tuple(x[1] for x in jcache), jnp.asarray(rows[0]))
    assert k.dtype == torch.float32 and valid.tolist() == np.asarray(jvalid).tolist()
    np.testing.assert_allclose(np.asarray(jk), k.numpy(), rtol=1e-6, atol=0)
    np.testing.assert_allclose(np.asarray(jv), v.numpy(), rtol=1e-6, atol=0)


# ------------------------------------------------------------ the engine

def _drain(eng, out):
    for _ in range(500):
        for rid, toks, _ in eng.step():
            out[rid] = toks.tolist()
        eng.audit_pages()
        if not eng.slots:
            return out
    raise AssertionError("engine did not drain")


SMALL = dict(num_slots=4, max_total_len=64, page_size=8, prefill_chunk=8,
             temperature=0.0)
PROMPT = (np.arange(1, 19) % 13 + 3).astype(np.int32)


@pytest.mark.parametrize("kw", [{"kv_quant": "int8"},
                                {"quant_mode": "int8", "kv_quant": "int8"}],
                         ids=["kv_int8", "w_int8_kv_int8"])
def test_quantized_workload_matches_the_jax_engine(models, kw):
    """The scripted workload (prompt mix, a COW group of 4, a shared
    preamble under the prefix cache, abort -> resume, a weight sync that
    flushes the cache and requantizes) through both engines."""
    _, (japi, jparams), (tapi, tparams) = models
    jeng = JaxEngine(japi, jparams[0], **ENGINE, **kw)
    teng = PagedDecodeEngine(tapi, tparams[0], device="cpu", **ENGINE, **kw)
    jfin, jpart = _workload(jeng, jparams[1])
    tfin, tpart = _workload(teng, tparams[1])
    assert tpart == jpart and tpart[1][1] is True
    assert sorted(tfin) == sorted(jfin) == [0, 2, 3, 10, 11, 12, 13, 21]
    for rid in jfin:
        assert tfin[rid][0] == jfin[rid][0], f"request {rid} diverged"
        np.testing.assert_allclose(tfin[rid][1], jfin[rid][1], rtol=1e-5, atol=1e-5)
    for name in COUNTERS + ("total_weight_syncs_quantized",):
        assert getattr(teng, name) == getattr(jeng, name), name
    assert teng.cache_hit_tokens > 0 and teng.total_groups_forked == 1
    assert teng.cache.k_pages.dtype == torch.int8
    assert teng.total_weight_syncs_quantized == (1 if "quant_mode" in kw else 0)


def test_abort_resume_under_int8_kv_is_byte_identical(models):
    """Every KV position is quantized once, at write: a retained request
    resumes to exactly the tokens of an uninterrupted run, and of the JAX
    engine's uninterrupted run."""
    _, (japi, jparams), (tapi, tparams) = models
    kw = dict(SMALL, prefix_cache=True, quant_mode="int8", kv_quant="int8")
    jeng = JaxEngine(japi, jparams[0], **kw)
    jeng.add_request(1, PROMPT, 12)
    want = _drain(jeng, {})[1]

    plain = PagedDecodeEngine(tapi, tparams[0], device="cpu", **kw)
    plain.add_request(1, PROMPT, 12)
    assert _drain(plain, {})[1] == want

    eng = PagedDecodeEngine(tapi, tparams[0], device="cpu", **kw)
    eng.add_request(1, PROMPT, 12)
    for _ in range(8):
        eng.step()
    r = eng.abort(1, retain=True)
    assert r.resumable
    eng.audit_pages()
    pre = r.tokens.tolist()
    eng.resume_request(1, 2, 12 - len(pre))
    assert pre + _drain(eng, {})[2] == want


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quant_mode_engine_matches_fake_quantized_params(models, mode):
    """The engine's per-layer dequantization == the off engine on a tree
    quantized and dequantized up front; both == the JAX engine in that
    mode."""
    _, (japi, jparams), (tapi, tparams) = models
    e_q = PagedDecodeEngine(tapi, tparams[0], device="cpu", quant_mode=mode, **SMALL)
    fake = quant.dequantize_params(quant.quantize_params(tparams[0], mode))
    e_f = PagedDecodeEngine(tapi, fake, device="cpu", **SMALL)
    jeng = JaxEngine(japi, jparams[0], quant_mode=mode, **SMALL)
    for e in (e_q, e_f, jeng):
        e.add_request(1, PROMPT, 10)
    a, b = _drain(e_q, {}), _drain(e_f, {})
    assert a == b == _drain(jeng, {})
    assert quant.is_quantized_tree(e_q.params) and not quant.is_quantized_tree(e_f.params)


def test_int8_pages_move_between_engines_with_their_scales(models):
    _, (japi, jparams), (tapi, tparams) = models
    kw = dict(SMALL, prefix_cache=True, kv_quant="int8")
    src = PagedDecodeEngine(tapi, tparams[0], device="cpu", **kw)
    dst = PagedDecodeEngine(tapi, tparams[0], device="cpu", **kw)
    jsrc = JaxEngine(japi, jparams[0], **kw)
    for e in (src, jsrc):
        e.add_request(0, PROMPT, 10)
        for _ in range(5):
            e.step()
        e.abort(0, retain=True)
    rec, jrec = src.export_retained(0), jsrc.export_retained(0)
    t, jt = rec["transfer"], jrec["transfer"]
    assert t.k.dtype == torch.int8 and t.k_scales.dtype == torch.float32
    assert t.nbytes == jt.nbytes == (t.k.numel() + t.v.numel()
                                     + 4 * (t.k_scales.numel() + t.v_scales.numel()))
    # same codes; scales to an ulp or two (see the forwards test)
    for a, b in zip(t[:2], jt[:2]):
        assert np.array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(t[2:], jt[2:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)
    assert dst.import_retained(0, rec)
    pages = dst.retained[0].pages
    for pool, moved in zip(dst.cache, t):
        assert torch.equal(pool[:, pages], moved)
    dst.resume_request(0, 5, 4)
    src.resume_request(0, 5, 4)
    assert _drain(dst, {}) == _drain(src, {})
    # a pool of the other mode refuses the buffer
    plain = tapi.init_paged_cache(src.num_pages, SMALL["page_size"])
    with pytest.raises(ValueError, match="kv_quant mismatch"):
        paged.import_pages(plain, pages, t)
    off = PagedDecodeEngine(tapi, tparams[0], device="cpu", **SMALL)
    assert not off.import_retained(0, rec)


def test_update_weights_requantizes_and_mode_changes_at_the_next_sync(models):
    _, (japi, jparams), (tapi, tparams) = models
    for eng, params in ((JaxEngine(japi, jparams[0], quant_mode="int8", **SMALL),
                         jparams[1]),
                        (PagedDecodeEngine(tapi, tparams[0], device="cpu",
                                           quant_mode="int8", **SMALL), tparams[1])):
        is_q = (jquant.is_quantized_tree if isinstance(eng, JaxEngine)
                else quant.is_quantized_tree)
        assert is_q(eng.params) and eng.total_weight_syncs_quantized == 0
        eng.update_weights(params)
        assert is_q(eng.params) and eng.total_weight_syncs_quantized == 1
        eng.set_quant_mode("off")
        assert is_q(eng.params)            # unchanged until the next sync
        eng.update_weights(params)
        assert not is_q(eng.params) and eng.total_weight_syncs_quantized == 1
        eng.set_quant_mode("fp8")
        eng.update_weights(params)
        assert is_q(eng.params) and eng.total_weight_syncs_quantized == 2
        with pytest.raises(ValueError):
            eng.set_quant_mode("int4")
    fp8 = eng.params["blocks"][0]["attn"]["wq"]
    assert fp8.codes.dtype == torch.float8_e4m3fn


# ------------------------------------------------------------ the kernel

def _int8_inputs(seed, b, h, kv, d, page_size, pages_per_seq):
    """q and an int8 pool made by ``quantize_kv`` from seeded normals, with
    ragged -1 tails, a fully masked row 0 and a length-0 row 1."""
    rng = np.random.default_rng(seed)
    n = 1 + b * pages_per_seq
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    kf = rng.normal(size=(n, page_size, kv, d)).astype(np.float32)
    vf = rng.normal(size=(n, page_size, kv, d)).astype(np.float32)
    bt = np.full((b, pages_per_seq), -1, np.int32)
    perm = rng.permutation(np.arange(1, n)).astype(np.int32)
    lengths, i = [], 0
    for bi in range(b):
        used = int(rng.integers(1, pages_per_seq + 1))
        bt[bi, :used] = perm[i:i + used]
        i += used
        lengths.append(int(rng.integers(1, used * page_size + 1)))
    lengths = np.asarray(lengths, np.int32)
    bt[0] = -1
    lengths[1] = 0
    (kc, ks), (vc, vs) = (paged.quantize_kv(torch.from_numpy(x)) for x in (kf, vf))
    return (q, kc.numpy(), vc.numpy(), bt, lengths, ks.numpy(), vs.numpy())


@pytest.mark.parametrize("softcap", [None, 30.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_wrapper_matches_the_jax_kernel(softcap, dtype):
    q, kc, vc, bt, lengths, ks, vs = _int8_inputs(5, 3, 8, 2, 32, 16, 3)
    jdt, tdt, tol = ((jnp.float32, torch.float32, 2e-5) if dtype == "float32"
                     else (jnp.bfloat16, torch.bfloat16, 2e-2))
    got = pda.paged_decode_attention(
        torch.from_numpy(q).to(tdt), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(bt), torch.from_numpy(lengths),
        k_scales=torch.from_numpy(ks), v_scales=torch.from_numpy(vs),
        softcap=softcap)
    assert got.dtype == tdt
    want = jax_paged_decode_attention(
        jnp.asarray(q, jdt), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(bt),
        jnp.asarray(lengths), k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs),
        softcap=softcap, interpret=True)
    np.testing.assert_allclose(np.asarray(want, np.float32), got.float().numpy(),
                               rtol=tol, atol=tol)


def _meta_pool(n=5, page_size=16, kv=2, d=64):
    return torch.zeros(n, page_size, kv, d, dtype=torch.int8)


@pytest.mark.parametrize("scales,exc", [
    ("both", None),
    ("none", TypeError),                   # int8 pool without scales
    ("k_only", ValueError),                # one of the two
    ("bad_shape", ValueError),
    ("bad_dtype", ValueError),
    ("fp_pool", TypeError),                # scales with a bf16 pool
])
def test_kernel_checks_take_int8_pools_only_with_both_scales(scales, exc):
    q = torch.zeros(2, 8, 64, dtype=torch.bfloat16)
    kp = _meta_pool()
    good = torch.zeros(kp.shape[:3], dtype=torch.float32)
    ks, vs = {"both": (good, good.clone()), "none": (None, None),
              "k_only": (good, None),
              "bad_shape": (good, torch.zeros(5, 16, 3)),
              "bad_dtype": (good, good.half()),
              "fp_pool": (good, good.clone())}[scales]
    if scales == "fp_pool":
        kp = kp.to(torch.bfloat16)
    bt = torch.zeros(2, 2, dtype=torch.int32)
    lengths = torch.ones(2, dtype=torch.int32)
    if exc is None:
        pda._check(q, kp, kp.clone(), bt, lengths, ks, vs)
    else:
        with pytest.raises(exc):
            pda._check(q, kp, kp.clone(), bt, lengths, ks, vs)


def test_int8_scales_are_read_as_layer_views_in_place():
    """The wrapper takes the per-layer scale view of an (L, N, page, KV)
    pool as it is (strides), and refuses misaligned int8 rows."""
    cache = paged.PagedKVCache(*(torch.zeros(s, dtype=dt) for s, dt in (
        ((3, 5, 16, 2, 64), torch.int8), ((3, 5, 16, 2, 64), torch.int8),
        ((3, 5, 16, 2), torch.float32), ((3, 5, 16, 2), torch.float32))))
    kp, vp, ks, vs = cache.layer_pages(1)
    q = torch.zeros(2, 8, 64)
    bt = torch.zeros(2, 2, dtype=torch.int32)
    pda._check(q, kp, vp, bt, torch.ones(2, dtype=torch.int32), ks, vs)
    odd = torch.zeros(5, 16, 2, 72, dtype=torch.int8)[..., :64]   # 72-byte rows
    with pytest.raises(ValueError, match="16-byte"):
        pda._check(q, odd, odd, bt, torch.ones(2, dtype=torch.int32), ks, vs)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kv,d,page_size,pages_per_seq", [
    (16, 32, 8, 128, 16, 64),   # the serving slice's shape
    (3, 12, 3, 64, 8, 5),       # odd
    (2, 8, 1, 128, 16, 6),      # MQA
    (4, 8, 2, 32, 16, 3),       # head_dim 32
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_int8_kernel_matches_plain_version(cuda_device, b, h, kv, d,
                                                page_size, pages_per_seq, dtype):
    q, kc, vc, bt, lengths, ks, vs = (
        torch.from_numpy(x).to(cuda_device)
        for x in _int8_inputs(6, b, h, kv, d, page_size, pages_per_seq))
    q = q.to(getattr(torch, dtype))
    before = (pda.paged_decode_attention.launches,
              pda.paged_decode_attention.launches_int8)
    got = pda.paged_decode_attention(q, kc, vc, bt, lengths, k_scales=ks,
                                     v_scales=vs, softcap=30.0)
    torch.cuda.synchronize()
    assert (pda.paged_decode_attention.launches,
            pda.paged_decode_attention.launches_int8) == (before[0] + 1, before[1] + 1)
    want = ref.paged_decode_attention_ref(q, kc, vc, bt, lengths, k_scales=ks,
                                          v_scales=vs, softcap=30.0)
    tol = 2e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
