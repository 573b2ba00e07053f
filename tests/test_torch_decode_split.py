"""The split decode kernels' algorithm on the CPU: the host-side plans of
``kernels/decode_attention.py`` and ``kernels/paged_decode_attention.py``
(splits and chunk from static shapes), and a plain-torch model of what the
CUDA kernels compute -- an fp32 partial (m, l, acc) per chunk of each
(row, KV head)'s key axis, then the combine -- held to the JAX package's
Pallas kernels in interpret mode at the edges the kernels must keep: empty
splits, rows with no valid key, lengths above S, windows across a chunk
boundary, -1 entries in and after the live range, a softcap and int8
pools.  Tolerance 1e-5 in fp32: the splits change only the order of fp32
sums.  The int8 pool's tensor-core route (bf16 q) is modelled step by step,
and its fragment layouts lane by lane (``tools/paged_int8_model.py``).  The kernels themselves meet the same cases on the card
(``tests/test_torch_kernels.py``, ``cuda``-marked, and ``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as jax_decode_attention
from repro.kernels.paged_decode_attention import (
    paged_decode_attention as jax_paged_decode_attention)
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import paged_decode_attention as pda

torch.set_num_threads(1)

TOL = 1e-5
NEG = -1e30


# ---------------------------------------------------------------------------
# the plans: every key (table entry) of a row in exactly one split
# ---------------------------------------------------------------------------

def _covered_once(n, splits, chunk):
    counts = np.zeros(n, np.int64)
    for sp in range(splits):
        counts[sp * chunk:min((sp + 1) * chunk, n)] += 1
    return bool((counts == 1).all()) and (splits - 1) * chunk < n <= splits * chunk


@pytest.mark.parametrize("seq_len", [1, 31, 32, 33, 300, 1024, 4096])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_plan_covers_each_key_once(seq_len, dtype):
    for rows in (1, 3, 16, 128, 512):
        for group, head_dim in ((1, 64), (4, 128), (16, 256), (32, 120)):
            for sms in (1, 132):
                splits, chunk, mma = da.plan(seq_len, rows, sms, group, dtype, head_dim)
                assert 1 <= splits <= da.MAX_SPLITS and chunk % da.TILE == 0
                assert _covered_once(seq_len, splits, chunk), (rows, group, sms)
                assert mma == (dtype == torch.bfloat16 and group <= 16)


@pytest.mark.parametrize("pages_per_seq", [1, 5, 64, 257])
@pytest.mark.parametrize("page_size", [1, 8, 12, 16, 32, 64])
def test_paged_plan_covers_each_entry_once(pages_per_seq, page_size):
    for rows in (1, 16, 128):
        for group in (1, 4, 16):
            for q_dtype, pool_dtype in ((torch.float32, torch.float32),
                                        (torch.bfloat16, torch.bfloat16),
                                        (torch.bfloat16, torch.int8)):
                for sms in (1, 132):
                    splits, chunk, tp, mma = pda.plan(pages_per_seq, page_size, rows, sms,
                                                      group, q_dtype, pool_dtype, 128)
                    assert 1 <= splits <= da.MAX_SPLITS and chunk % tp == 0
                    assert tp == max(1, da.TILE // page_size)
                    assert _covered_once(pages_per_seq, splits, chunk)
                    # the tensor cores: bf16 q with a bf16 or an int8 pool
                    assert mma == (q_dtype == torch.bfloat16
                                   and tp * page_size == da.TILE and group <= 16)


def test_plans_at_the_slice_shapes():
    """On 132 SMs: Qwen3-4B's rows (B=16 x KV=8) split into 5 chunks of 224
    keys on the tensor cores and 8 of 128 on the CUDA cores (fp32), near
    the grid targets of 4 and 8 blocks per SM; RecurrentGemma-9B's (B=16 x
    KV=1, G=16, D=256) into chunks that keep a split's fp32 partial at
    most an eighth of the K/V bytes it reads; the paged pool in 2-page
    tiles."""
    assert da.plan(1024, 128, 132, 4, torch.bfloat16, 128) == (5, 224, True)
    assert da.plan(1024, 128, 132, 4, torch.float32, 128) == (8, 128, False)
    for dtype, want in ((torch.bfloat16, (8, 128, True)), (torch.float32, (16, 64, False))):
        splits, chunk, mma = da.plan(1024, 16, 132, 16, dtype, 256)
        assert (splits, chunk, mma) == want
        assert 8 * 4 * 16 * 256 <= chunk * 2 * 256 * dtype.itemsize
    assert pda.plan(64, 16, 128, 132, 4, torch.bfloat16, torch.bfloat16, 128) == (5, 14, 2, True)
    # an int8 pool with bf16 q on the tensor cores aims at 6 blocks per SM
    # (7 splits of 10 entries); with fp32 q on the CUDA cores at 8
    assert pda.plan(64, 16, 128, 132, 4, torch.bfloat16, torch.int8, 128) == (7, 10, 2, True)
    assert pda.plan(64, 16, 128, 132, 4, torch.float32, torch.int8, 128) == (8, 8, 2, False)
    # DBRX-132B (48 heads over 8: G=6, rows 16 x 8) and Qwen3-MoE-235B-A22B
    # (64 over 4: G=16, rows 16 x 4): on the tensor cores an int8 split's
    # least length is a bf16 split's, ceil(16 G / 64) tiles
    assert pda.plan(64, 16, 128, 132, 6, torch.bfloat16, torch.int8, 128) == (7, 10, 2, True)
    assert pda.plan(64, 16, 128, 132, 6, torch.bfloat16, torch.bfloat16, 128) == (5, 14, 2, True)
    assert pda.plan(64, 16, 64, 132, 16, torch.bfloat16, torch.int8, 128) == (8, 8, 2, True)
    assert pda.plan(64, 16, 64, 132, 16, torch.bfloat16, torch.bfloat16, 128) == (8, 8, 2, True)


# ---------------------------------------------------------------------------
# a plain-torch model of the split kernels: partials per chunk, combine
# ---------------------------------------------------------------------------

def _partial(scores, vals, weighted):
    """(m, l, acc) of one split: scores (G, T) fp32, vals (T, D); only the
    keys where ``weighted`` is true count; none -> the empty partial."""
    g = scores.shape[0]
    if not bool(weighted.any()):
        return (torch.full((g,), NEG), torch.zeros(g), torch.zeros(g, vals.shape[1]))
    s = torch.where(weighted[None, :], scores, torch.tensor(NEG))
    m = s.max(-1).values
    p = torch.where(weighted[None, :], torch.exp(s - m[:, None]), torch.tensor(0.0))
    return m, p.sum(-1), p @ vals


def _combine(parts):
    """m* = max m_s, w_s = e^(m_s - m*) (0 for an empty split), out =
    sum w_s acc_s / max(sum w_s l_s, 1e-30)."""
    m = torch.stack([p[0] for p in parts])
    l = torch.stack([p[1] for p in parts])
    acc = torch.stack([p[2] for p in parts])
    w = torch.where(l > 0, torch.exp(m - m.max(0).values), torch.tensor(0.0))
    return (w[..., None] * acc).sum(0) / torch.clamp((w * l).sum(0), min=1e-30)[:, None]


def dense_split_model(q, k, v, lengths, window, splits, chunk):
    """The dense kernel's algorithm: the live keys [max(0, len - window),
    min(len, S)) (none: all S with score 0) cut into the plan's chunks."""
    b, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    g = h // kv
    out = torch.zeros(b, h, d)
    for bi in range(b):
        length = int(lengths[bi])
        lo = max(0, length - window) if window is not None else 0
        hi = min(length, s)
        uniform = lo >= hi
        if uniform:
            lo, hi = 0, s
        for kh in range(kv):
            qg = q[bi, kh * g:(kh + 1) * g].float() * d ** -0.5
            parts = []
            for sp in range(splits):
                t0, t1 = max(lo, sp * chunk), min(hi, (sp + 1) * chunk)
                keys = k[bi, max(t0, 0):max(t1, t0), kh].float()
                vals = v[bi, max(t0, 0):max(t1, t0), kh].float()
                scores = torch.zeros(g, keys.shape[0]) if uniform else qg @ keys.T
                parts.append(_partial(scores, vals, torch.ones(keys.shape[0], dtype=torch.bool)))
            out[bi, kh * g:(kh + 1) * g] = _combine(parts)
    return out


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _partial_int8_mma(qg, k_codes, k_scale, v_codes, v_scale, weighted, uniform, softcap,
                      d):
    """(m, l, acc) of one split on the int8 pool's tensor-core route, tile
    by tile (32 keys from the split's first entry): S = q C_k^T (q bf16 and
    the codes exact, fp32 sums), column t times s_k[t] d^-0.5 in fp32, the
    softcap, the mask; the online softmax in fp32; P' = P s_v in fp32, split
    into bf16 hi + lo terms; acc += hi C_v + lo C_v in fp32.  A uniform
    row's S is 0."""
    g = qg.shape[0]
    m, l, acc = torch.full((g,), NEG), torch.zeros(g), torch.zeros(g, v_codes.shape[1])
    for t0 in range(0, len(weighted), da.TILE):
        t = slice(t0, t0 + da.TILE)
        live = weighted[t]
        s = (torch.zeros(g, live.shape[0]) if uniform
             else (qg @ k_codes[t].T) * (k_scale[t] * d ** -0.5))
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        s = torch.where(live[None, :], s, torch.tensor(NEG))
        m_new = torch.maximum(m, s.max(-1).values)
        alpha = torch.exp(m - m_new)
        p = torch.where(live[None, :], torch.exp(s - m_new[:, None]), torch.tensor(0.0))
        l = l * alpha + p.sum(-1)
        pv = p * v_scale[t]
        hi = _bf16(pv)
        lo = _bf16(pv - hi)
        acc = acc * alpha[:, None] + hi @ v_codes[t] + lo @ v_codes[t]
        m = m_new
    return m, l, acc


def paged_split_model(q, k_pages, v_pages, tables, lengths, splits, chunk, *,
                      k_scales=None, v_scales=None, softcap=None, mma=False):
    """The paged kernel's algorithm: a row with a live key (an assigned
    entry below its length) walks entries j < ceil(min(len, P * page) /
    page), its -1 entries weighted 0; a row without one averages V over all
    P entries (-1 reading page 0) with score 0.  ``mma``: an int8 pool on
    the tensor cores (``_partial_int8_mma``), q bf16; else fp32 throughout,
    the codes dequantized first."""
    b, h, d = q.shape
    page, kv = k_pages.shape[1], k_pages.shape[2]
    p_seq = tables.shape[1]
    g = h // kv
    out = torch.zeros(b, h, d)
    for bi in range(b):
        length, row = int(lengths[bi]), tables[bi].tolist()
        uniform = not any(e >= 0 and j * page < length for j, e in enumerate(row))
        len_eff = p_seq * page if uniform else min(length, p_seq * page)
        nlive = -(-len_eff // page)
        for kh in range(kv):
            qg = q[bi, kh * g:(kh + 1) * g].float() * d ** -0.5
            parts = []
            for sp in range(splits):
                keys, vals, weighted, ks, vs = [], [], [], [], []
                for j in range(sp * chunk, min((sp + 1) * chunk, nlive)):
                    phys = max(row[j], 0)
                    for u in range(page):
                        if j * page + u >= len_eff:
                            break
                        kr, vr = k_pages[phys, u, kh].float(), v_pages[phys, u, kh].float()
                        if k_scales is not None:
                            ks.append(k_scales[phys, u, kh])
                            vs.append(v_scales[phys, u, kh])
                            if not mma:
                                kr, vr = kr * ks[-1], vr * vs[-1]
                        keys.append(kr)
                        vals.append(vr)
                        weighted.append(uniform or row[j] >= 0)
                keys = torch.stack(keys) if keys else torch.zeros(0, d)
                vals = torch.stack(vals) if vals else torch.zeros(0, d)
                if mma:
                    ks, vs = (torch.stack(x) if x else torch.zeros(0) for x in (ks, vs))
                    parts.append(_partial_int8_mma(
                        q[bi, kh * g:(kh + 1) * g].float(), keys, ks, vals, vs,
                        torch.tensor(weighted, dtype=torch.bool), uniform, softcap, d))
                    continue
                scores = qg @ keys.T
                if softcap is not None:
                    scores = softcap * torch.tanh(scores / softcap)
                if uniform:
                    scores = torch.zeros_like(scores)
                parts.append(_partial(scores, vals, torch.tensor(weighted, dtype=torch.bool)))
            out[bi, kh * g:(kh + 1) * g] = _combine(parts)
    return out


def _close(want, got):
    np.testing.assert_allclose(np.asarray(want, np.float32), got.numpy(), rtol=TOL, atol=TOL)


# dense: S = 128 in 32-key chunks (four splits); rows with no valid key
# (length 0; a window past S), one key (three empty splits), a length on a
# chunk boundary, lengths above S, windows across chunk boundaries
DENSE_CASES = {
    "no_window": (None, [0, 1, 32, 33, 128, 150]),
    "window": (40, [40, 70, 96, 129, 210, 0]),
}


@pytest.mark.parametrize("case", sorted(DENSE_CASES))
def test_dense_split_model_matches_the_pallas_kernel(case):
    window, lengths = DENSE_CASES[case]
    rng = np.random.default_rng(21)
    b, h, kv, s, d = len(lengths), 8, 2, 128, 32
    q, k, v = (rng.normal(size=shape).astype(np.float32)
               for shape in ((b, h, d), (b, s, kv, d), (b, s, kv, d)))
    lengths = np.asarray(lengths, np.int32)
    splits, chunk, _ = da.plan(s, b * kv, 132, h // kv, torch.float32, d)
    assert (splits, chunk) == (4, 32)
    got = dense_split_model(*(torch.from_numpy(x) for x in (q, k, v, lengths)), window,
                            splits, chunk)
    want = jax_decode_attention(*(jnp.asarray(x) for x in (q, k, v, lengths)), window=window,
                                block_k=32, interpret=True)
    _close(want, got)
    # the wrapper's plain version (the CPU path) agrees too
    _close(da.decode_attention(*(torch.from_numpy(x) for x in (q, k, v, lengths)),
                               window=window), got)


def _paged_case(seed, int8, h=8, kv=2, d=32, page=8, p_seq=24, q_dtype=torch.float32):
    """P = 24 entries of page 8 by default, split by the plan (several
    chunks): row 0 all -1 with a length; row 1 length 0 with every entry
    assigned; row 2 a -1 entry inside its live range and -1 tails; row 3
    live in chunks 0 and 2 with chunk 1 all -1 (an empty split between live
    ones); row 4 a length above P * page; row 5 one key (its later splits
    hold no entry).  ``q_dtype`` bf16: q's values rounded to bf16."""
    rng = np.random.default_rng(seed)
    b = 6
    splits, chunk, tp, mma = pda.plan(p_seq, page, b * kv, 132, h // kv, q_dtype,
                                      torch.int8 if int8 else q_dtype, d)
    assert splits >= 3 and tp == da.TILE // page
    n = 1 + b * p_seq
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    if q_dtype == torch.bfloat16:
        q = torch.from_numpy(q).to(torch.bfloat16).float().numpy()
    kp = rng.normal(size=(n, page, kv, d)).astype(np.float32)
    vp = rng.normal(size=(n, page, kv, d)).astype(np.float32)
    tables = (rng.permutation(np.arange(1, n))[:b * p_seq].reshape(b, p_seq)).astype(np.int32)
    lengths = np.asarray([20, 0, 70, 2 * chunk * page + 5, max(250, p_seq * page + 10), 1],
                         np.int32)
    for i, length in enumerate(lengths):
        if i != 1:
            tables[i, max(0, -(-length // page)):] = -1
    tables[0] = -1
    tables[2, 2] = -1
    tables[3, chunk:2 * chunk] = -1
    scales = {}
    if int8:
        kp = rng.integers(-127, 128, kp.shape).astype(np.int8)
        vp = rng.integers(-127, 128, vp.shape).astype(np.int8)
        scales = {"k_scales": (rng.random(kp.shape[:3]) * 0.02).astype(np.float32),
                  "v_scales": (rng.random(vp.shape[:3]) * 0.02).astype(np.float32)}
    return (q, kp, vp, tables, lengths, scales), (splits, chunk, mma)


@pytest.mark.parametrize("softcap,int8", [(None, False), (30.0, False), (None, True),
                                          (30.0, True)])
def test_paged_split_model_matches_the_pallas_kernel(softcap, int8):
    (q, kp, vp, tables, lengths, scales), (splits, chunk, _) = _paged_case(22, int8)
    t_scales = {n: torch.from_numpy(x) for n, x in scales.items()}
    got = paged_split_model(*(torch.from_numpy(x) for x in (q, kp, vp, tables, lengths)),
                            splits, chunk, softcap=softcap, **t_scales)
    want = jax_paged_decode_attention(
        *(jnp.asarray(x) for x in (q, kp, vp, tables, lengths)), softcap=softcap,
        interpret=True, **{n: jnp.asarray(x) for n, x in scales.items()})
    _close(want, got)
    _close(pda.paged_decode_attention(*(torch.from_numpy(x) for x in (q, kp, vp, tables,
                                                                       lengths)),
                                      softcap=softcap, **t_scales), got)


def _paged_f64(q, kp, vp, tables, lengths, k_scales, v_scales, softcap):
    """The reference's formula in float64: the gathered view dequantized,
    logits (q d^-0.5) (c s_k), the softcap, the mask (-1e30), softmax, P
    (c s_v); -1 entries read page 0."""
    b, h, d = q.shape
    page, kv = kp.shape[1], kp.shape[2]
    idx = np.maximum(tables, 0)
    k = (kp[idx].astype(np.float64) * k_scales[idx][..., None]).reshape(b, -1, kv, d)
    v = (vp[idx].astype(np.float64) * v_scales[idx][..., None]).reshape(b, -1, kv, d)
    qf = q.astype(np.float64).reshape(b, kv, h // kv, d) * d ** -0.5
    logits = np.einsum("bkgd,btkd->bkgt", qf, k)
    if softcap is not None:
        logits = softcap * np.tanh(logits / softcap)
    pos = np.arange(k.shape[1])[None, :]
    mask = (pos < lengths[:, None]) & np.repeat(tables >= 0, page, axis=1)
    logits = np.where(mask[:, None, None, :], logits, -1e30)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bkgt,btkd->bkgd", p, v).reshape(b, h, d)


# the int8 pool on the tensor cores (bf16 q): G = 4, 6, 16 (Qwen3-4B's,
# DBRX-132B's, Qwen3-MoE-235B-A22B's groups) at head_dim 64, 120 and 128,
# a softcap of 30 at each G; pages of 16 (two a tile), P long enough for
# three splits of the least length, ceil(16 G / 64) tiles
@pytest.mark.parametrize("g,d,softcap", [(4, 64, None), (4, 120, 30.0), (4, 128, None),
                                         (6, 64, 30.0), (6, 120, None), (6, 128, 30.0),
                                         (16, 64, None), (16, 120, 30.0), (16, 128, None)])
def test_int8_tensor_core_model_matches_the_pallas_kernel(g, d, softcap):
    """The route's arithmetic (``_partial_int8_mma``) against a float64
    evaluation of the reference's formula, within 5e-5 x max |out| (so the
    hi + lo split keeps P' to ~16 bits and the codes lose nothing), and
    against the JAX package's Pallas kernel in interpret mode and the
    wrapper's plain version at the bf16 tolerance, 2e-2."""
    p_seq = 6 * -(-g // 4)
    (q, kp, vp, tables, lengths, scales), (splits, chunk, mma) = _paged_case(
        29, True, h=g, kv=1, d=d, page=16, p_seq=p_seq, q_dtype=torch.bfloat16)
    assert mma and splits == 3
    tq = torch.from_numpy(q).to(torch.bfloat16)
    t = [torch.from_numpy(x) for x in (kp, vp, tables, lengths)]
    t_scales = {n: torch.from_numpy(x) for n, x in scales.items()}
    got = paged_split_model(tq, *t, splits, chunk, softcap=softcap, mma=True, **t_scales)
    exact = _paged_f64(q, kp, vp, tables, lengths, scales["k_scales"], scales["v_scales"],
                       softcap)
    scale = float(np.abs(exact).max())
    np.testing.assert_allclose(got.numpy(), exact, rtol=0, atol=5e-5 * scale)
    want = jax_paged_decode_attention(
        jnp.asarray(q, jnp.bfloat16), *(jnp.asarray(x) for x in (kp, vp, tables, lengths)),
        softcap=softcap, interpret=True, **{n: jnp.asarray(x) for n, x in scales.items()})
    np.testing.assert_allclose(np.asarray(want, np.float32), got.numpy(), rtol=2e-2, atol=2e-2)
    plain = pda.paged_decode_attention(tq, *t, softcap=softcap, **t_scales)
    np.testing.assert_allclose(plain.float().numpy(), got.numpy(), rtol=2e-2, atol=2e-2)


def _fragment_model():
    """``tools/paged_int8_model.py``: the kernel's fragment layouts, lane by
    lane, in numpy."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "tools" / "paged_int8_model.py"
    spec = importlib.util.spec_from_file_location("paged_int8_model", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_int8_codes_widen_to_bf16_exactly():
    """Every pair of int8 codes through the kernel's bit arithmetic
    (two LOP3s and one bf16x2 subtraction) comes out as the codes."""
    _fragment_model().check_widening()


@pytest.mark.parametrize("d", [64, 128, 256])
def test_int8_v_loads_hit_no_bank_twice(d):
    """The V loads of the permuted columns (NT = D / 32 bytes from each of
    four key rows per lane) are free of shared-memory bank conflicts."""
    assert _fragment_model().v_conflicts(d) == 1


@pytest.mark.parametrize("d,head_dim", [(64, 64), (64, 56), (128, 128), (128, 120),
                                        (256, 256)])
def test_int8_fragments_multiply_to_the_exact_products(d, head_dim):
    """The K tile widened to bf16 holds the codes, and the lane model of
    P' C_v (with V's and O's column permutation and the partial's stores)
    gives the float64 product exactly, zeros past head_dim included."""
    _fragment_model().check_products(d, head_dim)


def test_rows_without_a_valid_key_average_v_uniformly():
    """The sentinels across splits: every split of a row with no valid key
    holds m = 0 and its share of the sum, the empty splits of a one-key row
    hold m = -1e30 and l = 0, and the combine gives the uniform average (not
    0, not NaN) and the one key's value respectively."""
    rng = np.random.default_rng(23)
    q = torch.from_numpy(rng.normal(size=(2, 4, 32)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(2, 128, 1, 32)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(2, 128, 1, 32)).astype(np.float32))
    out = dense_split_model(q, k, v, torch.tensor([0, 1]), None, 4, 32)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out[0], v[0, :, 0].mean(0).expand(4, 32), rtol=TOL, atol=TOL)
    torch.testing.assert_close(out[1], v[1, 0, 0].expand(4, 32), rtol=TOL, atol=TOL)
