"""The split decode kernels' algorithm on the CPU: the host-side plans of
``kernels/decode_attention.py`` and ``kernels/paged_decode_attention.py``
(splits and chunk from static shapes), and a plain-torch model of what the
CUDA kernels compute -- an fp32 partial (m, l, acc) per chunk of each
(row, KV head)'s key axis, then the combine -- held to the JAX package's
Pallas kernels in interpret mode at the edges the kernels must keep: empty
splits, rows with no valid key, lengths above S, windows across a chunk
boundary, -1 entries in and after the live range, a softcap and int8
pools.  Tolerance 1e-5 in fp32: the splits change only the order of fp32
sums.  The kernels themselves meet the same cases on the card
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
                    assert mma == (pool_dtype == torch.bfloat16
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
    assert pda.plan(64, 16, 128, 132, 4, torch.bfloat16, torch.int8, 128) == (8, 8, 2, False)


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


def paged_split_model(q, k_pages, v_pages, tables, lengths, splits, chunk, *,
                      k_scales=None, v_scales=None, softcap=None):
    """The paged kernel's algorithm: a row with a live key (an assigned
    entry below its length) walks entries j < ceil(min(len, P * page) /
    page), its -1 entries weighted 0; a row without one averages V over all
    P entries (-1 reading page 0) with score 0."""
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
                keys, vals, weighted = [], [], []
                for j in range(sp * chunk, min((sp + 1) * chunk, nlive)):
                    phys = max(row[j], 0)
                    for u in range(page):
                        if j * page + u >= len_eff:
                            break
                        kr, vr = k_pages[phys, u, kh].float(), v_pages[phys, u, kh].float()
                        if k_scales is not None:
                            kr, vr = kr * k_scales[phys, u, kh], vr * v_scales[phys, u, kh]
                        keys.append(kr)
                        vals.append(vr)
                        weighted.append(uniform or row[j] >= 0)
                keys = torch.stack(keys) if keys else torch.zeros(0, d)
                vals = torch.stack(vals) if vals else torch.zeros(0, d)
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


def _paged_case(seed, int8):
    """P = 24 entries of page 8, split by the plan (several chunks): row 0
    all -1 with a length; row 1 length 0 with every entry assigned; row 2 a
    -1 entry inside its live range and -1 tails; row 3 live in chunks 0 and
    2 with chunk 1 all -1 (an empty split between live ones); row 4 a
    length above P * page; row 5 one key."""
    rng = np.random.default_rng(seed)
    b, h, kv, d, page, p_seq = 6, 8, 2, 32, 8, 24
    splits, chunk, tp, _ = pda.plan(p_seq, page, b * kv, 132, h // kv, torch.float32,
                                    torch.int8 if int8 else torch.float32, d)
    assert splits >= 3 and tp == 4
    n = 1 + b * p_seq
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    kp = rng.normal(size=(n, page, kv, d)).astype(np.float32)
    vp = rng.normal(size=(n, page, kv, d)).astype(np.float32)
    tables = (rng.permutation(np.arange(1, n))[:b * p_seq].reshape(b, p_seq)).astype(np.int32)
    lengths = np.asarray([20, 0, 70, 2 * chunk * page + 5, 250, 1], np.int32)
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
    return (q, kp, vp, tables, lengths, scales), (splits, chunk)


@pytest.mark.parametrize("softcap,int8", [(None, False), (30.0, False), (None, True),
                                          (30.0, True)])
def test_paged_split_model_matches_the_pallas_kernel(softcap, int8):
    (q, kp, vp, tables, lengths, scales), (splits, chunk) = _paged_case(22, int8)
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
