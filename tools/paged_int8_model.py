#!/usr/bin/env python3
"""A numpy model of the int8 pool's tensor-core route in
``src/repro_torch/csrc/paged_decode_attention.cu``, written before the
kernel was built and kept beside it: it mirrors the kernel's bit and index
arithmetic (``codes_bf16x2``, ``widen_tile``, ``v_column``, ``pv_int8`` and
the stores of O) lane by lane and checks:

* ``codes_bf16x2`` turns the int8 codes in bytes 0 and 2 of a word into a
  bf16x2 register holding them exactly, for every pair of bytes;
* ``widen_tile`` turns an int8 K tile (rows of D + 16 bytes) into the bf16
  tile (rows of D + 8) that the bf16 route's ``ldmatrix`` loads read: every
  code in its column, exactly;
* P V: the B fragments (one load of NT = D / 32 bytes from each of four key
  rows, byte-permuted and widened) multiply, through
  ``mma.sync.m16n8k16``'s fragment layout, to P' C_v exactly, and each C
  fragment lands, through ``v_column``, at its true column of O, in the
  split's partial (NT consecutive columns a store) and in the output;
* the V loads hit no bank twice within a phase, at every D.

    python3 tools/paged_int8_model.py

Plain numpy, no card; edit it with the kernel's arithmetic.
"""
import numpy as np

PAD = 16                     # bytes after each K and V row in shared memory
KEYS = 32                    # keys per tensor-core tile
ROWS = 16                    # query heads per tile (zero-padded)


def bf16_bits_to_float(bits):
    """bf16 bit patterns (uint16) as float64, exactly."""
    return (np.asarray(bits, np.uint32) << 16).view(np.float32).astype(np.float64)


def bf16_round(x):
    """float32 values rounded to the nearest bf16 (ties to even), as
    float64."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) >> 16
    return bf16_bits_to_float(u.astype(np.uint16))


def codes_bf16x2(t):
    """The kernel's widening: bytes 0 and 2 of ``t`` (uint32) as (lo, hi)
    bf16 values, float64, through (0x4300 | x & 0x7f) - (0x4300 | x &
    0x80) in bf16 arithmetic (exact when the difference is a bf16, which
    the check asserts)."""
    t = np.asarray(t, np.uint32)
    a = (t & np.uint32(0x007F007F)) | np.uint32(0x43004300)
    b = (t & np.uint32(0x00800080)) | np.uint32(0x43004300)
    out = []
    for shift in (0, 16):
        x = bf16_bits_to_float((a >> shift) & 0xFFFF) - bf16_bits_to_float((b >> shift) & 0xFFFF)
        assert np.array_equal(bf16_round(x), x), "a difference bf16 does not hold"
        out.append(x)
    return out[0], out[1]


def byte_perm(x, y, sel):
    """CUDA's __byte_perm(x, y, sel) on uint32 arrays."""
    src = np.stack([(np.asarray(v, np.uint32) >> (8 * k)) & 0xFF for v in (x, y)
                    for k in range(4)])
    out = np.zeros_like(np.asarray(x, np.uint32))
    for k in range(4):
        out |= src[(sel >> (4 * k)) & 7] << np.uint32(8 * k)
    return out


def v_column(col0, j, n, d):
    return col0 + (d // 32) * n + j


def mma(a_frag, b_frag):
    """mma.sync.m16n8k16 on per-lane fragments (float64 values): a_frag
    [lane][4][2] (a0 (g, 2c..), a1 (g + 8, 2c..), a2 (g, 2c + 8..), a3
    (g + 8, 2c + 8..)), b_frag [lane][2][2] (b0 (k 2c.., n g), b1 (k
    2c + 8.., n g)); returns C [lane][4] (c0, c1 (g, 2c..), c2, c3 (g + 8,
    2c..))."""
    a = np.zeros((16, 16))
    b = np.zeros((16, 8))
    for lane in range(32):
        g, c = lane >> 2, lane & 3
        for r, (row, col) in enumerate(((g, 2 * c), (g + 8, 2 * c), (g, 2 * c + 8),
                                        (g + 8, 2 * c + 8))):
            a[row, col:col + 2] = a_frag[lane][r]
        for r, k in enumerate((2 * c, 2 * c + 8)):
            b[k:k + 2, g] = b_frag[lane][r]
    cm = a @ b
    out = np.zeros((32, 4))
    for lane in range(32):
        g, c = lane >> 2, lane & 3
        out[lane] = [cm[g, 2 * c], cm[g, 2 * c + 1], cm[g + 8, 2 * c], cm[g + 8, 2 * c + 1]]
    return out


def tile_bytes(codes, d):
    """An int8 tile (keys, d) as shared memory rows of d + PAD bytes."""
    rows = np.zeros((codes.shape[0], d + PAD), np.uint8)
    rows[:, :d] = codes.view(np.uint8)
    return rows


def word(rows, row, byte):
    return np.uint32(int.from_bytes(bytes(rows[row, byte:byte + 4]), "little"))


def widen_tile(codes, d):
    """widen_tile: the K tile's rows of bytes, 16 a load, into bf16 rows of
    d + 8: word i of a load gives (codes 0, 1) through byte_perm 0x1100 and
    (codes 2, 3) through 0x3322, each then codes_bf16x2."""
    kt = tile_bytes(codes, d)
    out = np.full((codes.shape[0], d + 8), np.nan)
    for row in range(codes.shape[0]):
        for ch in range(d // 16):
            for i in range(4):
                w = word(kt, row, 16 * ch + 4 * i)
                for half, sel in enumerate((0x1100, 0x3322)):
                    lo, hi = codes_bf16x2(byte_perm(w, np.uint32(0), sel))
                    col = 16 * ch + 4 * i + 2 * half
                    out[row, col:col + 2] = [lo, hi]
    return out[:, :d]


def pv(p, v_codes, d):
    """pv_int8 over both k16 steps of a tile and the four warps, then the
    stores: O (16, d) at true columns, from P' (16, 32) and V's codes
    (32, d); also the split partial's store addresses (NT consecutive
    columns each) and the set of columns written."""
    nt = d // 32
    vt = tile_bytes(v_codes, d)
    o_true = np.full((ROWS, d), np.nan)
    partial_cols = set()
    for warp in range(4):
        col0 = warp * (d // 4)
        o = np.zeros((nt, 32, 4))
        for k2 in range(2):
            a = [[p[row, col:col + 2] for row, col in
                  ((lane >> 2, 16 * k2 + 2 * (lane & 3)), ((lane >> 2) + 8, 16 * k2 + 2 * (lane & 3)),
                   (lane >> 2, 16 * k2 + 8 + 2 * (lane & 3)),
                   ((lane >> 2) + 8, 16 * k2 + 8 + 2 * (lane & 3)))] for lane in range(32)]
            bfr = [[] for _ in range(nt)]
            for lane in range(32):
                g, c = lane >> 2, lane & 3
                base = v_column(col0, 0, g, d)
                rows = [16 * k2 + 2 * c + dr for dr in (0, 1, 8, 9)]
                regs = []
                for r in rows:                        # load_v_codes<NT>
                    raw = bytes(vt[r, base:base + nt]) + bytes(8)
                    regs.append([np.uint32(int.from_bytes(raw[4 * w:4 * w + 4], "little"))
                                 for w in range((nt + 3) // 4)])
                for j in range(nt):
                    x = j & 3
                    sel = x | (x << 4) | ((4 + x) << 8) | ((4 + x) << 12)
                    b0 = codes_bf16x2(byte_perm(regs[0][j >> 2], regs[1][j >> 2], sel))
                    b1 = codes_bf16x2(byte_perm(regs[2][j >> 2], regs[3][j >> 2], sel))
                    bfr[j].append([np.array(b0), np.array(b1)])
            for j in range(nt):
                o[j] += mma(a, bfr[j])
        for lane in range(32):
            g, c = lane >> 2, lane & 3
            for r in range(2):
                for e in range(2):
                    # the partial: one store of NT columns from column(0, e)
                    start = v_column(col0, 0, 2 * c + e, d)
                    assert start % nt == 0
                    partial_cols.update(range(start, start + nt))
                    for j in range(nt):
                        col = v_column(col0, j, 2 * c + e, d)
                        assert col == start + j
                        assert np.isnan(o_true[g + 8 * r, col]), "a column written twice"
                        o_true[g + 8 * r, col] = o[j][lane][2 * r + e]
    assert partial_cols == set(range(d))
    return o_true


def phase_conflicts(addresses, width):
    """The worst bank conflict degree of one shared load instruction: byte
    addresses per lane, ``width`` bytes each; phases of 128 bytes' worth of
    lanes; distinct 4-byte words in one bank serialise."""
    per_phase = max(1, min(32, 128 // width))
    worst = 1
    for p0 in range(0, 32, per_phase):
        banks = {}
        for lane in range(p0, p0 + per_phase):
            for w in range(addresses[lane] // 4, (addresses[lane] + width + 3) // 4):
                banks.setdefault(w % 32, set()).add(w)
        worst = max(worst, max(len(ws) for ws in banks.values()))
    return worst


def v_conflicts(d):
    row, nt = d + PAD, d // 32
    return max(phase_conflicts([(16 * k2 + 2 * (lane & 3) + dr) * row
                                + v_column(w * (d // 4), 0, lane >> 2, d)
                                for lane in range(32)], nt)
               for w in range(4) for k2 in range(2) for dr in (0, 1, 8, 9))


def check_widening():
    x = np.arange(1 << 16, dtype=np.uint32)
    t = (x & 0xFF) | ((x >> 8) << 16)               # bytes 0 and 2
    lo, hi = codes_bf16x2(t)
    want_lo = (x & 0xFF).astype(np.uint8).view(np.int8).astype(np.float64)
    want_hi = (x >> 8).astype(np.uint8).view(np.int8).astype(np.float64)
    assert np.array_equal(lo, want_lo) and np.array_equal(hi, want_hi)


def check_products(d, head_dim, seed=0):
    """The widened K tile holds the codes, and P' V from the lane model
    equals the float64 product exactly (every term a bf16 times an int8
    code, every sum in float64); columns past head_dim zero, as the
    kernel's loads leave them."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(-128, 128, (2, KEYS, d)).astype(np.int8)
    codes[:, :, head_dim:] = 0
    assert np.array_equal(widen_tile(codes[0], d), codes[0].astype(np.float64))
    p = bf16_round(rng.random((ROWS, KEYS)).astype(np.float32))
    o = pv(p, codes[1], d)
    assert np.array_equal(o, p @ codes[1].astype(np.float64))


def main():
    check_widening()
    for d in (64, 128, 256):
        v = v_conflicts(d)
        assert v == 1, (d, v)
        print(f"D={d}: V load conflict degree {v}")
    for d, head_dim in ((64, 64), (64, 56), (128, 128), (128, 120), (256, 256)):
        check_products(d, head_dim)
        print(f"D={d}, head_dim {head_dim}: widened K and P' V exact")
    print("ok")


if __name__ == "__main__":
    main()
