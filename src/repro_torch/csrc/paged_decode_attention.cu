// Paged decode attention for Hopper (sm_90a), with a plain C interface for
// ctypes.
//
// Replaces the Pallas TPU kernel `_paged_kernel` /
// `paged_decode_attention` in src/repro/kernels/paged_decode_attention.py,
// both variants: one query token per sequence, GQA, against a shared page
// pool addressed through per-sequence block tables.
//
//   q            (B, H, D)            fp32 or bf16, contiguous, 16-byte
//                                     aligned
//   k/v pages    (N, page, KV, D)     q's dtype, or int8 codes; read in
//                                     place by strides
//   k/v scales   (N, page, KV) fp32   int8 pools only: per-(slot, kv-head)
//                                     scales, read in place by strides
//   block_tables (B, P) int32         physical page ids, -1 = unassigned
//   lengths      (B,)   int32         tokens written so far
//   out          (B, H, D)            q's dtype
//   ws           fp32 workspace       (B * KV, splits, G, Dp) partial
//                                     accumulators, then (B * KV, splits,
//                                     G, 2) partial (m, l); unused with
//                                     one split
//   counters     (B * KV,) int32      zero between launches; unused with
//                                     one split
//
// head_dim is any multiple of 8 up to 256: the kernel is instantiated at
// Dp, the next of 32, 64, 128, 256, and takes the true head_dim at run
// time.  Columns past it are zero-filled in the shared tiles and in q, and
// nothing past it is stored, so D=120 runs the D=128 instance.
//
// int8 pools (the TPU kernel's `quantized=True`): codes and their fp32
// (slot, kv-head) scales land in shared memory as they are stored, and are
// widened in registers (by integer and bf16 ops, not the conversion unit);
// a -1 table entry reads page 0's codes AND scales, like the TPU kernel's
// `scale_map`.  The CUDA cores dequantize each element as k * k_scale,
// v * v_scale in fp32, as the reference does; the tensor cores take the
// codes themselves, exact in bf16, and fold the scales, one per key, into
// S and P (below).
//
// Semantics are those of the TPU kernel: scores are fp32 with the
// 1/sqrt(D) scale, then an optional tanh softcap, then the mask (position <
// length and an assigned entry), masked scores -1e30, fp32 online softmax,
// output acc / max(l, 1e-30).
//
// Bound.  Decode attention does ~2 flops per byte read: it is bound by the
// bytes of live K/V it reads from device memory, at 3.35 TB/s (an int8
// pool: D + 4 bytes per (slot, kv-head) row instead of 2D for bf16).  The
// card needs every SM streaming to reach that, with tens of KB in flight on
// each, and the arithmetic on each tile short enough to hide behind the
// next tile's copy.
//
// Design.  The TPU grid (B, KV, P) visited every table entry in order and
// carried the softmax state in scratch.  Here the P entries of each
// (sequence, KV head) are cut into `splits` chunks of `chunk` entries,
// chosen on the host from static shapes (P, page, B * KV, G, the SM count)
// so that the grid (B, KV, splits) fills the card.  A block walks only the
// entries its softmax can weigh: j < ceil(min(len, P * page) / page), and
// within them it reads no -1 entry (zeros land instead) and no slot past
// the length.  Their weight is exactly 0 once the row has one live key
// (exp(-1e30 - m) = 0), so skipping them is exact; a block whose chunk holds
// no live entry exits at once with an empty partial (m = -1e30, l = 0, its
// accumulator neither written nor read).  Whether the row has a live key at
// all every block reads from the row's whole table (P int32, one warp
// vote).  A row with none (length <= 0, or every live entry -1) keeps the
// reference's meaning, the uniform average of V over all P entries with -1
// reading page 0: every split then sums its V rows with weight 1 and reads
// no K, so those rows stay cheap.
//
// Inside a block, tiles of `tp` whole pages (32 keys at page 16) land in
// shared memory in their storage type (bf16, or int8 codes with their
// scales) through a two-stage cp.async ring, so the next tile loads
// while this one is used; K and V rows are padded by 16 bytes so that rows
// read at one column hit distinct banks.  The G query heads of the KV head
// share each tile, by one of two routes:
//
// * CUDA cores (fp32 q, and bf16 q with G > 16, D = 32 or tiles other than
//   32 keys; either pool).  Each warp owns up to four heads with q
//   (pre-scaled, fp32) in shared memory, and each lane scores one key of the
//   tile -- a dot product in registers, four partial sums, no shuffle per
//   key.  Then one max and one sum over the warp per tile, and the lanes
//   split the head dim for P V, widening (and dequantizing) each V row in
//   registers.  P stays fp32, as in the TPU kernel.
// * Tensor cores (bf16 q with a bf16 or an int8 pool, G <= 16, D >= 64,
//   32-key tiles): `mma.sync.m16n8k16` with the G heads as the 16 rows
//   (padded with zeros).  Every one of the four warps computes S = q K^T for
//   the whole tile (q unscaled in bf16, exact; the scale and softcap are
//   applied to S in fp32), the softmax runs on the C fragments (quad
//   shuffles per row), and each warp multiplies P by its quarter of V's
//   columns.  P is split into two bf16 terms, hi + lo, so that P V keeps
//   ~16 bits of P where one bf16 rounding would keep 8.
//   An int8 code in [-128, 127] is exact in bf16, and a key's scales factor
//   out of both products: q . (s_k c) = s_k (q . c), and
//   sum_t p_t s_v[t] c_t = sum_t (p_t s_v[t]) c_t.  So the int8 pool's
//   tensor-core route takes S = q C_k^T on the codes, scales column t by
//   s_k[t] / sqrt(D) in fp32, and multiplies P' = P s_v (fp32, then hi + lo)
//   by C_v.  ldmatrix has no int8 form, so the codes are widened
//   (`codes_bf16x2`, exact) on their way to the B fragments:
//   - K: once a tile, by the whole block, into a bf16 tile in shared memory
//     that the bf16 route's ldmatrix loads then read (every warp needs the
//     whole tile: widened in each warp's registers instead, K costs four
//     times the conversions; measured slower at G = 4, 6 and 16, PERF.md).
//   - V: in registers (each warp widens only its quarter of the columns).
//     V's columns and O's are permuted together within each warp's
//     quarter, so that one load of NT = D / 32 bytes from a key row holds
//     that row's codes of the thread's column in each of the NT n tiles;
//     two rows' loads, byte-permuted, give the (2c, 2c + 1) pairs.  O is
//     stored through the same permutation (`v_column`).  (A bf16 V tile
//     read by ldmatrix.trans measured slower.)
//   The V loads are free of bank conflicts at every D.
//
// Combine, in the same launch: each block of a split row writes its
// (m, l, acc) in fp32, fences, and bumps the row's counter; the block that
// bumps it last resets it to 0 and merges the splits:
// m* = max m_s, l* = sum l_s e^(m_s - m*), out = sum acc_s e^(m_s - m*) /
// max(l*, 1e-30), reading the partials through L2 (ld.global.cg), 16
// loads in flight per thread.  So one launch per call, and the counters
// are zero again when it ends: launches on one stream may share them,
// launches on two streams at once may not.

#include "decode_split.cuh"

namespace {

constexpr int kMmaKeys = 32;  // keys per tensor-core tile

// The int8 codes in bytes 0 and 2 of `t` as a bf16x2 register (byte 0 in the
// low half), exactly: the bf16 with bits 0x4300 | m is 128 + m (m < 128),
// so (0x4300 | (x & 0x7f)) - (0x4300 | (x & 0x80)) is x for x < 128 and
// (128 + x - 128) - 256 = x - 256 for x >= 128: the signed code, and a
// difference bf16 holds exactly.  Two LOP3s and one bf16x2 subtraction.
__device__ __forceinline__ uint32_t codes_bf16x2(uint32_t t) {
  const uint32_t a = (t & 0x007f007fu) | 0x43004300u;
  const uint32_t b = (t & 0x00800080u) | 0x43004300u;
  uint32_t r;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// The physical column, in a warp's quarter of V and O starting at col0, of
// n tile j's column n: NT = D / 32 tiles interleaved, so that a thread's
// column n of every tile lies in NT consecutive bytes of a V row.
template <int D>
__device__ __forceinline__ int v_column(int col0, int j, int n) {
  return col0 + (D / 32) * n + j;
}

// NT = D / 32 int8 codes of one V row at the thread's column of each n tile
// (v_column), in (NT + 3) / 4 32-bit words (tile j in byte j % 4 of word
// j / 4).
template <int NT>
__device__ __forceinline__ void load_v_codes(uint32_t* w, const unsigned char* p) {
  if constexpr (NT == 2) {
    w[0] = *reinterpret_cast<const unsigned short*>(p);
  } else if constexpr (NT == 4) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    w[0] = x.x;
    w[1] = x.y;
  }
}

// O (this warp's NT n tiles) += P'[:, k0 .. k0 + 15] C_v, P' given as the
// hi and lo A fragments, from the int8 tile vt's keys k0 .. k0 + 15 and the
// warp's quarter of the columns from col0 (permuted by v_column).
template <int D, int ROW>
__device__ __forceinline__ void pv_int8(float (&o)[D / 32][4], const uint32_t* ph,
                                        const uint32_t* pl, const unsigned char* vt, int k0,
                                        int col0, int lane) {
  constexpr int NT = D / 32;
  constexpr int NW = (NT + 3) / 4;
  const int g = lane >> 2;
  const int c = lane & 3;
  const unsigned char* base = vt + (k0 + 2 * c) * ROW + v_column<D>(col0, 0, g);
  uint32_t r0[NW], r1[NW], r2[NW], r3[NW];  // keys 2c, 2c + 1, 2c + 8, 2c + 9
  load_v_codes<NT>(r0, base);
  load_v_codes<NT>(r1, base + ROW);
  load_v_codes<NT>(r2, base + 8 * ROW);
  load_v_codes<NT>(r3, base + 9 * ROW);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int x = j & 3;
    const uint32_t sel = x | (x << 4) | ((4 + x) << 8) | ((4 + x) << 12);
    const uint32_t b0 = codes_bf16x2(__byte_perm(r0[j >> 2], r1[j >> 2], sel));
    const uint32_t b1 = codes_bf16x2(__byte_perm(r2[j >> 2], r3[j >> 2], sel));
    mma16816(o[j], ph, b0, b1);
    mma16816(o[j], pl, b0, b1);
  }
}

// An int8 tile (tk rows of ROW bytes) widened into a bf16 tile (rows of
// D + 8 elements) by every thread of the block, 16 codes a load.
template <int D, int ROW>
__device__ __forceinline__ void widen_tile(bf16* dst, const unsigned char* src, int tk) {
  for (int x = threadIdx.x; x < tk * (D / 16); x += blockDim.x) {
    const int row = x / (D / 16);
    const int ch = x - row * (D / 16);
    const uint4 w = *reinterpret_cast<const uint4*>(src + row * ROW + 16 * ch);
    const uint32_t in[4] = {w.x, w.y, w.z, w.w};
    uint32_t out[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = codes_bf16x2(__byte_perm(in[i], 0, 0x1100));      // codes 0, 1
      out[2 * i + 1] = codes_bf16x2(__byte_perm(in[i], 0, 0x3322));  // codes 2, 3
    }
    uint4* d = reinterpret_cast<uint4*>(dst + row * (D + 8) + 16 * ch);
    d[0] = make_uint4(out[0], out[1], out[2], out[3]);
    d[1] = make_uint4(out[4], out[5], out[6], out[7]);
  }
}

// Bytes of one ring stage of `tk`-key tiles: K and V rows (padded), for
// int8 pools the keys' k and v scales, and a live flag per key.  A block's
// shared memory: two stages, q (q_bytes), each warp's scores, with splits
// the combine's weights, and for the int8 pool on the tensor cores the
// widened K tile.
__host__ __device__ __forceinline__ int stage_bytes(int tk, int d, int es, bool quant) {
  const int bytes = 2 * tk * (d * es + kPad) + (quant ? 8 * tk : 0) + tk;
  return (bytes + 15) / 16 * 16;
}

// Tq: q and out; Tpool: the pages; QUANT: int8 pages with fp32 scales; VB:
// bytes per copy from the pages (16, or 8 for int8 rows of 8 bytes'
// alignment); MMA: the tensor-core route.
template <typename Tq, typename Tpool, bool QUANT, int D, int VB, bool MMA>
__global__ void __launch_bounds__(kMaxWarps * 32)
    paged_decode_kernel(const Tq* __restrict__ q, const Tpool* __restrict__ k_pages,
                        const Tpool* __restrict__ v_pages, const float* __restrict__ k_scales,
                        const float* __restrict__ v_scales, const int* __restrict__ block_tables,
                        const int* __restrict__ lengths, Tq* __restrict__ out, float* ws,
                        int* counters, int num_heads, int num_kv, int head_dim, int pages_per_seq,
                        int page_size, int chunk, int tp, long long stride_page,
                        long long stride_slot, long long stride_head,
                        long long scale_stride_page, long long scale_stride_slot,
                        long long scale_stride_head, float scale, float softcap) {
  constexpr int ES = (int)sizeof(Tpool);
  constexpr int CN = VB / ES;            // pool elements per copy
  constexpr int CPR = D / CN;            // copies per row
  constexpr int VN = 16 / ES;            // pool elements per 16-byte shared read
  constexpr int ROW = D * ES + kPad;     // bytes per K or V row in shared memory
  constexpr int PITCH = ROW / ES;        // the same, in elements
  constexpr int EPL = D / 32;            // CUDA cores: output columns per lane
  constexpr int NT = D / 32;             // tensor cores: n tiles of 8 columns per warp
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int split = blockIdx.z;
  const int splits = gridDim.z;
  const int group = num_heads / num_kv;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nthreads = blockDim.x;
  const int nwarps = nthreads >> 5;
  const int tk = tp * page_size;         // keys per tile
  const int stage = stage_bytes(tk, D, ES, QUANT);

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* q_raw = smem + kStages * stage;
  float* q_s = reinterpret_cast<float*>(q_raw);                    // CUDA cores: (group, D)
  bf16* q_b = reinterpret_cast<bf16*>(q_raw);                      // tensor cores: (16, D + 8)
  float* p_all = reinterpret_cast<float*>(q_raw + q_bytes(group, D));
  float* p_s = p_all + warp * (kMaxHeadsPerWarp * tk);             // this warp's scores
  float* comb = p_all + nwarps * (kMaxHeadsPerWarp * tk);          // (group, splits + 1)
  // tensor cores, int8 pools: the tile's K widened to bf16 (rows of D + 8),
  // after comb, 16-byte aligned
  bf16* k_st = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(comb + (splits > 1 ? group * (splits + 1) : 0)) + 15) &
      ~uintptr_t(15));

  // Whether the row has a live key: an assigned entry below the length.
  const int length = lengths[b];
  const int* table = block_tables + (long long)b * pages_per_seq;
  bool any = false;
  for (int j = lane; j < pages_per_seq; j += 32)
    any |= table[j] >= 0 && j * page_size < length;
  const bool uniform = !__any_sync(0xffffffffu, any);
  // live rows: the entries below the length; uniform rows: all P
  const int span = pages_per_seq * page_size;
  const int len_eff = uniform ? span : (length < span ? length : span);
  const int nlive = (len_eff + page_size - 1) / page_size;
  // this block's part of them
  const int e_lo = split * chunk;
  const int e_hi = nlive < e_lo + chunk ? nlive : e_lo + chunk;
  const int ntiles = e_hi > e_lo ? (e_hi - e_lo + tp - 1) / tp : 0;

  auto tile_keys = [&](int i) {
    const int j0 = e_lo + i * tp;
    const int j1 = j0 + tp < e_hi ? j0 + tp : e_hi;
    const int n = (j1 - j0) * page_size;
    const int left = len_eff - j0 * page_size;
    return n < left ? n : left;
  };
  auto load_tile = [&](int i) {
    if (i < ntiles) {
      const int j0 = e_lo + i * tp;
      const int keys = tile_keys(i);
      // the tensor cores read every row of the tile: zeros past the keys
      const int n = MMA ? tk : keys;
      unsigned char* st = smem + (i % kStages) * stage;
      unsigned char* kt = st;
      unsigned char* vt = st + tk * ROW;
      float* ks_t = reinterpret_cast<float*>(st + 2 * tk * ROW);
      unsigned char* live_t = reinterpret_cast<unsigned char*>(ks_t) + (QUANT ? 8 * tk : 0);
#pragma unroll 4
      for (int x = tid; x < n * CPR; x += nthreads) {
        const int t = x / CPR;
        const int c = x - t * CPR;
        const int pi = (t < keys ? t : 0) / page_size;
        const int u = (t < keys ? t : 0) - pi * page_size;
        const int entry = table[j0 + pi];
        // a -1 entry: zeros (masked) in a live row, page 0 in a uniform one
        const bool read = t < keys && (uniform || entry >= 0);
        const int phys = entry >= 0 ? entry : 0;
        const long long row = (long long)phys * stride_page + (long long)u * stride_slot +
                              (long long)kvh * stride_head;
        const bool in = read && c * CN < head_dim;  // zeros past head_dim
        const long long off = in ? row + c * CN : row;
        if (!uniform) cp_async<VB>(kt + t * ROW + c * VB, k_pages + off, in ? VB : 0);
        cp_async<VB>(vt + t * ROW + c * VB, v_pages + off, in ? VB : 0);
        if (c == 0) {
          if constexpr (QUANT) {
            const long long soff = (long long)phys * scale_stride_page +
                                   (long long)u * scale_stride_slot +
                                   (long long)kvh * scale_stride_head;
            if (!uniform) cp_async<4>(ks_t + t, k_scales + soff, read ? 4 : 0);
            cp_async<4>(ks_t + tk + t, v_scales + soff, read ? 4 : 0);
          }
          live_t[t] = read;
        }
      }
    }
    cp_async_commit();  // an empty group past the last tile keeps the count
  };

  // CUDA cores: per head of the warp, running max, sum and EPL columns
  float acc[kMaxHeadsPerWarp][EPL];
  float m[kMaxHeadsPerWarp];
  float l[kMaxHeadsPerWarp];
  // tensor cores: rows g, g + 8 of the C fragments (running max and sum),
  // NT n tiles of this warp's quarter of the columns
  float o[NT][4];
  float mr[2] = {kNegInf, kNegInf};
  float lr[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < kMaxHeadsPerWarp; ++h) {
    m[h] = kNegInf;
    l[h] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[h][e] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  if (ntiles > 0) {
    load_tile(0);
    // q while the first tiles land: fp32 and pre-scaled for the CUDA cores,
    // bf16 as it is (the scale goes on S) for the tensor cores
    const Tq* qb = q + ((long long)b * num_heads + (long long)kvh * group) * head_dim;
    if constexpr (MMA)
      load_q<Tq, bf16, D + 8>(qb, q_b, group, kMmaRows, head_dim, [](Tq x) { return x; });
    else
      load_q<Tq, float, D>(qb, q_s, group, group, head_dim,
                           [scale](Tq x) { return to_float(x) * scale; });
  }
  for (int i = 0; i < ntiles; ++i) {
    load_tile(i + 1);
    cp_async_wait<1>();  // tile i has landed
    __syncthreads();                // for every warp (and q with it)
    const unsigned char* st = smem + (i % kStages) * stage;
    const float* ks_t = reinterpret_cast<const float*>(st + 2 * tk * ROW);
    const unsigned char* live_t =
        reinterpret_cast<const unsigned char*>(ks_t) + (QUANT ? 8 * tk : 0);
    const int n = tile_keys(i);

    if constexpr (MMA) {
      // int8 pools: K widened once into a bf16 tile by the whole block (not
      // by each warp for its fragments: measured faster, PERF.md)
      if constexpr (QUANT) {
        if (!uniform) widen_tile<D, ROW>(k_st, st, tk);
        __syncthreads();
      }
      constexpr int KP = QUANT ? D + 8 : PITCH;
      const bf16* kt = QUANT ? k_st : reinterpret_cast<const bf16*>(st);
      const bf16* vt = reinterpret_cast<const bf16*>(st + tk * ROW);
      const int gq = lane >> 2;
      const int cq = lane & 3;
      // S = q K^T: 16 head rows x 32 keys, in every warp
      float s[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      if (!uniform) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t a[4], bk[4];
          load_a<D + 8>(a, q_b, kk * 16, lane);
          load_b<KP>(bk, kt, 0, kk * 16, lane);
          mma16816(s[0], a, bk[0], bk[1]);
          mma16816(s[1], a, bk[2], bk[3]);
          load_b<KP>(bk, kt, 16, kk * 16, lane);
          mma16816(s[2], a, bk[0], bk[1]);
          mma16816(s[3], a, bk[2], bk[3]);
        }
      }
      // int8 pools: each key's scales, k (times 1/sqrt(D)) on S and v on P;
      // a uniform row's S is 0 (its k scales were never loaded)
      float2 sk[4], sv[4];
      if constexpr (QUANT) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 k2 = *reinterpret_cast<const float2*>(ks_t + 8 * j + 2 * cq);
          sk[j] = uniform ? make_float2(0.f, 0.f) : make_float2(k2.x * scale, k2.y * scale);
          sv[j] = *reinterpret_cast<const float2*>(ks_t + tk + 8 * j + 2 * cq);
        }
      }
      // the softmax on the fragments: rows gq (e < 2) and gq + 8, keys
      // 8j + 2cq + (e & 1); masked keys -1e30, weight 0
      bool live[4][2];
      float mt[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = 8 * j + 2 * cq + (e & 1);
          if (e < 2) live[j][e] = key < n && live_t[key];
          float sc = s[j][e] * scale;
          if constexpr (QUANT) sc = s[j][e] * (e & 1 ? sk[j].y : sk[j].x);
          if (softcap > 0.f) sc = softcap * tanhf(sc / softcap);
          s[j][e] = live[j][e & 1] ? sc : kNegInf;  // uniform rows: score 0
          mt[e >> 1] = fmaxf(mt[e >> 1], s[j][e]);
        }
      float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
        const float m_new = fmaxf(mr[r], mt[r]);
        alpha[r] = expf(mr[r] - m_new);
        mr[r] = m_new;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = live[j][e & 1] ? expf(s[j][e] - mr[e >> 1]) : 0.f;
          rs[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
        lr[r] = lr[r] * alpha[r] + rs[r];
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];
      // O += P V over this warp's columns, P (int8 pools: P' = P s_v) as
      // hi + lo bf16 terms
      if constexpr (QUANT) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] *= e & 1 ? sv[j].y : sv[j].x;
      }
      const int col0 = warp * (D / 4);
#pragma unroll
      for (int k2 = 0; k2 < 2; ++k2) {
        uint32_t ph[4], pl[4];
        ph[0] = pack_bf16(s[2 * k2][0], s[2 * k2][1]);
        ph[1] = pack_bf16(s[2 * k2][2], s[2 * k2][3]);
        ph[2] = pack_bf16(s[2 * k2 + 1][0], s[2 * k2 + 1][1]);
        ph[3] = pack_bf16(s[2 * k2 + 1][2], s[2 * k2 + 1][3]);
        pl[0] = pack_bf16_rest(s[2 * k2][0], s[2 * k2][1], ph[0]);
        pl[1] = pack_bf16_rest(s[2 * k2][2], s[2 * k2][3], ph[1]);
        pl[2] = pack_bf16_rest(s[2 * k2 + 1][0], s[2 * k2 + 1][1], ph[2]);
        pl[3] = pack_bf16_rest(s[2 * k2 + 1][2], s[2 * k2 + 1][3], ph[3]);
        if constexpr (QUANT) {
          pv_int8<D, ROW>(o, ph, pl, st + tk * ROW, 16 * k2, col0, lane);
        } else {
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            uint32_t bv[4];
            load_b_trans<PITCH>(bv, vt, 16 * k2, col0 + 16 * np, lane);
            mma16816(o[2 * np], ph, bv[0], bv[1]);
            mma16816(o[2 * np + 1], ph, bv[2], bv[3]);
            mma16816(o[2 * np], pl, bv[0], bv[1]);
            mma16816(o[2 * np + 1], pl, bv[2], bv[3]);
          }
        }
      }
    } else {
      const Tpool* vt = reinterpret_cast<const Tpool*>(st + tk * ROW);
      // scores: one key per lane (tiles of more than 32 keys: several), for
      // each of the warp's heads in four partial sums; masked keys -1e30
      float m_tile[kMaxHeadsPerWarp];
#pragma unroll
      for (int h = 0; h < kMaxHeadsPerWarp; ++h) m_tile[h] = kNegInf;
      for (int t = lane; t < n; t += 32) {
        float s[kMaxHeadsPerWarp][4];
#pragma unroll
        for (int h = 0; h < kMaxHeadsPerWarp; ++h)
#pragma unroll
          for (int r = 0; r < 4; ++r) s[h][r] = 0.f;
        const bool live = live_t[t];
        if (!uniform && live) {
          const Tpool* krow = reinterpret_cast<const Tpool*>(st + t * ROW);
          float ks = 1.f;
          if constexpr (QUANT) ks = ks_t[t];
#pragma unroll 2
          for (int c = 0; c < D / VN; ++c) {
            float kf[VN];
            load_floats<Tpool, VN>(krow + c * VN, kf);
            if constexpr (QUANT) {
#pragma unroll
              for (int e = 0; e < VN; ++e) kf[e] *= ks;  // k * k_scale, as the reference
            }
#pragma unroll
            for (int h = 0; h < kMaxHeadsPerWarp; ++h) {
              if (warp + h * nwarps >= group) break;  // uniform across the warp
#pragma unroll
              for (int e0 = 0; e0 < VN; e0 += 4) {
                const float4 qv = *reinterpret_cast<const float4*>(
                    q_s + (warp + h * nwarps) * D + c * VN + e0);
                s[h][0] = fmaf(qv.x, kf[e0], s[h][0]);
                s[h][1] = fmaf(qv.y, kf[e0 + 1], s[h][1]);
                s[h][2] = fmaf(qv.z, kf[e0 + 2], s[h][2]);
                s[h][3] = fmaf(qv.w, kf[e0 + 3], s[h][3]);
              }
            }
          }
        }
#pragma unroll
        for (int h = 0; h < kMaxHeadsPerWarp; ++h) {
          if (warp + h * nwarps >= group) break;
          float sc = (s[h][0] + s[h][1]) + (s[h][2] + s[h][3]);
          if (softcap > 0.f) sc = softcap * tanhf(sc / softcap);
          sc = live ? sc : kNegInf;  // uniform rows: live, score 0
          p_s[h * tk + t] = sc;
          m_tile[h] = fmaxf(m_tile[h], sc);
        }
      }
      float alpha[kMaxHeadsPerWarp];
#pragma unroll
      for (int h = 0; h < kMaxHeadsPerWarp; ++h) alpha[h] = 1.f;
#pragma unroll
      for (int h = 0; h < kMaxHeadsPerWarp; ++h) {
        if (warp + h * nwarps >= group) break;
        const float m_new = fmaxf(m[h], warp_max(m_tile[h]));
        alpha[h] = expf(m[h] - m_new);
        float p_sum = 0.f;
        for (int t = lane; t < n; t += 32) {
          const float p = live_t[t] ? expf(p_s[h * tk + t] - m_new) : 0.f;
          p_s[h * tk + t] = p;
          p_sum += p;
        }
        l[h] = l[h] * alpha[h] + warp_sum(p_sum);
        m[h] = m_new;
      }
      __syncwarp();
      // P V: the lanes split the head dim, EPL columns each
#pragma unroll
      for (int h = 0; h < kMaxHeadsPerWarp; ++h)
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[h][e] *= alpha[h];
#pragma unroll 4
      for (int t = 0; t < n; ++t) {
        float vf[EPL];
        load_floats<Tpool, EPL>(vt + t * PITCH + lane * EPL, vf);
        if constexpr (QUANT) {
          const float vs = ks_t[tk + t];
#pragma unroll
          for (int e = 0; e < EPL; ++e) vf[e] *= vs;  // v * v_scale, as the reference
        }
#pragma unroll
        for (int h = 0; h < kMaxHeadsPerWarp; ++h) {
          if (warp + h * nwarps >= group) break;
          const float p = p_s[h * tk + t];
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[h][e] = fmaf(p, vf[e], acc[h][e]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }

  // the output (one split) or this split's partial: (m, l) per head, and
  // acc where l > 0
  const long long rowkv = (long long)b * num_kv + kvh;
  const long long rows = (long long)gridDim.x * num_kv;
  Tq* ob = out + ((long long)b * num_heads + (long long)kvh * group) * head_dim;
  float* ws_ml = ws + rows * splits * group * D;
  const long long part0 = (rowkv * splits + split) * group;
  if constexpr (MMA) {
    const int gq = lane >> 2;
    const int cq = lane & 3;
    const int col0 = warp * (D / 4);
    // the column of o[j][2r + e]: int8 pools through V's permutation
    auto column = [&](int j, int e) {
      return QUANT ? v_column<D>(col0, j, 2 * cq + e) : col0 + 8 * j + 2 * cq + e;
    };
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int g = gq + 8 * r;
      if (g >= group) continue;
      if (splits == 1) {
        const float denom = fmaxf(lr[r], 1e-30f);
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = column(j, e);
            if (col < head_dim) store(o[j][2 * r + e] / denom, ob + g * head_dim + col);
          }
        continue;
      }
      if (warp == 0 && cq == 0) {
        const float ml[2] = {mr[r], lr[r]};
        store_cg<2>(ml, ws_ml + (part0 + g) * 2);
      }
      if (lr[r] > 0.f) {
        if constexpr (QUANT) {
          // column e of every tile: NT consecutive columns
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float x[NT];
#pragma unroll
            for (int j = 0; j < NT; ++j) x[j] = o[j][2 * r + e];
            store_cg<NT>(x, ws + (part0 + g) * D + column(0, e));
          }
        } else {
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const float x[2] = {o[j][2 * r], o[j][2 * r + 1]};
            store_cg<2>(x, ws + (part0 + g) * D + column(j, 0));
          }
        }
      }
    }
  } else {
#pragma unroll
    for (int h = 0; h < kMaxHeadsPerWarp; ++h) {
      const int g = warp + h * nwarps;
      if (g >= group) break;
      if (splits == 1) {
        const float denom = fmaxf(l[h], 1e-30f);
#pragma unroll
        for (int e = 0; e < EPL; ++e)
          if (lane * EPL + e < head_dim)
            store(acc[h][e] / denom, ob + g * head_dim + lane * EPL + e);
        continue;
      }
      const float ml[2] = {m[h], l[h]};
      if (lane == 0) store_cg<2>(ml, ws_ml + (part0 + g) * 2);
      if (l[h] > 0.f) store_cg<EPL>(acc[h], ws + (part0 + g) * D + lane * EPL);
    }
  }
  if (splits > 1)
    merge<Tq, D>(ws, counters, ob, comb, rows, rowkv, splits, group, head_dim);
}

struct Args {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const void* k_scales;
  const void* v_scales;
  const void* block_tables;
  const void* lengths;
  void* out;
  void* ws;
  void* counters;
  int batch, num_heads, num_kv, head_dim, pages_per_seq, page_size, splits, chunk, tp, mma;
  long long stride_page, stride_slot, stride_head;
  long long scale_stride_page, scale_stride_slot, scale_stride_head;
  float scale, softcap;
  cudaStream_t stream;
};

template <typename Tq, typename Tpool, bool QUANT, int D, int VB, bool MMA>
int launch(const Args& a) {
  const int group = a.num_heads / a.num_kv;
  const int tk = a.tp * a.page_size;
  int nwarps = (group + kMaxHeadsPerWarp - 1) / kMaxHeadsPerWarp;
  if (nwarps < kMinWarps || MMA) nwarps = kMinWarps;  // tensor cores: a quarter of D each
  if (nwarps > kMaxWarps || (MMA && (group > kMmaRows || tk != kMmaKeys)))
    return (int)cudaErrorInvalidValue;
  if (a.splits < 1 || a.splits > kMaxSplits || a.chunk < 1 || a.tp < 1 || (long long)(a.splits - 1) * a.chunk >= a.pages_per_seq ||
      (long long)a.splits * a.chunk < a.pages_per_seq ||
      (a.splits > 1 && (a.ws == nullptr || a.counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kStages * stage_bytes(tk, D, (int)sizeof(Tpool), QUANT) +
                      q_bytes(group, D) +
                      sizeof(float) * ((size_t)nwarps * kMaxHeadsPerWarp * tk +
                                       (a.splits > 1 ? (size_t)group * (a.splits + 1) : 0)) +
                      (MMA && QUANT ? 16 + sizeof(bf16) * (size_t)tk * (D + 8) : 0);
  auto kernel = paged_decode_kernel<Tq, Tpool, QUANT, D, VB, MMA>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3(a.batch, a.num_kv, a.splits), nwarps * 32, smem, a.stream>>>(
      static_cast<const Tq*>(a.q), static_cast<const Tpool*>(a.k_pages),
      static_cast<const Tpool*>(a.v_pages), static_cast<const float*>(a.k_scales),
      static_cast<const float*>(a.v_scales), static_cast<const int*>(a.block_tables),
      static_cast<const int*>(a.lengths), static_cast<Tq*>(a.out), static_cast<float*>(a.ws),
      static_cast<int*>(a.counters), a.num_heads, a.num_kv, a.head_dim, a.pages_per_seq,
      a.page_size, a.chunk, a.tp, a.stride_page, a.stride_slot, a.stride_head,
      a.scale_stride_page, a.scale_stride_slot, a.scale_stride_head, a.scale, a.softcap);
  return (int)cudaGetLastError();
}

// The tensor cores take bf16 q with a bf16 or an int8 pool at head_dim
// instances of 64 and up.
template <typename Tq, typename Tpool, bool QUANT, int D, int VB>
int dispatch_route(const Args& a) {
  if constexpr (std::is_same<Tq, bf16>::value && !std::is_same<Tpool, float>::value && D >= 64) {
    if (a.mma) return launch<Tq, Tpool, QUANT, D, VB, true>(a);
  }
  if (a.mma) return (int)cudaErrorInvalidValue;
  return launch<Tq, Tpool, QUANT, D, VB, false>(a);
}

template <typename Tq, typename Tpool, bool QUANT, int VB>
int dispatch_instance(int head_dim, const Args& a) {
  if (head_dim <= 32) return dispatch_route<Tq, Tpool, QUANT, 32, VB>(a);
  if (head_dim <= 64) return dispatch_route<Tq, Tpool, QUANT, 64, VB>(a);
  if (head_dim <= 128) return dispatch_route<Tq, Tpool, QUANT, 128, VB>(a);
  return dispatch_route<Tq, Tpool, QUANT, 256, VB>(a);
}

// The instance for head_dim: the next of 32, 64, 128, 256 (any multiple of
// 8 up to 256); int8 rows not a multiple of 16 bytes load 8 bytes at a time.
template <typename Tq, typename Tpool, bool QUANT>
int dispatch_head_dim(int head_dim, const Args& a) {
  if (head_dim < 8 || head_dim > 256 || head_dim % 8) return (int)cudaErrorInvalidValue;
  if constexpr (QUANT) {
    if (head_dim % 16) return dispatch_instance<Tq, Tpool, QUANT, 8>(head_dim, a);
  }
  return dispatch_instance<Tq, Tpool, QUANT, 16>(head_dim, a);
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16.  pool_dtype: q_dtype (k/v scales
// unused, may be null), or 2 = int8 codes with fp32 k/v scales.  Strides
// are in elements; the last (head_dim) stride of the pools must be 1.
// head_dim: a multiple of 8 up to 256.  softcap <= 0 means none.  The P
// table entries are cut into `splits` chunks of `chunk` entries,
// (splits - 1) * chunk < P <= splits * chunk, walked in tiles of `tp`
// pages; `mma` != 0 takes the
// tensor cores (bf16 q, a bf16 or int8 pool, G <= 16, head_dim > 32,
// tp * page = 32).
// With splits > 1, `ws` holds B * KV * splits * G * (Dp + 2) floats (Dp:
// head_dim's instance) and `counters` B * KV int32 zeros, left zero.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages, const void* k_scales,
    const void* v_scales, const void* block_tables, const void* lengths, void* out, void* ws,
    void* counters, int q_dtype, int pool_dtype, int batch, int num_heads, int num_kv,
    int head_dim, int pages_per_seq, int page_size, int splits, int chunk, int tp, int mma,
    long long stride_page, long long stride_slot, long long stride_head,
    long long scale_stride_page, long long scale_stride_slot, long long scale_stride_head,
    float scale, float softcap, void* stream) {
  const Args a{q,          k_pages,     v_pages,      k_scales,          v_scales,
               block_tables, lengths,   out,          ws,                counters,
               batch,      num_heads,   num_kv,       head_dim,          pages_per_seq,
               page_size,  splits,      chunk,        tp,                mma,
               stride_page, stride_slot, stride_head, scale_stride_page,
               scale_stride_slot, scale_stride_head, scale, softcap,
               static_cast<cudaStream_t>(stream)};
  if (q_dtype == 0 && pool_dtype == 0) return dispatch_head_dim<float, float, false>(head_dim, a);
  if (q_dtype == 1 && pool_dtype == 1) return dispatch_head_dim<bf16, bf16, false>(head_dim, a);
  if (q_dtype == 0 && pool_dtype == 2) return dispatch_head_dim<float, int8_t, true>(head_dim, a);
  if (q_dtype == 1 && pool_dtype == 2) return dispatch_head_dim<bf16, int8_t, true>(head_dim, a);
  return (int)cudaErrorInvalidValue;
}
