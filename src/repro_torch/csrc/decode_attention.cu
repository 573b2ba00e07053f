// Dense-cache decode attention for Hopper (sm_90a), with a plain C
// interface for ctypes.
//
// Replaces the Pallas TPU kernel `_decode_kernel` / `decode_attention` in
// src/repro/kernels/decode_attention.py: one query token per row, GQA,
// against a statically shaped KV cache whose slot index is the position.
//
//   q        (B, H, D)       fp32 or bf16, contiguous, 16-byte aligned
//   k/v      (B, S, KV, D)   q's dtype, read in place by strides (the slot
//                            engine's per-layer cache view)
//   lengths  (B,)  int32     valid entries: positions 0..len-1
//   out      (B, H, D)       q's dtype
//   ws       fp32 workspace  (B * KV, splits, G, Dp) partial accumulators,
//                            then (B * KV, splits, G, 2) partial (m, l);
//                            unused with one split
//   counters (B * KV,) int32 zero between launches; unused with one split
//
// head_dim is any multiple of 8 up to 256: the kernel is instantiated at
// Dp, the next of 32, 64, 128, 256, and takes the true head_dim at run
// time.  Columns past it are zero-filled in the shared tiles and in q, and
// nothing past it is stored, so D=120 runs the D=128 instance.
//
// Semantics are those of the TPU kernel and of `decode_attention_ref`:
// fp32 scores with the 1/sqrt(D) scale, position p valid iff p < len (and
// p >= len - window with a window), masked scores -1e30, fp32 online
// softmax, output acc / max(l, 1e-30).  No softcap (the TPU kernel has
// none).
//
// Bound.  Decode attention does ~2 flops per byte read: it is bound by the
// bytes of live K/V it reads from device memory, at 3.35 TB/s.  The card
// needs every SM streaming to reach that, with tens of KB in flight on each,
// and the arithmetic on each tile short enough to hide behind the next
// tile's copy.
//
// Design.  The TPU grid (B, KV, S / block_k) ran its key axis in order and
// carried the softmax state in scratch.  Here the key axis of each
// (row, KV head) is cut into `splits` chunks of `chunk` keys, chosen on the
// host from static shapes (S, B * KV, G, the SM count) so that the grid
// (B, KV, splits) fills the card even at one KV head.  Each block walks only
// the live keys [max(0, len - window), min(len, S)) of its chunk -- a masked
// key adds exactly exp(-1e30 - m) = 0 once one key is valid -- and a block
// whose chunk holds none exits at once with an empty partial (m = -1e30,
// l = 0, its accumulator neither written nor read).  A row with no valid key
// (len <= 0, or a window past S) averages V uniformly over all S, as the
// -1e30 fill does in the reference: every split then sums its V rows with
// weight 1 (score 0) and reads no K.
//
// Inside a block, 32-key tiles of K and V land in shared memory in their
// storage type through a two-stage cp.async ring, so the next tile loads
// while this one is used; K and V rows are padded by 16 bytes so that rows
// read at one column hit distinct banks.  The G query heads of the KV head
// share each tile, by one of two routes:
//
// * CUDA cores (fp32; bf16 with G > 16 or D = 32).  Each warp owns up to
//   four heads with q (pre-scaled, fp32) in shared memory, and each lane
//   scores one key of the tile -- a dot product in registers, four partial
//   sums, no shuffle per key.  Then one max and one sum over the warp per
//   tile, and the lanes split the head dim for P V, widening each V row in
//   registers.  P stays fp32, as in the TPU kernel.
// * Tensor cores (bf16, G <= 16, D >= 64): `mma.sync.m16n8k16` with the G
//   heads as the 16 rows (padded with zeros).  Every one of the four warps
//   computes S = q K^T for the whole tile (q unscaled in bf16, exact; the
//   scale is applied to S in fp32), the softmax runs on the C fragments
//   (quad shuffles per row), and each warp multiplies P by its quarter of
//   V's columns.  P is split into two bf16 terms, hi + lo, so that P V keeps
//   ~16 bits of P where one bf16 rounding would keep 8.
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

constexpr int kTile = 32;  // keys per tile: one per lane

// Bytes of one ring stage: a tile's K and V rows, padded.  A block's shared
// memory: two stages, q (q_bytes), each warp's P, and with splits the
// combine's weights.
__host__ __device__ __forceinline__ int stage_bytes(int d, int es) {
  return kTile * 2 * (d * es + kPad);
}

template <typename T, int D, bool MMA>
__global__ void __launch_bounds__(kMaxWarps * 32)
    decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const int* __restrict__ lengths, T* __restrict__ out, float* ws, int* counters,
                  int num_heads, int num_kv, int head_dim, int seq_len, int chunk,
                  long long stride_b, long long stride_s, long long stride_h, int window,
                  float scale) {
  constexpr int ES = (int)sizeof(T);
  constexpr int VN = 16 / ES;            // elements per 16-byte copy
  constexpr int CPR = D / VN;            // 16-byte copies per row
  constexpr int ROW = D * ES + kPad;     // bytes per K or V row in shared memory
  constexpr int PITCH = ROW / ES;        // the same, in elements
  constexpr int STAGE = kTile * 2 * ROW;
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

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* q_raw = smem + kStages * STAGE;
  float* q_s = reinterpret_cast<float*>(q_raw);                    // CUDA cores: (group, D)
  bf16* q_b = reinterpret_cast<bf16*>(q_raw);                      // tensor cores: (16, D + 8)
  float* p_all = reinterpret_cast<float*>(q_raw + q_bytes(group, D));
  float* p_s = p_all + warp * (kMaxHeadsPerWarp * kTile);          // this warp's P
  float* comb = p_all + nwarps * (kMaxHeadsPerWarp * kTile);       // (group, splits + 1)

  // the live key range; empty -> the uniform average over all S
  const int length = lengths[b];
  int lo = 0;
  int hi = length < seq_len ? length : seq_len;
  if (window > 0 && length - window > 0) lo = length - window;
  const bool uniform = lo >= hi;
  if (uniform) {
    lo = 0;
    hi = seq_len;
  }
  // this block's part of it
  const int c0 = split * chunk;
  const int t_lo = lo > c0 ? lo : c0;
  const int t_hi = hi < c0 + chunk ? hi : c0 + chunk;
  const int ntiles = t_hi > t_lo ? (t_hi - t_lo + kTile - 1) / kTile : 0;
  auto tile_keys = [&](int i) {
    const int left = t_hi - (t_lo + i * kTile);
    return left < kTile ? left : kTile;
  };

  const long long base = (long long)b * stride_b + (long long)kvh * stride_h;
  auto load_tile = [&](int i) {
    if (i < ntiles) {
      const int t0 = t_lo + i * kTile;
      // the tensor cores read every row of the tile: zeros past the keys
      const int n = MMA ? kTile : tile_keys(i);
      const int keys = tile_keys(i);
      unsigned char* st = smem + (i % kStages) * STAGE;
#pragma unroll 4
      for (int x = tid; x < n * CPR; x += nthreads) {
        const int t = x / CPR;
        const int c = x - t * CPR;
        const long long row = base + (long long)(t0 + (t < keys ? t : 0)) * stride_s;
        const bool in = t < keys && c * VN < head_dim;  // zeros past head_dim
        const long long off = in ? row + c * VN : row;
        if (!uniform) cp_async<16>(st + t * ROW + c * 16, k + off, in ? 16 : 0);
        cp_async<16>(st + (kTile + t) * ROW + c * 16, v + off, in ? 16 : 0);
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
    const T* qb = q + ((long long)b * num_heads + (long long)kvh * group) * head_dim;
    if constexpr (MMA)
      load_q<T, bf16, D + 8>(qb, q_b, group, kMmaRows, head_dim, [](T x) { return x; });
    else
      load_q<T, float, D>(qb, q_s, group, group, head_dim,
                          [scale](T x) { return to_float(x) * scale; });
  }
  for (int i = 0; i < ntiles; ++i) {
    load_tile(i + 1);
    cp_async_wait<1>();  // tile i has landed
    __syncthreads();                // for every warp (and q with it)
    const unsigned char* st = smem + (i % kStages) * STAGE;
    const int n = tile_keys(i);

    if constexpr (MMA) {
      const bf16* kt = reinterpret_cast<const bf16*>(st);
      const bf16* vt = reinterpret_cast<const bf16*>(st + kTile * ROW);
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
          load_b<PITCH>(bk, kt, 0, kk * 16, lane);
          mma16816(s[0], a, bk[0], bk[1]);
          mma16816(s[1], a, bk[2], bk[3]);
          load_b<PITCH>(bk, kt, 16, kk * 16, lane);
          mma16816(s[2], a, bk[0], bk[1]);
          mma16816(s[3], a, bk[2], bk[3]);
        }
      }
      // the softmax on the fragments: rows gq (e < 2) and gq + 8, keys
      // 8j + 2cq + (e & 1); masked keys -1e30, weight 0
      float mt[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool live = 8 * j + 2 * cq + (e & 1) < n;
          s[j][e] = live ? s[j][e] * scale : kNegInf;  // uniform rows: score 0
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
          const bool live = 8 * j + 2 * cq + (e & 1) < n;
          s[j][e] = live ? expf(s[j][e] - mr[e >> 1]) : 0.f;
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
      // O += P V over this warp's columns, P as hi + lo bf16 terms
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
    } else {
      const T* vt = reinterpret_cast<const T*>(st + kTile * ROW);
      // scores: lane t against key t of the tile, for each of the warp's
      // heads, in four partial sums each
      float s[kMaxHeadsPerWarp][4];
#pragma unroll
      for (int h = 0; h < kMaxHeadsPerWarp; ++h)
#pragma unroll
        for (int r = 0; r < 4; ++r) s[h][r] = 0.f;
      if (!uniform && lane < n) {
        const T* krow = reinterpret_cast<const T*>(st + lane * ROW);
#pragma unroll 2
        for (int c = 0; c < CPR; ++c) {
          float kf[VN];
          load_floats<T, VN>(krow + c * VN, kf);
#pragma unroll
          for (int h = 0; h < kMaxHeadsPerWarp; ++h) {
            if (warp + h * nwarps >= group) break;  // uniform across the warp
            float qf[VN];
            load_floats<float, VN>(q_s + (warp + h * nwarps) * D + c * VN, qf);
#pragma unroll
            for (int e = 0; e < VN; ++e) s[h][e & 3] = fmaf(qf[e], kf[e], s[h][e & 3]);
          }
        }
      }
      float alpha[kMaxHeadsPerWarp];
#pragma unroll
      for (int h = 0; h < kMaxHeadsPerWarp; ++h) alpha[h] = 1.f;
#pragma unroll
      for (int h = 0; h < kMaxHeadsPerWarp; ++h) {
        if (warp + h * nwarps >= group) break;
        const float sc = lane < n ? (s[h][0] + s[h][1]) + (s[h][2] + s[h][3]) : kNegInf;
        const float m_new = fmaxf(m[h], warp_max(sc));
        alpha[h] = expf(m[h] - m_new);
        const float p = lane < n ? expf(sc - m_new) : 0.f;
        l[h] = l[h] * alpha[h] + warp_sum(p);
        m[h] = m_new;
        p_s[h * kTile + lane] = p;
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
        load_floats<T, EPL>(vt + t * PITCH + lane * EPL, vf);
#pragma unroll
        for (int h = 0; h < kMaxHeadsPerWarp; ++h) {
          if (warp + h * nwarps >= group) break;
          const float p = p_s[h * kTile + t];
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
  T* ob = out + ((long long)b * num_heads + (long long)kvh * group) * head_dim;
  float* ws_ml = ws + rows * splits * group * D;
  const long long part0 = (rowkv * splits + split) * group;
  if constexpr (MMA) {
    const int gq = lane >> 2;
    const int col0 = warp * (D / 4) + 2 * (lane & 3);
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
            const int col = col0 + 8 * j + e;
            if (col < head_dim) store(o[j][2 * r + e] / denom, ob + g * head_dim + col);
          }
        continue;
      }
      if (warp == 0 && (lane & 3) == 0) {
        const float ml[2] = {mr[r], lr[r]};
        store_cg<2>(ml, ws_ml + (part0 + g) * 2);
      }
      if (lr[r] > 0.f) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float x[2] = {o[j][2 * r], o[j][2 * r + 1]};
          store_cg<2>(x, ws + (part0 + g) * D + col0 + 8 * j);
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
    merge<T, D>(ws, counters, ob, comb, rows, rowkv, splits, group, head_dim);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* lengths;
  void* out;
  void* ws;
  void* counters;
  int batch, num_heads, num_kv, head_dim, seq_len, splits, chunk, mma;
  long long stride_b, stride_s, stride_h;
  int window;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D, bool MMA>
int launch(const Args& a) {
  const int group = a.num_heads / a.num_kv;
  int nwarps = (group + kMaxHeadsPerWarp - 1) / kMaxHeadsPerWarp;
  if (nwarps < kMinWarps || MMA) nwarps = kMinWarps;  // tensor cores: a quarter of D each
  if (nwarps > kMaxWarps || (MMA && group > kMmaRows)) return (int)cudaErrorInvalidValue;
  if (a.splits < 1 || a.splits > kMaxSplits || a.chunk < 1 || (long long)(a.splits - 1) * a.chunk >= a.seq_len ||
      (long long)a.splits * a.chunk < a.seq_len ||
      (a.splits > 1 && (a.ws == nullptr || a.counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)kStages * stage_bytes(D, (int)sizeof(T)) + q_bytes(group, D) +
      sizeof(float) * ((size_t)nwarps * kMaxHeadsPerWarp * kTile +
                       (a.splits > 1 ? (size_t)group * (a.splits + 1) : 0));
  auto kernel = decode_kernel<T, D, MMA>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3(a.batch, a.num_kv, a.splits), nwarps * 32, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const int*>(a.lengths), static_cast<T*>(a.out), static_cast<float*>(a.ws),
      static_cast<int*>(a.counters), a.num_heads, a.num_kv, a.head_dim, a.seq_len, a.chunk,
      a.stride_b, a.stride_s, a.stride_h, a.window, a.scale);
  return (int)cudaGetLastError();
}

// The instance for head_dim: the next of 32, 64, 128, 256 (any multiple
// of 8 up to 256); the tensor cores take bf16 at 64 and up.
template <typename T, int D>
int dispatch_route(const Args& a) {
  if constexpr (std::is_same<T, bf16>::value && D >= 64) {
    if (a.mma) return launch<T, D, true>(a);
  }
  if (a.mma) return (int)cudaErrorInvalidValue;
  return launch<T, D, false>(a);
}

template <typename T>
int dispatch_head_dim(int head_dim, const Args& a) {
  if (head_dim < 8 || head_dim > 256 || head_dim % 8) return (int)cudaErrorInvalidValue;
  if (head_dim <= 32) return dispatch_route<T, 32>(a);
  if (head_dim <= 64) return dispatch_route<T, 64>(a);
  if (head_dim <= 128) return dispatch_route<T, 128>(a);
  return dispatch_route<T, 256>(a);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out).  Strides of k and v
// (equal) are in elements; their last (head_dim) stride must be 1.
// head_dim: a multiple of 8 up to 256.  window <= 0 means none.  The key
// axis is cut into `splits` chunks of `chunk` keys, (splits - 1) * chunk <
// seq_len <= splits * chunk; `mma` != 0 takes the tensor cores (bf16, G <= 16,
// head_dim > 32).  With splits > 1, `ws` holds B * KV * splits * G *
// (Dp + 2) floats (Dp: head_dim's instance) and `counters` B * KV int32
// zeros, left zero.  Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* lengths, void* out, void* ws, void* counters,
                                int dtype, int batch, int num_heads, int num_kv, int head_dim,
                                int seq_len, int splits, int chunk, int mma,
                                long long stride_b, long long stride_s, long long stride_h,
                                int window, float scale, void* stream) {
  const Args a{q,      k,        v,        lengths,  out,    ws,     counters, batch,
               num_heads, num_kv, head_dim, seq_len, splits, chunk,  mma,      stride_b,
               stride_s, stride_h, window,  scale,    static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch_head_dim<float>(head_dim, a);
  if (dtype == 1) return dispatch_head_dim<bf16>(head_dim, a);
  return (int)cudaErrorInvalidValue;
}
