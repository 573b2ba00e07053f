// Flash attention for Hopper (sm_90a): the forward and its backward, with a
// plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention` in
// src/repro/kernels/flash_attention.py (pallas_call at :108): causal,
// windowed, softcapped GQA attention over a full sequence, query row i at
// key position i.  The TPU kernel is forward only (the JAX trainer takes
// its gradient by autodiff of plain `attend`); on the card the gradient is
// on the training path too, so this file also holds the backward.
//
//   q        (B, H, S, D)    fp32 or bf16, read by strides
//   k, v     (B, KV, S, D)   q's dtype, read by strides
//   o        (B, H, S, D)    q's dtype, written by strides
//   lse      (B, H, S) fp32  per-row log-sum-exp of the masked scores
//   do       (B, H, S, D)    the output's gradient, by strides
//   dq/dk/dv                 the inputs' dtypes and shapes, by strides
//   delta    (B, H, S) fp32  scratch: rowsum(dO * O)
//
// Every tensor is addressed by its (batch, head, sequence) strides; the
// head_dim axis must be contiguous and 16-byte aligned.  So the trainer's
// projections, laid out (B, S, H, D), are read and written in place: no
// transposed copies.
//
// Semantics are those of the TPU kernel and of the plain version
// (kernels/ref.py): scores in fp32 with 1/sqrt(D) applied to q, the tanh
// softcap before the mask, masked scores -1e30, an online softmax from
// m = -1e30, l = 0, output acc / max(l, 1e-30).  Keys past S (the ragged
// last tile) are -inf: they never count.  Any S is accepted.
//
// Design.  The TPU grid (B, H, q tiles, k tiles) ran its k axis in order
// and kept (m, l, acc) in scratch across it; here a thread block owns a
// (batch, KV head, 64-row query tile) and loops over the key tiles itself,
// only from the window's start to the causal limit (the TPU kernel's tile
// pruning, :38-51: a tile wholly outside the mask is never loaded).  Each
// 32-key K/V tile is loaded into shared memory once for all G query heads
// of the group; 128 threads per query head keep that head's (64, D) fp32
// accumulator in registers (D/2 values each) and a 4x4 block of scores.
// The backward is two kernels and no atomics, so it is deterministic: a
// dK/dV kernel per (batch, KV head, 64-key tile) that loops over the query
// tiles that can see it and over the G heads (the GQA sum autodiff of
// `attend` performs), and a dQ kernel per (batch, head, 64-row query tile)
// that loops over key tiles.  P is recomputed from lse; a third, tiny
// kernel computes delta = rowsum(dO * O) first.
//
// Bound.  At the trainer's shape (B=8, H=16, KV=8, S=512, D=128) the causal
// forward does ~8.6 GFLOP against ~50 MB of q/k/v/o: ~170 flops per byte,
// below the ~295 at which bf16 tensor cores become the limit, so its
// roofline bound is the bytes (~15 us; the operations take ~9 us at
// 989 TFLOP/s).  This first version computes with fp32 FMAs on the CUDA
// cores from shared memory (67 TFLOP/s peak, and about half a shared load
// per FMA), so it is bound by operations, ~130 us at best.  What the design
// does about it: it skips every tile outside the mask (half the work under
// causality) and reuses each K/V tile across G heads from shared memory.
// mma.sync/wgmma, TMA and warp specialisation are the later work that
// moves it toward the bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
// forward
constexpr int kBQ = 64;             // query rows per head per block
constexpr int kBK = 32;             // keys per tile
constexpr int kHeadThreads = 128;   // threads per query head
// backward
constexpr int kBwdThreads = 256;
constexpr int kKvBK = 64;           // dK/dV kernel: keys per block
constexpr int kKvBQ = 32;           // dK/dV kernel: queries per tile
constexpr int kDqBQ = 64;           // dQ kernel: queries per block
constexpr int kDqBK = 32;           // dQ kernel: keys per tile

struct Strides {
  long long b, h, s;   // elements; the head_dim stride is 1
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void store(float x, __nv_bfloat16* dst) { *dst = __float2bfloat16(x); }

// One 16-byte vector of T, widened to floats.
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* src, float* dst) {
    const float4 x = *reinterpret_cast<const float4*>(src);
    dst[0] = x.x;
    dst[1] = x.y;
    dst[2] = x.z;
    dst[3] = x.w;
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* src, float* dst) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      dst[2 * i] = f.x;
      dst[2 * i + 1] = f.y;
    }
  }
};

// Rows [row0, row0 + rows) of one (batch, head) into a shared tile of
// row pitch D + 1 (no bank conflicts on column walks), times `mul`; rows
// at or past S are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* __restrict__ base, Strides st, int b, int head,
                                          int row0, int rows, int S, float mul, float* tile) {
  constexpr int VN = Vec16<T>::N;
  constexpr int VPR = D / VN;
  const T* p = base + b * st.b + head * st.h;
  for (int i = threadIdx.x; i < rows * VPR; i += blockDim.x) {
    const int r = i / VPR;
    const int c = (i - r * VPR) * VN;
    const int pos = row0 + r;
    float x[VN];
    if (pos < S) {
      Vec16<T>::load(p + pos * st.s + c, x);
    } else {
#pragma unroll
      for (int e = 0; e < VN; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VN; ++e) tile[r * (D + 1) + c + e] = x[e] * mul;
  }
}

// Whether query qpos sees key kpos (both < S).  window <= 0: none.
__device__ __forceinline__ bool visible(int qpos, int kpos, int causal, int window) {
  if (causal && kpos > qpos) return false;
  if (window > 0 && qpos - kpos >= window) return false;
  return true;
}

// The key range [lo, hi) a query tile [q0, q0 + rows) can see, lo rounded
// down to a tile of `bk`.
__device__ __forceinline__ void key_range(int q0, int rows, int S, int causal, int window, int bk,
                                          int* lo, int* hi) {
  int k_lo = 0, k_hi = S;
  if (causal) k_hi = min(S, q0 + rows);
  if (window > 0) k_lo = max(0, q0 - window + 1);
  *lo = (k_lo / bk) * bk;
  *hi = k_hi;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kHeadThreads * (512 / D))
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, float* __restrict__ lse, Strides sq, Strides sk,
                     Strides sv, Strides so, int H, int KV, int S, int causal, int window,
                     float scale, float softcap) {
  constexpr int LD = D + 1;
  constexpr int LDP = kBK + 1;
  constexpr int CPT = D / 8;  // accumulator columns per thread
  const int G = H / KV;
  const int q0 = blockIdx.x * kBQ;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int g = threadIdx.x / kHeadThreads;  // this thread's head in the group
  const int ht = threadIdx.x % kHeadThreads;
  const int tr = ht / 8;  // rows tr + 16 i
  const int tc = ht % 8;  // score columns tc + 8 j, accumulator columns tc + 8 c
  const int h = kvh * G + g;

  extern __shared__ float smem[];
  float* qs = smem;                   // G x (kBQ, LD): q * scale
  float* ks = qs + G * kBQ * LD;      // (kBK, LD)
  float* vs = ks + kBK * LD;          // (kBK, LD)
  float* ps = vs + kBK * LD;          // G x (kBQ, LDP): P of the tile
  const float* my_q = qs + g * kBQ * LD;
  float* my_p = ps + g * kBQ * LDP;

  for (int gg = 0; gg < G; ++gg)
    load_tile<T, D>(q, sq, b, kvh * G + gg, q0, kBQ, S, scale, qs + gg * kBQ * LD);

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  int k_lo, k_hi;
  key_range(q0, kBQ, S, causal, window, kBK, &k_lo, &k_hi);
  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
    __syncthreads();  // every head is done with the previous tile
    load_tile<T, D>(k, sk, b, kvh, k0, kBK, S, 1.f, ks);
    load_tile<T, D>(v, sv, b, kvh, k0, kBK, S, 1.f, vs);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = my_q[(tr + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = ks[(tc + 8 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = tr + 16 * i;
      const int qpos = q0 + row;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tc + 8 * j;
        float x = s[i][j];
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        if (kpos >= S) {
          x = -INFINITY;
        } else if (!visible(qpos, kpos, causal, window)) {
          x = kNegInf;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      // the 8 threads of a row are lanes of one warp
#pragma unroll
      for (int off = 4; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        my_p[row * LDP + tc + 8 * j] = p;
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();  // a row's P is read back only by the lanes that wrote it

#pragma unroll 4
    for (int t = 0; t < kBK; ++t) {
      float pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = my_p[(tr + 16 * i) * LDP + t];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float vb = vs[t * LD + tc + 8 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pa[i], vb, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + tr + 16 * i;
    if (qpos >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* op = o + b * so.b + h * so.h + qpos * so.s;
#pragma unroll
    for (int c = 0; c < CPT; ++c) store(acc[i][c] / denom, op + tc + 8 * c);
    if (tc == 0) lse[((long long)b * H + h) * S + qpos] = m[i] + logf(l[i]);
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// delta[b, h, s] = sum_d dO * O, one warp per row.
template <typename T, int D>
__global__ void flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                                       float* __restrict__ delta, Strides so, Strides sdo,
                                       int B, int H, int S) {
  const long long row = (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long long)B * H * S) return;
  const int s = (int)(row % S);
  const int h = (int)((row / S) % H);
  const int b = (int)(row / ((long long)S * H));
  const T* op = o + b * so.b + h * so.h + s * so.s;
  const T* dp = dout + b * sdo.b + h * sdo.h + s * sdo.s;
  float part = 0.f;
  for (int d = lane; d < D; d += 32) part += to_float(op[d]) * to_float(dp[d]);
  part = warp_sum(part);
  if (lane == 0) delta[row] = part;
}

// dK, dV for a (batch, KV head, 64-key tile), summed over the G heads.
template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, Strides sq, Strides sk,
                         Strides sv, Strides sdo, Strides sdk, Strides sdv, int H, int KV, int S,
                         int causal, int window, float scale, float softcap) {
  constexpr int LD = D + 1;
  constexpr int LDT = kKvBQ + 1;
  constexpr int CPT = D / 16;
  const int G = H / KV;
  const int k0 = blockIdx.x * kKvBK;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tk = threadIdx.x / 16;  // keys tk + 16 i
  const int tq = threadIdx.x % 16;  // queries tq + 16 j; accumulator columns tq + 16 c

  extern __shared__ float smem[];
  float* ks = smem;                   // (kKvBK, LD)
  float* vs = ks + kKvBK * LD;        // (kKvBK, LD)
  float* qs = vs + kKvBK * LD;        // (kKvBQ, LD): q * scale
  float* dos = qs + kKvBQ * LD;       // (kKvBQ, LD)
  float* pt = dos + kKvBQ * LD;       // (kKvBK, LDT): P^T
  float* dst = pt + kKvBK * LDT;      // (kKvBK, LDT): dS^T
  float* lse_s = dst + kKvBK * LDT;   // (kKvBQ,)
  float* delta_s = lse_s + kKvBQ;     // (kKvBQ,)

  load_tile<T, D>(k, sk, b, kvh, k0, kKvBK, S, 1.f, ks);
  load_tile<T, D>(v, sv, b, kvh, k0, kKvBK, S, 1.f, vs);

  float dk_acc[4][CPT], dv_acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  // the query tiles that see a key of this tile
  int q_lo = causal ? k0 : 0;
  int q_hi = S;
  if (window > 0) q_hi = min(S, k0 + kKvBK - 1 + window);
  q_lo = (q_lo / kKvBQ) * kKvBQ;

  for (int gg = 0; gg < G; ++gg) {
    const int h = kvh * G + gg;
    const float* lse_h = lse + ((long long)b * H + h) * S;
    const float* delta_h = delta + ((long long)b * H + h) * S;
    for (int q0 = q_lo; q0 < q_hi; q0 += kKvBQ) {
      __syncthreads();  // the previous tile's readers are done
      load_tile<T, D>(q, sq, b, h, q0, kKvBQ, S, scale, qs);
      load_tile<T, D>(dout, sdo, b, h, q0, kKvBQ, S, 1.f, dos);
      for (int r = threadIdx.x; r < kKvBQ; r += blockDim.x) {
        lse_s[r] = q0 + r < S ? lse_h[q0 + r] : 0.f;
        delta_s[r] = q0 + r < S ? delta_h[q0 + r] : 0.f;
      }
      __syncthreads();

      float st[4][2], dpt[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        float ka[4], va[4], qb[2], ob[2];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ka[i] = ks[(tk + 16 * i) * LD + d];
          va[i] = vs[(tk + 16 * i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          qb[j] = qs[(tq + 16 * j) * LD + d];
          ob[j] = dos[(tq + 16 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            st[i][j] = fmaf(ka[i], qb[j], st[i][j]);
            dpt[i][j] = fmaf(va[i], ob[j], dpt[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kpos = k0 + tk + 16 * i;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int qrow = tq + 16 * j;
          const int qpos = q0 + qrow;
          float p = 0.f, ds = 0.f;
          if (kpos < S && qpos < S && visible(qpos, kpos, causal, window)) {
            float x = st[i][j];
            float th = 0.f;
            if (softcap > 0.f) {
              th = tanhf(x / softcap);
              x = softcap * th;
            }
            p = expf(x - lse_s[qrow]);
            ds = p * (dpt[i][j] - delta_s[qrow]);
            if (softcap > 0.f) ds *= 1.f - th * th;
          }
          pt[(tk + 16 * i) * LDT + qrow] = p;
          dst[(tk + 16 * i) * LDT + qrow] = ds;
        }
      }
      __syncwarp();  // a key row's P^T and dS^T are read back by the lanes that wrote them

#pragma unroll 4
      for (int t = 0; t < kKvBQ; ++t) {
        float pa[4], da[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pa[i] = pt[(tk + 16 * i) * LDT + t];
          da[i] = dst[(tk + 16 * i) * LDT + t];
        }
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const float ob = dos[t * LD + tq + 16 * c];
          const float qb = qs[t * LD + tq + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv_acc[i][c] = fmaf(pa[i], ob, dv_acc[i][c]);
            dk_acc[i][c] = fmaf(da[i], qb, dk_acc[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + tk + 16 * i;
    if (kpos >= S) continue;
    T* dkp = dk + b * sdk.b + kvh * sdk.h + kpos * sdk.s;
    T* dvp = dv + b * sdv.b + kvh * sdv.h + kpos * sdv.s;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      store(dk_acc[i][c], dkp + tq + 16 * c);  // q was stored pre-scaled
      store(dv_acc[i][c], dvp + tq + 16 * c);
    }
  }
}

// dQ for a (batch, head, 64-row query tile).
template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        T* __restrict__ dq, Strides sq, Strides sk, Strides sv, Strides sdo,
                        Strides sdq, int H, int KV, int S, int causal, int window, float scale,
                        float softcap) {
  constexpr int LD = D + 1;
  constexpr int LDS = kDqBK + 1;
  constexpr int CPT = D / 16;
  const int G = H / KV;
  const int q0 = blockIdx.x * kDqBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / G;
  const int tr = threadIdx.x / 16;  // rows tr + 16 i
  const int tc = threadIdx.x % 16;  // keys tc + 16 j; accumulator columns tc + 16 c

  extern __shared__ float smem[];
  float* qs = smem;                   // (kDqBQ, LD): q * scale
  float* dos = qs + kDqBQ * LD;       // (kDqBQ, LD)
  float* ks = dos + kDqBQ * LD;       // (kDqBK, LD)
  float* vs = ks + kDqBK * LD;        // (kDqBK, LD)
  float* dss = vs + kDqBK * LD;       // (kDqBQ, LDS): dS
  float* lse_s = dss + kDqBQ * LDS;   // (kDqBQ,)
  float* delta_s = lse_s + kDqBQ;     // (kDqBQ,)

  load_tile<T, D>(q, sq, b, h, q0, kDqBQ, S, scale, qs);
  load_tile<T, D>(dout, sdo, b, h, q0, kDqBQ, S, 1.f, dos);
  const float* lse_h = lse + ((long long)b * H + h) * S;
  const float* delta_h = delta + ((long long)b * H + h) * S;
  for (int r = threadIdx.x; r < kDqBQ; r += blockDim.x) {
    lse_s[r] = q0 + r < S ? lse_h[q0 + r] : 0.f;
    delta_s[r] = q0 + r < S ? delta_h[q0 + r] : 0.f;
  }

  float dq_acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) dq_acc[i][c] = 0.f;

  int k_lo, k_hi;
  key_range(q0, kDqBQ, S, causal, window, kDqBK, &k_lo, &k_hi);
  for (int k0 = k_lo; k0 < k_hi; k0 += kDqBK) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(k, sk, b, kvh, k0, kDqBK, S, 1.f, ks);
    load_tile<T, D>(v, sv, b, kvh, k0, kDqBK, S, 1.f, vs);
    __syncthreads();

    float s[4][2], dp[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[4], oa[4], kb[2], vb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qa[i] = qs[(tr + 16 * i) * LD + d];
        oa[i] = dos[(tr + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        kb[j] = ks[(tc + 16 * j) * LD + d];
        vb[j] = vs[(tc + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
          dp[i][j] = fmaf(oa[i], vb[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = tr + 16 * i;
      const int qpos = q0 + row;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kpos = k0 + tc + 16 * j;
        float ds = 0.f;
        if (kpos < S && qpos < S && visible(qpos, kpos, causal, window)) {
          float x = s[i][j];
          float th = 0.f;
          if (softcap > 0.f) {
            th = tanhf(x / softcap);
            x = softcap * th;
          }
          const float p = expf(x - lse_s[row]);
          ds = p * (dp[i][j] - delta_s[row]);
          if (softcap > 0.f) ds *= 1.f - th * th;
        }
        dss[row * LDS + tc + 16 * j] = ds;
      }
    }
    __syncwarp();  // a row's dS is read back by the lanes that wrote it

#pragma unroll 4
    for (int t = 0; t < kDqBK; ++t) {
      float da[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) da[i] = dss[(tr + 16 * i) * LDS + t];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float kb = ks[t * LD + tc + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) dq_acc[i][c] = fmaf(da[i], kb, dq_acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + tr + 16 * i;
    if (qpos >= S) continue;
    T* dqp = dq + b * sdq.b + h * sdq.h + qpos * sdq.s;
#pragma unroll
    for (int c = 0; c < CPT; ++c) store(dq_acc[i][c] * scale, dqp + tc + 16 * c);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *o, *dout;
  void *out, *lse, *dq, *dk, *dv, *delta;
  int B, H, KV, S, causal, window;
  float scale, softcap;
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  cudaStream_t stream;
};

template <typename K>
int set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

template <typename T, int D>
int launch_fwd(const Args& a) {
  const int G = a.H / a.KV;
  if (G * D > 512) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)G * kBQ * (D + 1) + 2 * kBK * (D + 1) +
                                       (size_t)G * kBQ * (kBK + 1));
  auto kernel = flash_fwd_kernel<T, D>;
  int err = set_smem(kernel, smem);
  if (err) return err;
  kernel<<<dim3(cdiv(a.S, kBQ), a.KV, a.B), G * kHeadThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.out), static_cast<float*>(a.lse), a.sq, a.sk, a.sv, a.so, a.H, a.KV,
      a.S, a.causal, a.window, a.scale, a.softcap);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_bwd(const Args& a) {
  const long long rows = (long long)a.B * a.H * a.S;
  flash_bwd_delta_kernel<T, D><<<(unsigned)((rows + 7) / 8), 256, 0, a.stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), static_cast<float*>(a.delta),
      a.so, a.sdo, a.B, a.H, a.S);
  int err = (int)cudaGetLastError();
  if (err) return err;

  const size_t smem_kv = sizeof(float) * (2 * kKvBK * (D + 1) + 2 * kKvBQ * (D + 1) +
                                          2 * kKvBK * (kKvBQ + 1) + 2 * kKvBQ);
  auto kv_kernel = flash_bwd_dkv_kernel<T, D>;
  if ((err = set_smem(kv_kernel, smem_kv))) return err;
  kv_kernel<<<dim3(cdiv(a.S, kKvBK), a.KV, a.B), kBwdThreads, smem_kv, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.sq,
      a.sk, a.sv, a.sdo, a.sdk, a.sdv, a.H, a.KV, a.S, a.causal, a.window, a.scale,
      a.softcap);
  if ((err = (int)cudaGetLastError())) return err;

  const size_t smem_q = sizeof(float) * (2 * kDqBQ * (D + 1) + 2 * kDqBK * (D + 1) +
                                         kDqBQ * (kDqBK + 1) + 2 * kDqBQ);
  auto q_kernel = flash_bwd_dq_kernel<T, D>;
  if ((err = set_smem(q_kernel, smem_q))) return err;
  q_kernel<<<dim3(cdiv(a.S, kDqBQ), a.H, a.B), kBwdThreads, smem_q, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.dq), a.sq, a.sk, a.sv, a.sdo,
      a.sdq, a.H, a.KV, a.S, a.causal, a.window, a.scale, a.softcap);
  return (int)cudaGetLastError();
}

template <bool BWD, typename T>
int dispatch_head_dim(int head_dim, const Args& a) {
  switch (head_dim) {
    case 64:
      return BWD ? launch_bwd<T, 64>(a) : launch_fwd<T, 64>(a);
    case 128:
      return BWD ? launch_bwd<T, 128>(a) : launch_fwd<T, 128>(a);
    case 256:
      return BWD ? launch_bwd<T, 256>(a) : launch_fwd<T, 256>(a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <bool BWD>
int dispatch(int dtype, int head_dim, const Args& a) {
  if (dtype == 0) return dispatch_head_dim<BWD, float>(head_dim, a);
  if (dtype == 1) return dispatch_head_dim<BWD, __nv_bfloat16>(head_dim, a);
  return (int)cudaErrorInvalidValue;
}

Strides strides_at(const long long* s, int i) { return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]}; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (every tensor but lse/delta).
// strides: (batch, head, sequence) element strides, three per tensor, in
// the order q, k, v, o.  window <= 0 means none, softcap <= 0 none.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int dtype, int B, int H, int KV, int S,
                                   int head_dim, const long long* strides, int causal,
                                   int window, float scale, float softcap, void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = o;
  a.lse = lse;
  a.B = B;
  a.H = H;
  a.KV = KV;
  a.S = S;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  a.softcap = softcap;
  a.sq = strides_at(strides, 0);
  a.sk = strides_at(strides, 1);
  a.sv = strides_at(strides, 2);
  a.so = strides_at(strides, 3);
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch<false>(dtype, head_dim, a);
}

// Three launches: delta, dK/dV, dQ.  strides: three per tensor in the
// order q, k, v, o, do, dq, dk, dv.  delta: (B, H, S) fp32 scratch.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* lse, const void* dout, void* dq, void* dk,
                                   void* dv, void* delta, int dtype, int B, int H, int KV, int S,
                                   int head_dim, const long long* strides, int causal,
                                   int window, float scale, float softcap, void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.lse = const_cast<void*>(lse);
  a.dout = dout;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.delta = delta;
  a.B = B;
  a.H = H;
  a.KV = KV;
  a.S = S;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  a.softcap = softcap;
  a.sq = strides_at(strides, 0);
  a.sk = strides_at(strides, 1);
  a.sv = strides_at(strides, 2);
  a.so = strides_at(strides, 3);
  a.sdo = strides_at(strides, 4);
  a.sdq = strides_at(strides, 5);
  a.sdk = strides_at(strides, 6);
  a.sdv = strides_at(strides, 7);
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch<true>(dtype, head_dim, a);
}
