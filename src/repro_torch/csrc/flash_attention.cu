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
// transposed copies.  head_dim is any multiple of 8 up to 256: each kernel
// is instantiated at the next of 64, 128, 256 and takes the true head_dim
// at run time; loads past it read zeros and stores past it are masked.
//
// Semantics are those of the TPU kernel and of the plain version
// (kernels/ref.py): scores in fp32 scaled by 1/sqrt(D), the tanh softcap
// before the mask, masked scores -1e30, an online softmax from m = -1e30,
// l = 0, output acc / max(l, 1e-30).  Keys past S (the ragged last tile)
// are -inf: they never count.  Any S is accepted.  Every route visits only
// the key tiles from the window's start to the causal diagonal (the TPU
// kernel's tile pruning, :38-51), and the backward is two kernels with no
// atomics (dK/dV per key tile, dQ per query tile), so it is deterministic.
//
// Bound.  At the trainer's shape (B=8, H=16, KV=8, S=512, D=128, bf16) the
// causal forward does ~8.6 GFLOP against ~50 MB of q/k/v/o: ~170 flops per
// byte, below the ~295 at which bf16 tensor cores become the limit, so its
// roofline bound is the bytes (~15 us; the operations take ~9 us at
// 989 TFLOP/s).  Seamless' encoder (B=16, H=KV=16, S=1024, D=64, not
// causal) is the other way round: 6.9e10 flops against 0.13 GB, ~500 flops
// per byte, bound by the operations (~70 us forward).  The backward
// recomputes S and dP in both of its product kernels: 14 D flops per
// visible pair instead of 10 D, the price of determinism without atomics.
//
// Routes, by the wrapper's choice (kernels/flash_attention.py: `route`,
// from the dtype, `causal` and the head_dim instance alone; `dispatch`
// refuses inputs that are not the route's own):
//
// * bf16, causal=False, head_dim up to 128: `wgmma` and TMA
//   (flash_attention_sm90.cuh, whose note has the design): one block per
//   192 query rows at D = 64 (128 at D = 128) in the forward, 128 query
//   rows in dQ, 128 keys in dK/dV; consumer warpgroups of 64 rows and a
//   producer warpgroup keeping a ring of 64-row tiles in flight with TMA
//   and mbarriers; S on `wgmma` with both operands in shared memory, P
//   rounded to bf16 in registers as the A operand of the next `wgmma`.
//   The shapes this route runs are bound by the operations, where this
//   file's `mma.sync` kernels (~2/3 of wgmma's rate, 64-row blocks that
//   re-read K and V 16 times per head at S = 1,024) lost 3x to SDPA.
// * bf16, causal (and non-causal head_dim 256, which no path runs):
//   `mma.sync.m16n8k16` (bf16 in, fp32 accumulate) through inline PTX,
//   operands brought from shared memory by `ldmatrix` (`.trans` where the
//   product needs the tile's transpose).  The causal shapes the trainer
//   runs are bound by bytes, where mma.sync's rate already puts the
//   operations under that bound; what matters is keeping the tensor cores
//   fed.
//   Forward: one block of 4 warps per (query head, batch, query tile of 64
//   rows), 16 rows per warp.  Q is staged once in shared memory and its
//   fragments re-read by ldmatrix for each key tile; K and V tiles of 32
//   keys stream through a 2-stage cp.async ring (`src-size` 0 zero-fills
//   the head_dim tail and rows past S); rows are padded by 16 bytes so
//   that ldmatrix meets no bank conflicts.  (On the card, at the trainer's
//   shape, this shape ran faster than 128-row blocks of 4 warps x 32 rows,
//   which spill, than 8 warps, than 64-key tiles, and no slower than Q's
//   fragments held in registers, which spill at D = 256.)  S = Q K^T
//   accumulates in fp32 fragments; scale, softcap, mask and the online
//   softmax run on the fragments (quad shuffles for the row max; the row
//   sum is reduced once, at the end); P is rounded to bf16 in registers and
//   fed straight back as the A operand of O += P V (the m16n8 accumulator
//   layout is the m16n8k16 A layout), as the TPU kernel casts P to v.dtype
//   (:82).  Only tiles that cut the diagonal, the window edge or S pay for
//   element masks, and a warp skips a tile that none of its rows can see.
//   A block holds one query head, so G x D is unbounded; blockIdx.x is the
//   head, so the G heads of a KV group are neighbouring blocks and share
//   K/V through L2, and the heaviest query tiles (the latest, under
//   causality) launch first.
//   Backward: a dK/dV kernel per (KV head, batch, key tile of 64; D = 256
//   splits the output columns over two blocks), 4 warps of 16 keys, K and
//   V staged once, Q, dO, lse and delta streaming through the ring over
//   the G heads and the query tiles that see the tile: per step
//   dP^T = V dO^T, S^T = K Q^T, P^T = exp(S^T - lse), dS^T = P^T (dP^T -
//   delta) (x (1 - t^2) under a softcap), dV += P^T dO, dK += dS^T Q.  A dQ
//   kernel per (head, batch, query tile of 64): S, dP, dS as above and
//   dQ += dS K over key tiles of 32.  P and dS are rounded to bf16 as MMA
//   operands; the accumulators stay fp32.
// * fp32: error-compensated TF32 ("3xTF32") on `mma.sync.m16n8k8`: each
//   fp32 operand split into hi + lo TF32 parts, each product three MMAs
//   (the fp32 section below has the design).  The fp32 CUDA cores peak at
//   67 TFLOP/s, TF32 tensor cores at 495: with three MMAs a product the
//   bound of fp32-exact products is 165, which Seamless' encoder shape
//   meets in the operations.  The blocks are the bf16 route's (one query
//   head per block, any group size), tiles stream through a cp.async ring,
//   dK/dV cuts each key tile's (query head, query tile) steps into even
//   parts over the grid (fp32 partials summed in a fixed order), and from
//   D = 128 the backward runs warp pairs.
//
// A small kernel computes delta = rowsum(dO * O) first, on every route (on
// the wgmma route it also writes lse * log2 e, padded, beside it).

#include <cuda.h>   // CUtensorMap; the encoder is reached through the runtime (no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, h, s;   // elements; the head_dim stride is 1
};

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

// 16 bytes of T widened to floats: N of them.
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
struct Vec16<bf16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const bf16* src, float* dst) {
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

// delta[b, h, s] = sum_d dO * O (both routes): a group of 16 lanes per row,
// 16-byte loads (head_dim is a multiple of 8, rows 16-byte aligned).
template <typename T>
__global__ void flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                                       float* __restrict__ delta, Strides so, Strides sdo,
                                       int B, int H, int S, int dh) {
  constexpr int VN = Vec16<T>::N;
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 16;   // 32-bit: B H S < 2^31
  const int sub = threadIdx.x % 16;
  const bool live = row < B * H * S;
  float part = 0.f;
  if (live) {
    const int s = row % S;
    const int h = (row / S) % H;
    const int b = row / (S * H);
    const T* op = o + b * so.b + h * so.h + s * so.s;
    const T* dp = dout + b * sdo.b + h * sdo.h + s * sdo.s;
    for (int c = sub * VN; c < dh; c += 16 * VN) {
      float x[VN], y[VN];
      Vec16<T>::load(op + c, x);
      Vec16<T>::load(dp + c, y);
#pragma unroll
      for (int e = 0; e < VN; ++e) part += x[e] * y[e];
    }
  }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
  if (live && sub == 0) delta[row] = part;
}

// ===========================================================================
// bf16 route: tensor cores (mma.sync m16n8k16, ldmatrix, cp.async)
// ===========================================================================

// Block shapes (see the note at the top): every bf16 kernel runs 4 warps,
// each warp 16 query rows (forward, dQ) or 16 keys (dK/dV); the tiles that
// stream through the ring are 32 keys (forward, dQ) or 64 queries (dK/dV).
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kFwdBK = 32;
constexpr int kDqKeyTile = 32;
constexpr int kDkvQueryTile = 64;
// dK/dV blocks per key tile: at D = 256 two, each with half the output
// columns, so that both accumulators fit in registers
__host__ __device__ constexpr int dkv_split(int d) { return d <= 128 ? 1 : 2; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zeros when !ok (src-size 0 reads nothing).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0));
}

// 4 bytes global -> shared; zero when !ok.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices from shared memory; lane i gives the address of
// row i % 8 of matrix i / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c (16x8 fp32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as a bf16x2 register, lo in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Fragment addressing (m16n8k16; lane = 4 * g + c, g = lane / 4, c = lane % 4):
//   A 16x16: a0 (g, 2c..), a1 (g + 8, 2c..), a2 (g, 2c + 8..), a3 (g + 8, 2c + 8..)
//   B 16x8:  b0 (k 2c.., n g), b1 (k 2c + 8.., n g)
//   C 16x8:  c0, c1 (g, 2c..); c2, c3 (g + 8, 2c..)
// So a C fragment pair (n tiles 2j, 2j + 1), rounded to bf16, is the A
// fragment of the k16 step j.

// A fragment of rows [r0, r0 + 16), columns [k0, k0 + 16) of a row-major
// shared tile with pitch P.
template <int P>
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* tile, int r0, int k0, int lane) {
  ldsm_x4(a, tile + (r0 + (lane & 15)) * P + k0 + (lane >> 4) * 8);
}

// B fragments of two n tiles (rows n0..n0+15 of the tile are the n index,
// columns k0..k0+15 the k index): b[0], b[1] for n0, b[2], b[3] for n0 + 8.
// For S = Q K^T with K stored (key, d).
template <int P>
__device__ __forceinline__ void load_b(uint32_t* b, const bf16* tile, int n0, int k0, int lane) {
  ldsm_x4(b, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * P + k0 + ((lane >> 3) & 1) * 8);
}

// B fragments of two n tiles from a tile stored (k, n): rows k0..k0+15 are
// the k index, columns n0..n0+15 the n index (b[0], b[1] for n0; b[2],
// b[3] for n0 + 8).  For O += P V with V stored (key, d).
template <int P>
__device__ __forceinline__ void load_b_trans(uint32_t* b, const bf16* tile, int k0, int n0,
                                             int lane) {
  ldsm_x4_trans(b, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * P + n0 + (lane >> 4) * 8);
}

// Rows [row0, row0 + ROWS) of one (batch, head)'s (S, dh) matrix into a
// shared tile of pitch D + 8, asynchronously; zeros past S and past dh.
template <int ROWS, int D>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src, long long stride,
                                                int row0, int S, int dh) {
  constexpr int CPR = D / 8;   // 16-byte chunks per row
#pragma unroll
  for (int i = threadIdx.x; i < ROWS * CPR; i += kThreads) {
    const int r = i / CPR;
    const int c = (i % CPR) * 8;
    const bool ok = row0 + r < S && c < dh;
    cp_async16(dst + r * (D + 8) + c, ok ? src + (long long)(row0 + r) * stride + c : src, ok);
  }
}

// rows [row0, row0 + ROWS) of a (S,) fp32 vector, asynchronously; 0 past S.
template <int ROWS, int THREADS = kThreads>
__device__ __forceinline__ void load_rows_async(float* dst, const float* src, int row0, int S) {
  for (int i = threadIdx.x; i < ROWS; i += THREADS) {
    const bool ok = row0 + i < S;
    cp_async4(dst + i, ok ? src + row0 + i : src, ok);
  }
}

// The non-causal route (wgmma + TMA), with its own note.
#include "flash_attention_sm90.cuh"

// ---------------------------------------------------------------------------
// bf16 forward
// ---------------------------------------------------------------------------

// A block of kWarps warps holds 16 query rows per warp; key tiles of kFwdBK
// keys stream through the ring.  At D <= 128 the registers are capped
// for 4 blocks per SM (16 warps); at D = 256 that cap would spill the
// accumulators.
template <int D>
__global__ void __launch_bounds__(kThreads, D <= 128 ? 4 : 1)
    flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          float* __restrict__ lse, Strides sq, Strides sk, Strides sv,
                          Strides so, int H, int KV, int S, int dh, int causal, int window,
                          float scale, float softcap) {
  constexpr int BK = kFwdBK;
  constexpr int BQ = 16 * kWarps;
  constexpr int P = D + 8;
  constexpr int NT = BK / 8;    // n tiles of S per key tile
  constexpr int DT = D / 8;     // n tiles of O
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;   // latest (heaviest) tiles first
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wr = warp * 16;             // this warp's first row in the tile

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // (BQ, P)
  bf16* ks = qs + BQ * P;                         // 2 x (BK, P)
  bf16* vs = ks + 2 * BK * P;                     // 2 x (BK, P)

  const bf16* qg = q + b * sq.b + h * sq.h;
  const bf16* kg = k + b * sk.b + kvh * sk.h;
  const bf16* vg = v + b * sv.b + kvh * sv.h;

  int k_lo, k_hi;
  key_range(q0, BQ, S, causal, window, BK, &k_lo, &k_hi);
  const int n_tiles = (k_hi - k_lo + BK - 1) / BK;

  load_tile_async<BQ, D>(qs, qg, sq.s, q0, S, dh);
  load_tile_async<BK, D>(ks, kg, sk.s, k_lo, S, dh);
  load_tile_async<BK, D>(vs, vg, sv.s, k_lo, S, dh);
  cp_async_commit();

  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int r_lo = q0 + wr;             // this warp's rows [r_lo, r_hi]
  const int r_hi = r_lo + 15;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_lo + t * BK;
    const bf16* kt = ks + (t & 1) * BK * P;
    const bf16* vt = vs + (t & 1) * BK * P;
    if (t + 1 < n_tiles) {
      load_tile_async<BK, D>(ks + ((t + 1) & 1) * BK * P, kg, sk.s, k0 + BK, S, dh);
      load_tile_async<BK, D>(vs + ((t + 1) & 1) * BK * P, vg, sv.s, k0 + BK, S, dh);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // a tile none of this warp's rows can see adds exactly nothing
    const bool skip = (causal && k0 > r_hi) || (window > 0 && r_lo - (k0 + BK - 1) >= window);
    if (!skip) {
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4];
        load_a<P>(a, qs, wr, 16 * kk, lane);
#pragma unroll
        for (int j = 0; j < NT / 2; ++j) {
          uint32_t bb[4];
          load_b<P>(bb, kt, 16 * j, 16 * kk, lane);
          mma16816(s[2 * j], a, bb[0], bb[1]);
          mma16816(s[2 * j + 1], a, bb[2], bb[3]);
        }
      }

      const bool need_mask = (causal && k0 + BK - 1 > r_lo) ||
                             (window > 0 && r_hi - k0 >= window) || k0 + BK > S;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = r_lo + lane / 4 + 8 * hf;
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float x = s[j][2 * hf + e] * scale;
            if (softcap > 0.f) x = softcap * tanhf(x / softcap);
            if (need_mask) {
              const int kpos = k0 + 8 * j + 2 * (lane & 3) + e;
              if (kpos >= S) {
                x = -INFINITY;
              } else if (!visible(row, kpos, causal, window)) {
                x = kNegInf;
              }
            }
            s[j][2 * hf + e] = x;
            mx = fmaxf(mx, x);
          }
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[hf], mx);
        const float alpha = exp2f((m[hf] - m_new) * kLog2e);
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            // the difference first: a row masked so far has s = m = -1e30
            // and must weigh 1 (then 0 once a key is seen), as in ref.py
            const float p = exp2f((s[j][2 * hf + e] - m_new) * kLog2e);
            s[j][2 * hf + e] = p;
            rs += p;
          }
        }
        l[hf] = l[hf] * alpha + rs;   // this lane's part; the quad sums at the end
        m[hf] = m_new;
#pragma unroll
        for (int j = 0; j < DT; ++j) {
          acc[j][2 * hf] *= alpha;
          acc[j][2 * hf + 1] *= alpha;
        }
      }

      // O += P V, P rounded to bf16 in registers
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[4];
        a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int j = 0; j < DT / 2; ++j) {
          uint32_t bb[4];
          load_b_trans<P>(bb, vt, 16 * kk, 16 * j, lane);
          mma16816(acc[2 * j], a, bb[0], bb[1]);
          mma16816(acc[2 * j + 1], a, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();   // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float lsum = l[hf];
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
    const int row = r_lo + lane / 4 + 8 * hf;
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(lsum, 1e-30f);
    bf16* op = o + b * so.b + h * so.h + row * so.s;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      if (col < dh)
        *reinterpret_cast<uint32_t*>(op + col) =
            pack_bf16(acc[j][2 * hf] * inv, acc[j][2 * hf + 1] * inv);
    }
    if ((lane & 3) == 0) lse[((long long)b * H + h) * S + row] = m[hf] + logf(lsum);
  }
}

// ---------------------------------------------------------------------------
// bf16 backward
// ---------------------------------------------------------------------------

// The shared part of both backward kernels, for one warp's 16 rows of a
// (rows x 64) score tile held as fragments: s (scores, unscaled) becomes P
// and dp (dO V^T products) becomes dS.  Row r / column c of the tile map
// to (qpos, kpos) by `qk(r, c)`; lse and delta of each element's query come
// from `stats(r, c)`.  Masked elements (invisible, or past S) get P = dS = 0.
template <bool TRANSPOSED, int NJ>
__device__ __forceinline__ void scores_to_grads(float (*s)[4], float (*dp)[4], int row0, int col0,
                                                int lane, const float* lse_c, const float* dl_c,
                                                float lse_r0, float lse_r1, float dl_r0,
                                                float dl_r1, bool need_mask, int S, int causal,
                                                int window, float scale, float softcap) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {   // 8 NJ columns: keys (dQ) or queries (dK/dV)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row0 + lane / 4 + 8 * (e >> 1);   // tile row of this element
      const int c = col0 + 8 * j + 2 * (lane & 3) + (e & 1);
      // the query is the row (dQ kernel) or the column (dK/dV kernel)
      const int qpos = TRANSPOSED ? c : r;
      const int kpos = TRANSPOSED ? r : c;
      float lse_q, dl_q;
      if (TRANSPOSED) {
        lse_q = lse_c[8 * j + 2 * (lane & 3) + (e & 1)];
        dl_q = dl_c[8 * j + 2 * (lane & 3) + (e & 1)];
      } else {
        lse_q = (e >> 1) ? lse_r1 : lse_r0;
        dl_q = (e >> 1) ? dl_r1 : dl_r0;
      }
      float x = s[j][e] * scale;
      float th = 0.f;
      if (softcap > 0.f) {
        th = tanhf(x / softcap);
        x = softcap * th;
      }
      float p = exp2f((x - lse_q) * kLog2e);
      if (need_mask && (qpos >= S || kpos >= S || !visible(qpos, kpos, causal, window))) p = 0.f;
      float ds = p * (dp[j][e] - dl_q);
      if (softcap > 0.f) ds *= 1.f - th * th;
      s[j][e] = p;
      dp[j][e] = ds;
    }
  }
}

// dQ for a (head, batch, query tile of 16 rows per warp), over key tiles of
// kDqKeyTile.
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const bf16* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             bf16* __restrict__ dq, Strides sq, Strides sk, Strides sv,
                             Strides sdo, Strides sdq, int H, int KV, int S, int dh, int causal,
                             int window, float scale, float softcap) {
  constexpr int BK = kDqKeyTile;
  constexpr int BQ = 16 * kWarps;
  constexpr int P = D + 8;
  constexpr int NT = BK / 8;
  constexpr int DT = D / 8;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wr = warp * 16;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // (BQ, P)
  bf16* dos = qs + BQ * P;                        // (BQ, P)
  bf16* ks = dos + BQ * P;                        // 2 x (BK, P)
  bf16* vs = ks + 2 * BK * P;                     // 2 x (BK, P)

  const bf16* kg = k + b * sk.b + kvh * sk.h;
  const bf16* vg = v + b * sv.b + kvh * sv.h;
  int k_lo, k_hi;
  key_range(q0, BQ, S, causal, window, BK, &k_lo, &k_hi);
  const int n_tiles = (k_hi - k_lo + BK - 1) / BK;

  load_tile_async<BQ, D>(qs, q + b * sq.b + h * sq.h, sq.s, q0, S, dh);
  load_tile_async<BQ, D>(dos, dout + b * sdo.b + h * sdo.h, sdo.s, q0, S, dh);
  load_tile_async<BK, D>(ks, kg, sk.s, k_lo, S, dh);
  load_tile_async<BK, D>(vs, vg, sv.s, k_lo, S, dh);
  cp_async_commit();

  const float* lse_h = lse + ((long long)b * H + h) * S;
  const float* delta_h = delta + ((long long)b * H + h) * S;
  const int r0 = q0 + wr + lane / 4;
  const float lse0 = r0 < S ? lse_h[r0] : 0.f, lse1 = r0 + 8 < S ? lse_h[r0 + 8] : 0.f;
  const float dl0 = r0 < S ? delta_h[r0] : 0.f, dl1 = r0 + 8 < S ? delta_h[r0 + 8] : 0.f;

  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const int r_lo = q0 + wr, r_hi = r_lo + 15;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_lo + t * BK;
    const bf16* kt = ks + (t & 1) * BK * P;
    const bf16* vt = vs + (t & 1) * BK * P;
    if (t + 1 < n_tiles) {
      load_tile_async<BK, D>(ks + ((t + 1) & 1) * BK * P, kg, sk.s, k0 + BK, S, dh);
      load_tile_async<BK, D>(vs + ((t + 1) & 1) * BK * P, vg, sv.s, k0 + BK, S, dh);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const bool skip = (causal && k0 > r_hi) || (window > 0 && r_lo - (k0 + BK - 1) >= window);
    if (!skip) {
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t aq[4], ao[4];
        load_a<P>(aq, qs, wr, 16 * kk, lane);
        load_a<P>(ao, dos, wr, 16 * kk, lane);
#pragma unroll
        for (int j = 0; j < NT / 2; ++j) {
          uint32_t bk[4], bv[4];
          load_b<P>(bk, kt, 16 * j, 16 * kk, lane);
          load_b<P>(bv, vt, 16 * j, 16 * kk, lane);
          mma16816(s[2 * j], aq, bk[0], bk[1]);
          mma16816(s[2 * j + 1], aq, bk[2], bk[3]);
          mma16816(dp[2 * j], ao, bv[0], bv[1]);
          mma16816(dp[2 * j + 1], ao, bv[2], bv[3]);
        }
      }
      const bool need_mask = (causal && k0 + BK - 1 > r_lo) ||
                             (window > 0 && r_hi - k0 >= window) || k0 + BK > S ||
                             q0 + BQ > S;
      scores_to_grads<false, NT>(s, dp, r_lo, k0, lane, nullptr, nullptr, lse0, lse1, dl0,
                                 dl1, need_mask, S, causal, window, scale, softcap);
      // dQ += dS K, dS rounded to bf16 in registers
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[4];
        a[0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
        a[1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
        a[2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
        a[3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
#pragma unroll
        for (int j = 0; j < DT / 2; ++j) {
          uint32_t bb[4];
          load_b_trans<P>(bb, kt, 16 * kk, 16 * j, lane);
          mma16816(acc[2 * j], a, bb[0], bb[1]);
          mma16816(acc[2 * j + 1], a, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = r0 + 8 * hf;
    if (row >= S) continue;
    bf16* p = dq + b * sdq.b + h * sdq.h + row * sdq.s;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      if (col < dh)
        *reinterpret_cast<uint32_t*>(p + col) =
            pack_bf16(acc[j][2 * hf] * scale, acc[j][2 * hf + 1] * scale);
    }
  }
}

// dK, dV for a (KV head, batch, tile of 16 keys per warp), columns [dc0,
// dc0 + DO) of the head_dim (DO = D / dkv_split(D)), summed over the G
// query heads of the group, query tiles of kDkvQueryTile.
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const bf16* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              bf16* __restrict__ dk, bf16* __restrict__ dv, Strides sq,
                              Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv,
                              int H, int KV, int S, int dh, int causal, int window, float scale,
                              float softcap) {
  constexpr int SPLIT = dkv_split(D);
  constexpr int DO = D / SPLIT;
  constexpr int QT = kDkvQueryTile;
  constexpr int BKV = 16 * kWarps;   // keys per block
  constexpr int P = D + 8;
  constexpr int NT = QT / 8;    // n tiles of S^T (queries)
  constexpr int OT = DO / 8;     // n tiles of dK, dV
  const int kvh = blockIdx.x / SPLIT;
  const int dc0 = (blockIdx.x % SPLIT) * DO;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * BKV;      // the earliest key tiles (the most queries) first
  const int G = H / KV;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wk = warp * 16;             // this warp's first key in the tile

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);   // (BKV, P)
  bf16* vs = ks + BKV * P;                        // (BKV, P)
  bf16* qs = vs + BKV * P;                        // 2 x (QT, P)
  bf16* dos = qs + 2 * QT * P;                    // 2 x (QT, P)
  float* lse_s = reinterpret_cast<float*>(dos + 2 * QT * P);   // 2 x QT
  float* dl_s = lse_s + 2 * QT;                                // 2 x QT

  // the query tiles that see a key of this tile
  int q_lo = causal ? k0 : 0;
  int q_hi = S;
  if (window > 0) q_hi = min(S, k0 + BKV - 1 + window);
  q_lo = (q_lo / QT) * QT;
  const int n_qt = (q_hi - q_lo + QT - 1) / QT;
  const int n_steps = G * n_qt;

  // step i: head kvh * G + i / n_qt, query tile q_lo + (i % n_qt) * QT
  auto prefetch = [&](int i) {
    const int hh = kvh * G + i / n_qt;
    const int qq = q_lo + (i % n_qt) * QT;
    const int st = i & 1;
    load_tile_async<QT, D>(qs + st * QT * P, q + b * sq.b + hh * sq.h, sq.s, qq, S, dh);
    load_tile_async<QT, D>(dos + st * QT * P, dout + b * sdo.b + hh * sdo.h, sdo.s, qq,
                                 S, dh);
    load_rows_async<QT>(lse_s + st * QT, lse + ((long long)b * H + hh) * S, qq, S);
    load_rows_async<QT>(dl_s + st * QT, delta + ((long long)b * H + hh) * S, qq, S);
  };

  load_tile_async<BKV, D>(ks, k + b * sk.b + kvh * sk.h, sk.s, k0, S, dh);
  load_tile_async<BKV, D>(vs, v + b * sv.b + kvh * sv.h, sv.s, k0, S, dh);
  if (n_steps > 0) prefetch(0);
  cp_async_commit();

  float dk_acc[OT][4], dv_acc[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;
  const int kw_lo = k0 + wk, kw_hi = kw_lo + 15;

  for (int i = 0; i < n_steps; ++i) {
    const int q0 = q_lo + (i % n_qt) * QT;
    const bf16* qt = qs + (i & 1) * QT * P;
    const bf16* dt = dos + (i & 1) * QT * P;
    if (i + 1 < n_steps) {
      prefetch(i + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const bool skip = (causal && kw_lo > q0 + QT - 1) || (window > 0 && q0 - kw_hi >= window);
    if (!skip) {
      float st[NT][4], dpt[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
      // S^T = K Q^T and dP^T = V dO^T over the whole head_dim
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ak[4], av[4];
        load_a<P>(ak, ks, wk, 16 * kk, lane);
        load_a<P>(av, vs, wk, 16 * kk, lane);
#pragma unroll
        for (int j = 0; j < NT / 2; ++j) {
          uint32_t bq[4], bo[4];
          load_b<P>(bq, qt, 16 * j, 16 * kk, lane);
          load_b<P>(bo, dt, 16 * j, 16 * kk, lane);
          mma16816(st[2 * j], ak, bq[0], bq[1]);
          mma16816(st[2 * j + 1], ak, bq[2], bq[3]);
          mma16816(dpt[2 * j], av, bo[0], bo[1]);
          mma16816(dpt[2 * j + 1], av, bo[2], bo[3]);
        }
      }
      const bool need_mask = (causal && k0 + BKV - 1 > q0) ||
                             (window > 0 && q0 + QT - 1 - k0 >= window) || q0 + QT > S ||
                             k0 + BKV > S;
      scores_to_grads<true, NT>(st, dpt, kw_lo, q0, lane, lse_s + (i & 1) * QT,
                            dl_s + (i & 1) * QT, 0.f, 0.f, 0.f, 0.f, need_mask, S, causal,
                            window, scale, softcap);
      // dV += P^T dO and dK += dS^T Q over this block's columns
#pragma unroll
      for (int kk = 0; kk < QT / 16; ++kk) {
        uint32_t ap[4], ad[4];
        ap[0] = pack_bf16(st[2 * kk][0], st[2 * kk][1]);
        ap[1] = pack_bf16(st[2 * kk][2], st[2 * kk][3]);
        ap[2] = pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]);
        ap[3] = pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3]);
        ad[0] = pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]);
        ad[1] = pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]);
        ad[2] = pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]);
        ad[3] = pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3]);
#pragma unroll
        for (int j = 0; j < OT / 2; ++j) {
          uint32_t bo[4], bq[4];
          load_b_trans<P>(bo, dt, 16 * kk, dc0 + 16 * j, lane);
          load_b_trans<P>(bq, qt, 16 * kk, dc0 + 16 * j, lane);
          mma16816(dv_acc[2 * j], ap, bo[0], bo[1]);
          mma16816(dv_acc[2 * j + 1], ap, bo[2], bo[3]);
          mma16816(dk_acc[2 * j], ad, bq[0], bq[1]);
          mma16816(dk_acc[2 * j + 1], ad, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int kpos = kw_lo + lane / 4 + 8 * hf;
    if (kpos >= S) continue;
    bf16* dkp = dk + b * sdk.b + kvh * sdk.h + kpos * sdk.s;
    bf16* dvp = dv + b * sdv.b + kvh * sdv.h + kpos * sdv.s;
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      const int col = dc0 + 8 * j + 2 * (lane & 3);
      if (col < dh) {
        *reinterpret_cast<uint32_t*>(dkp + col) =
            pack_bf16(dk_acc[j][2 * hf] * scale, dk_acc[j][2 * hf + 1] * scale);
        *reinterpret_cast<uint32_t*>(dvp + col) =
            pack_bf16(dv_acc[j][2 * hf], dv_acc[j][2 * hf + 1]);
      }
    }
  }
}

// ===========================================================================
// fp32 route: error-compensated TF32 on the tensor cores (mma.sync m16n8k8)
// ===========================================================================
//
// Every fp32 operand x is split into two TF32 values, hi = rna(x) and
// lo = x - hi, and a product a b is formed as al bh + ah bl + ah bh by
// three `mma.sync.m16n8k8` TF32 MMAs accumulating in fp32 ("3xTF32"): the
// dropped al bl and lo's TF32 precision leave ~2^-21 of each product, well
// inside the fp32 gates (2e-5).  The split is integer work on the CUDA
// cores (`split_tf32`); it and the MMAs bound the kernels, not memory.
// Scale, softcap, masks, the online softmax, lse and delta stay fp32 on
// the CUDA cores.  The blocks are the bf16
// route's: 4 warps of 16 rows, one query head per block in the forward and
// dQ (any group size), one KV head and a share of its group's query heads
// in dK/dV; tiles stream through a 2-stage cp.async ring into shared memory
// padded by 4 floats a row (no bank conflicts for ldmatrix or for the
// column reads of `ldb_kn_f32`).
//
// Fragments (m16n8k8 TF32; lane = 4 g + c, g = lane / 4, c = lane % 4):
//   A 16x8:  a0 (g, c), a1 (g + 8, c), a2 (g, c + 4), a3 (g + 8, c + 4)
//   B 8x8:   b0 (k c, n g), b1 (k c + 4, n g)
//   C 16x8:  c0, c1 (g, 2c..); c2, c3 (g + 8, 2c..)
// An 8x8 b16 ldmatrix tile is an 8x4 fp32 one whose float (i / 4, i % 4) is
// lane i's register, so A and B fragments of a row-major fp32 tile load by
// ldmatrix.x4.  A C fragment is not an A fragment, but a product's k order
// is free: taking the 8 keys of an n tile in the order 0, 2, 4, 6, 1, 3,
// 5, 7, the scores' fragment {c0, c2, c1, c3} is the A fragment of P V,
// with B read at rows 2c and 2c + 1 (`c_to_a`, `ldb_kn_f32`).

// Tiles by head_dim instance (D = 256 fits in 227 KB of shared memory).
// The backward runs one warp per 16 rows at D = 64; from D = 128 warp
// pairs (flash_bwd_*_f32_pair_kernel), which halve what a warp holds in
// registers: at D = 256 a single warp's dK and dV accumulators would not
// fit, nor its dQ, S and dP without spilling.
template <int D>
struct F32Tiles {
  static constexpr int P = D + 4;   // row pitch (floats)
  static constexpr int STAGES = 2;
  static constexpr bool PAIRS = D >= 128;
  static constexpr int FWD_BK = D <= 64 ? 64 : 32;                    // forward: keys a tile
  static constexpr int DQ_BK = PAIRS ? (D <= 128 ? 32 : 16) : 64;     // dQ: keys a tile
  static constexpr int KV_QT = D <= 128 ? 32 : 16;                    // dK/dV: queries a tile
  // the S (dP) products take n tiles in pairs (ldb_f32)
  static_assert(FWD_BK % 16 == 0 && DQ_BK % 16 == 0 && KV_QT % 16 == 0,
                "fp32 flash tiles: 16 keys or queries at least");
};
// query rows (forward, dQ) or keys (dK/dV) per block
constexpr int kF32Rows = 16 * kWarps;

// An operand fragment as hi + lo TF32 parts.
template <int N>
struct Split {
  uint32_t hi[N], lo[N];
};

// hi: x rounded to TF32, to nearest with ties away from zero (half a TF32
// ulp added to the bits, then the 13 low bits cleared: the bits of
// cvt.rna.tf32.f32, at less cost on sm_90, for the finite values attention
// feeds it); lo = x - hi, exact, which the MMA reads at TF32 precision (to
// ~2^-21 of x, the size of the dropped lo lo').
template <int N>
__device__ __forceinline__ Split<N> split_tf32(const uint32_t* x) {
  Split<N> s;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    s.hi[i] = (x[i] + 0x1000u) & 0xffffe000u;
    s.lo[i] = __float_as_uint(__uint_as_float(x[i]) - __uint_as_float(s.hi[i]));
  }
  return s;
}

// c (16x8 fp32) += a (16x8 TF32, row) * b (8x8 TF32, col)
__device__ __forceinline__ void mma1688(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b to fp32 accuracy: the cross terms first, then hi hi
__device__ __forceinline__ void mma3(float* c, const Split<4>& a, const Split<2>& b) {
  mma1688(c, a.lo, b.hi[0], b.hi[1]);
  mma1688(c, a.hi, b.lo[0], b.lo[1]);
  mma1688(c, a.hi, b.hi[0], b.hi[1]);
}

// c += the products of a tile's J k steps, a_j b_j for j < J, for an
// accumulator that lives across tiles (O, dQ, dK, dV): the tile's 3 J MMAs
// into a fresh fragment, then one fp32 add.  The tensor cores do not round
// their fp32 accumulation to nearest, so a chain of thousands of MMA
// accumulations drifts (dK/dV at RecurrentGemma-9B's group sums 16 x 2,048
// products: ~1e-4 of the largest gradient), where round-to-nearest adds of
// each tile's sum do not.  `b(j, frag)` loads the B fragment of k step j.
template <int J, typename LoadB>
__device__ __forceinline__ void mma3_tile_add(float* c, const Split<4>* a, LoadB b) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < J; ++j) {
    uint32_t bb[2];
    b(j, bb);
    mma3(t, a[j], split_tf32<2>(bb));
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += t[e];
}

// A fragment of rows [r0, r0 + 16), columns [k0, k0 + 8) of a row-major
// fp32 shared tile with pitch P.
template <int P>
__device__ __forceinline__ void lda_f32(uint32_t* a, const float* tile, int r0, int k0,
                                        int lane) {
  ldsm_x4(a, tile + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * P + k0 + (lane >> 4) * 4);
}

// B fragments of two n tiles from a tile stored (n, k): rows n0..n0+15 are
// the n index, columns k0..k0+7 the k index (b[0], b[1] for n0; b[2], b[3]
// for n0 + 8).  For S = Q K^T with K stored (key, d).
template <int P>
__device__ __forceinline__ void ldb_f32(uint32_t* b, const float* tile, int n0, int k0,
                                        int lane) {
  ldsm_x4(b, tile + (n0 + (lane & 7) + (lane >> 4) * 8) * P + k0 + ((lane >> 3) & 1) * 4);
}

// B fragment of one n tile from a tile stored (k, n), its 8 k rows from k0
// in the order 0, 2, 4, 6, 1, 3, 5, 7: rows k0 + 2c and k0 + 2c + 1,
// column n0 + g.  For O += P V with V stored (key, d).
template <int P>
__device__ __forceinline__ void ldb_kn_f32(uint32_t* b, const float* tile, int k0, int n0,
                                           int lane) {
  const float* p = tile + (k0 + 2 * (lane & 3)) * P + n0 + (lane >> 2);
  b[0] = __float_as_uint(p[0]);
  b[1] = __float_as_uint(p[P]);
}

// The A fragment, over the columns of an n tile in `ldb_kn_f32`'s order,
// of a C fragment.
__device__ __forceinline__ void c_to_a(uint32_t* a, const float* c) {
  a[0] = __float_as_uint(c[0]);
  a[1] = __float_as_uint(c[2]);
  a[2] = __float_as_uint(c[1]);
  a[3] = __float_as_uint(c[3]);
}

// Rows [row0, row0 + ROWS) of one (batch, head)'s (S, dh) fp32 matrix into
// a shared tile of pitch D + 4, asynchronously; zeros past S and past dh.
template <int ROWS, int D, int THREADS = kThreads>
__device__ __forceinline__ void load_tile_f32_async(float* dst, const float* src,
                                                    long long stride, int row0, int S, int dh) {
  constexpr int CPR = D / 4;   // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * CPR; i += THREADS) {
    const int r = i / CPR;
    const int c = (i % CPR) * 4;
    const bool ok = row0 + r < S && c < dh;
    cp_async16(dst + r * (D + 4) + c, ok ? src + (long long)(row0 + r) * stride + c : src, ok);
  }
}

// ---------------------------------------------------------------------------
// fp32 forward
// ---------------------------------------------------------------------------

// One block per (query tile of 64 rows, head, batch), 16 rows a warp; Q
// staged once, K and V tiles of FWD_BK keys through the ring.
template <int D>
__global__ void __launch_bounds__(kThreads, D <= 128 ? 2 : 1)
    flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, Strides sq, Strides sk, Strides sv,
                         Strides so, int H, int KV, int S, int dh, int causal, int window,
                         float scale, float softcap) {
  using T = F32Tiles<D>;
  constexpr int BK = T::FWD_BK;
  constexpr int BQ = kF32Rows;
  constexpr int P = T::P;
  constexpr int ST = T::STAGES;
  constexpr int NT = BK / 8;    // n tiles of S per key tile
  constexpr int DT = D / 8;     // n tiles of O
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // latest (heaviest) tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wr = warp * 16;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);   // (BQ, P)
  float* ks = qs + BQ * P;                          // ST x (BK, P)
  float* vs = ks + ST * BK * P;                     // ST x (BK, P)

  const float* kg = k + b * sk.b + kvh * sk.h;
  const float* vg = v + b * sv.b + kvh * sv.h;
  int k_lo, k_hi;
  key_range(q0, BQ, S, causal, window, BK, &k_lo, &k_hi);
  const int n_tiles = (k_hi - k_lo + BK - 1) / BK;

  load_tile_f32_async<BQ, D>(qs, q + b * sq.b + h * sq.h, sq.s, q0, S, dh);
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    if (i < n_tiles) {
      load_tile_f32_async<BK, D>(ks + i * BK * P, kg, sk.s, k_lo + i * BK, S, dh);
      load_tile_f32_async<BK, D>(vs + i * BK * P, vg, sv.s, k_lo + i * BK, S, dh);
    }
    cp_async_commit();
  }

  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int r_lo = q0 + wr;             // this warp's rows [r_lo, r_hi]
  const int r_hi = r_lo + 15;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<ST - 2>();
    __syncthreads();   // tile t is in; every warp is done with the stage refilled next
    if (t + ST - 1 < n_tiles) {
      const int nxt = (t + ST - 1) % ST;
      const int kn = k_lo + (t + ST - 1) * BK;
      load_tile_f32_async<BK, D>(ks + nxt * BK * P, kg, sk.s, kn, S, dh);
      load_tile_f32_async<BK, D>(vs + nxt * BK * P, vg, sv.s, kn, S, dh);
    }
    cp_async_commit();
    const int k0 = k_lo + t * BK;
    const float* kt = ks + (t % ST) * BK * P;
    const float* vt = vs + (t % ST) * BK * P;

    // a tile none of this warp's rows can see adds exactly nothing
    if ((causal && k0 > r_hi) || (window > 0 && r_lo - (k0 + BK - 1) >= window)) continue;

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      uint32_t a[4];
      lda_f32<P>(a, qs, wr, 8 * kk, lane);
      const Split<4> qa = split_tf32<4>(a);
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        uint32_t bb[4];
        ldb_f32<P>(bb, kt, 16 * j, 8 * kk, lane);
        mma3(s[2 * j], qa, split_tf32<2>(bb));
        mma3(s[2 * j + 1], qa, split_tf32<2>(bb + 2));
      }
    }

    const bool need_mask = (causal && k0 + BK - 1 > r_lo) ||
                           (window > 0 && r_hi - k0 >= window) || k0 + BK > S;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = r_lo + lane / 4 + 8 * hf;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = s[j][2 * hf + e] * scale;
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
          if (need_mask) {
            const int kpos = k0 + 8 * j + 2 * (lane & 3) + e;
            if (kpos >= S) {
              x = -INFINITY;
            } else if (!visible(row, kpos, causal, window)) {
              x = kNegInf;
            }
          }
          s[j][2 * hf + e] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hf], mx);
      const float alpha = exp2f((m[hf] - m_new) * kLog2e);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // the difference first: a row masked so far has s = m = -1e30
          // and must weigh 1 (then 0 once a key is seen), as in ref.py
          const float p = exp2f((s[j][2 * hf + e] - m_new) * kLog2e);
          s[j][2 * hf + e] = p;
          rs += p;
        }
      }
      l[hf] = l[hf] * alpha + rs;   // this lane's part; the quad sums at the end
      m[hf] = m_new;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        acc[j][2 * hf] *= alpha;
        acc[j][2 * hf + 1] *= alpha;
      }
    }

    // O += P V
    Split<4> pa[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t a[4];
      c_to_a(a, s[j]);
      pa[j] = split_tf32<4>(a);
    }
#pragma unroll
    for (int n = 0; n < DT; ++n)
      mma3_tile_add<NT>(acc[n], pa, [&](int j, uint32_t* bb) {
        ldb_kn_f32<P>(bb, vt, 8 * j, 8 * n, lane);
      });
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float lsum = l[hf];
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
    const int row = r_lo + lane / 4 + 8 * hf;
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(lsum, 1e-30f);
    float* op = o + b * so.b + h * so.h + row * so.s;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      if (col < dh)
        *reinterpret_cast<float2*>(op + col) =
            make_float2(acc[j][2 * hf] * inv, acc[j][2 * hf + 1] * inv);
    }
    if ((lane & 3) == 0) lse[((long long)b * H + h) * S + row] = m[hf] + logf(lsum);
  }
}

// ---------------------------------------------------------------------------
// fp32 backward
// ---------------------------------------------------------------------------

// dQ for a (query tile of 64 rows, head, batch), 16 rows a warp, over key
// tiles of DQ_BK: S = Q K^T and dP = dO V^T, dS (`scores_to_grads`), then
// dQ += dS K.
template <int D>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 2 : 1)
    flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            float* __restrict__ dq, Strides sq, Strides sk, Strides sv,
                            Strides sdo, Strides sdq, int H, int KV, int S, int dh, int causal,
                            int window, float scale, float softcap) {
  using T = F32Tiles<D>;
  constexpr int BK = T::DQ_BK;
  constexpr int BQ = kF32Rows;
  constexpr int P = T::P;
  constexpr int ST = T::STAGES;
  constexpr int NT = BK / 8;
  constexpr int DT = D / 8;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wr = warp * 16;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);   // (BQ, P)
  float* dos = qs + BQ * P;                         // (BQ, P)
  float* ks = dos + BQ * P;                         // ST x (BK, P)
  float* vs = ks + ST * BK * P;                     // ST x (BK, P)

  const float* kg = k + b * sk.b + kvh * sk.h;
  const float* vg = v + b * sv.b + kvh * sv.h;
  int k_lo, k_hi;
  key_range(q0, BQ, S, causal, window, BK, &k_lo, &k_hi);
  const int n_tiles = (k_hi - k_lo + BK - 1) / BK;

  load_tile_f32_async<BQ, D>(qs, q + b * sq.b + h * sq.h, sq.s, q0, S, dh);
  load_tile_f32_async<BQ, D>(dos, dout + b * sdo.b + h * sdo.h, sdo.s, q0, S, dh);
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    if (i < n_tiles) {
      load_tile_f32_async<BK, D>(ks + i * BK * P, kg, sk.s, k_lo + i * BK, S, dh);
      load_tile_f32_async<BK, D>(vs + i * BK * P, vg, sv.s, k_lo + i * BK, S, dh);
    }
    cp_async_commit();
  }

  const float* lse_h = lse + ((long long)b * H + h) * S;
  const float* delta_h = delta + ((long long)b * H + h) * S;
  const int r0 = q0 + wr + lane / 4;
  const float lse0 = r0 < S ? lse_h[r0] : 0.f, lse1 = r0 + 8 < S ? lse_h[r0 + 8] : 0.f;
  const float dl0 = r0 < S ? delta_h[r0] : 0.f, dl1 = r0 + 8 < S ? delta_h[r0 + 8] : 0.f;

  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const int r_lo = q0 + wr, r_hi = r_lo + 15;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<ST - 2>();
    __syncthreads();
    if (t + ST - 1 < n_tiles) {
      const int nxt = (t + ST - 1) % ST;
      const int kn = k_lo + (t + ST - 1) * BK;
      load_tile_f32_async<BK, D>(ks + nxt * BK * P, kg, sk.s, kn, S, dh);
      load_tile_f32_async<BK, D>(vs + nxt * BK * P, vg, sv.s, kn, S, dh);
    }
    cp_async_commit();
    const int k0 = k_lo + t * BK;
    const float* kt = ks + (t % ST) * BK * P;
    const float* vt = vs + (t % ST) * BK * P;
    if ((causal && k0 > r_hi) || (window > 0 && r_lo - (k0 + BK - 1) >= window)) continue;

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      uint32_t a[4];
      lda_f32<P>(a, qs, wr, 8 * kk, lane);
      const Split<4> qa = split_tf32<4>(a);
      lda_f32<P>(a, dos, wr, 8 * kk, lane);
      const Split<4> oa = split_tf32<4>(a);
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        uint32_t bk[4], bv[4];
        ldb_f32<P>(bk, kt, 16 * j, 8 * kk, lane);
        ldb_f32<P>(bv, vt, 16 * j, 8 * kk, lane);
        mma3(s[2 * j], qa, split_tf32<2>(bk));
        mma3(s[2 * j + 1], qa, split_tf32<2>(bk + 2));
        mma3(dp[2 * j], oa, split_tf32<2>(bv));
        mma3(dp[2 * j + 1], oa, split_tf32<2>(bv + 2));
      }
    }
    const bool need_mask = (causal && k0 + BK - 1 > r_lo) ||
                           (window > 0 && r_hi - k0 >= window) || k0 + BK > S ||
                           q0 + BQ > S;
    scores_to_grads<false, NT>(s, dp, r_lo, k0, lane, nullptr, nullptr, lse0, lse1, dl0, dl1,
                               need_mask, S, causal, window, scale, softcap);
    // dQ += dS K
    Split<4> da[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t a[4];
      c_to_a(a, dp[j]);
      da[j] = split_tf32<4>(a);
    }
#pragma unroll
    for (int n = 0; n < DT; ++n)
      mma3_tile_add<NT>(acc[n], da, [&](int j, uint32_t* bb) {
        ldb_kn_f32<P>(bb, kt, 8 * j, 8 * n, lane);
      });
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = r0 + 8 * hf;
    if (row >= S) continue;
    float* p = dq + b * sdq.b + h * sdq.h + row * sdq.s;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      if (col < dh)
        *reinterpret_cast<float2*>(p + col) =
            make_float2(acc[j][2 * hf] * scale, acc[j][2 * hf + 1] * scale);
    }
  }
}

// The fp32 dK/dV kernel's work for key tile `tile` (keys [64 tile, 64 tile
// + 64)): its steps, one per (query head of the group, query tile of QT
// that sees a key of the tile), G heads in turn; *q_lo the first query
// tile's row.  Under causality tile 0 has the most, the last the fewest.
__host__ __device__ inline int f32_kv_steps(int tile, int S, int G, int QT, int causal,
                                            int window, int* q_lo) {
  const int k0 = tile * kF32Rows;
  int lo = causal ? k0 : 0;
  int hi = S;
  if (window > 0 && window < S - k0 - (kF32Rows - 1)) hi = k0 + kF32Rows - 1 + window;
  lo = (lo / QT) * QT;
  *q_lo = lo;
  return G * ((hi - lo + QT - 1) / QT);
}

// A key tile's steps are cut into ceil(steps / chunk) parts of even size,
// one block each; where a tile has more than one part its blocks write
// fp32 partials that flash_bwd_dkv_sum_f32_kernel sums in a fixed order.
__host__ __device__ inline int f32_kv_parts(int steps, int chunk) {
  return (steps + chunk - 1) / chunk;
}

// dK, dV for a (tile of 64 keys, KV head, batch), 16 keys a warp, summed
// over a part of the tile's steps (query heads of the group x query tiles
// of KV_QT: the grid's blocks get even shares of the work, the heavy early
// key tiles under causality more parts): S^T = K Q^T and dP^T = V dO^T,
// dS^T, then dV += P^T dO and dK += dS^T Q.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             float* __restrict__ dk, float* __restrict__ dv, Strides sq,
                             Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv,
                             float* __restrict__ partial, int chunk, int max_parts, int B,
                             int H, int KV, int S, int dh, int causal, int window,
                             float scale, float softcap) {
  using T = F32Tiles<D>;
  constexpr int QT = T::KV_QT;
  constexpr int BKV = kF32Rows;
  constexpr int P = T::P;
  constexpr int ST = T::STAGES;
  constexpr int NT = QT / 8;    // n tiles of S^T (queries)
  constexpr int OT = D / 8;     // n tiles of dK, dV
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KV;
  // this block's key tile (the earliest, with the most queries, first) and
  // its part [s0, s1) of the tile's steps
  int tile = 0, part = blockIdx.x, steps, parts, q_lo;
  for (;; ++tile) {
    steps = f32_kv_steps(tile, S, G, QT, causal, window, &q_lo);
    parts = f32_kv_parts(steps, chunk);
    if (part < parts) break;
    part -= parts;
  }
  const int k0 = tile * BKV;
  const int s0 = (int)((long long)part * steps / parts);
  const int n_steps = (int)((long long)(part + 1) * steps / parts) - s0;
  const int n_qt = steps / G;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wk = warp * 16;             // this warp's first key in the tile

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);   // (BKV, P)
  float* vs = ks + BKV * P;                         // (BKV, P)
  float* qs = vs + BKV * P;                         // ST x (QT, P)
  float* dos = qs + ST * QT * P;                    // ST x (QT, P)
  float* lse_s = dos + ST * QT * P;                 // ST x QT
  float* dl_s = lse_s + ST * QT;                    // ST x QT

  // this block's step i: the tile's step s0 + i, whose head is s / n_qt of
  // the group and query tile q_lo + (s % n_qt) * QT
  auto prefetch = [&](int i) {
    const int hh = kvh * G + (s0 + i) / n_qt;
    const int qq = q_lo + (s0 + i) % n_qt * QT;
    const int st = i % ST;
    load_tile_f32_async<QT, D>(qs + st * QT * P, q + b * sq.b + hh * sq.h, sq.s, qq, S, dh);
    load_tile_f32_async<QT, D>(dos + st * QT * P, dout + b * sdo.b + hh * sdo.h, sdo.s, qq, S,
                               dh);
    load_rows_async<QT>(lse_s + st * QT, lse + ((long long)b * H + hh) * S, qq, S);
    load_rows_async<QT>(dl_s + st * QT, delta + ((long long)b * H + hh) * S, qq, S);
  };

  load_tile_f32_async<BKV, D>(ks, k + b * sk.b + kvh * sk.h, sk.s, k0, S, dh);
  load_tile_f32_async<BKV, D>(vs, v + b * sv.b + kvh * sv.h, sv.s, k0, S, dh);
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    if (i < n_steps) prefetch(i);
    cp_async_commit();
  }

  float dk_acc[OT][4], dv_acc[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;
  const int kw_lo = k0 + wk, kw_hi = kw_lo + 15;

  for (int i = 0; i < n_steps; ++i) {
    cp_async_wait<ST - 2>();
    __syncthreads();
    if (i + ST - 1 < n_steps) prefetch(i + ST - 1);
    cp_async_commit();
    const int q0 = q_lo + (s0 + i) % n_qt * QT;
    const int stage = i % ST;
    const float* qt = qs + stage * QT * P;
    const float* dt = dos + stage * QT * P;
    if ((causal && kw_lo > q0 + QT - 1) || (window > 0 && q0 - kw_hi >= window)) continue;

    float sT[NT][4], dpT[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sT[j][e] = dpT[j][e] = 0.f;
    // S^T = K Q^T and dP^T = V dO^T over the whole head_dim
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      uint32_t a[4];
      lda_f32<P>(a, ks, wk, 8 * kk, lane);
      const Split<4> ka = split_tf32<4>(a);
      lda_f32<P>(a, vs, wk, 8 * kk, lane);
      const Split<4> va = split_tf32<4>(a);
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        uint32_t bq[4], bo[4];
        ldb_f32<P>(bq, qt, 16 * j, 8 * kk, lane);
        ldb_f32<P>(bo, dt, 16 * j, 8 * kk, lane);
        mma3(sT[2 * j], ka, split_tf32<2>(bq));
        mma3(sT[2 * j + 1], ka, split_tf32<2>(bq + 2));
        mma3(dpT[2 * j], va, split_tf32<2>(bo));
        mma3(dpT[2 * j + 1], va, split_tf32<2>(bo + 2));
      }
    }
    const bool need_mask = (causal && k0 + BKV - 1 > q0) ||
                           (window > 0 && q0 + QT - 1 - k0 >= window) || q0 + QT > S ||
                           k0 + BKV > S;
    scores_to_grads<true, NT>(sT, dpT, kw_lo, q0, lane, lse_s + stage * QT,
                              dl_s + stage * QT, 0.f, 0.f, 0.f, 0.f, need_mask, S, causal,
                              window, scale, softcap);
    // dV += P^T dO and dK += dS^T Q
    Split<4> pa[NT], da[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t a[4];
      c_to_a(a, sT[j]);
      pa[j] = split_tf32<4>(a);
      c_to_a(a, dpT[j]);
      da[j] = split_tf32<4>(a);
    }
#pragma unroll
    for (int n = 0; n < OT; ++n) {
      mma3_tile_add<NT>(dv_acc[n], pa, [&](int j, uint32_t* bb) {
        ldb_kn_f32<P>(bb, dt, 8 * j, 8 * n, lane);
      });
      mma3_tile_add<NT>(dk_acc[n], da, [&](int j, uint32_t* bb) {
        ldb_kn_f32<P>(bb, qt, 8 * j, 8 * n, lane);
      });
    }
  }

  const long long n_el = (long long)B * KV * S * dh;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int kpos = kw_lo + lane / 4 + 8 * hf;
    if (kpos >= S) continue;
    const long long row = ((long long)b * KV + kvh) * S + kpos;
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      if (col >= dh) continue;
      if (parts == 1) {
        *reinterpret_cast<float2*>(dk + b * sdk.b + kvh * sdk.h + kpos * sdk.s + col) =
            make_float2(dk_acc[j][2 * hf] * scale, dk_acc[j][2 * hf + 1] * scale);
        *reinterpret_cast<float2*>(dv + b * sdv.b + kvh * sdv.h + kpos * sdv.s + col) =
            make_float2(dv_acc[j][2 * hf], dv_acc[j][2 * hf + 1]);
      } else {
        *reinterpret_cast<float2*>(partial + part * n_el + row * dh + col) =
            make_float2(dk_acc[j][2 * hf], dk_acc[j][2 * hf + 1]);
        *reinterpret_cast<float2*>(partial + (max_parts + part) * n_el + row * dh + col) =
            make_float2(dv_acc[j][2 * hf], dv_acc[j][2 * hf + 1]);
      }
    }
  }
}

// Named barrier `id` over `n` threads: arrive without waiting, or wait.
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// dK, dV as flash_bwd_dkv_f32_kernel computes them, with each 16-key group's
// work split between two warps of a block of 8: warp g (g < 4) forms
// S^T = K Q^T, P^T and dV += P^T dO; warp 4 + g forms dP^T = V dO^T,
// dS^T = P^T (dP^T - delta) and dK += dS^T Q, taking P^T (times 1 - t^2
// under a softcap) through shared memory behind a named barrier of the
// pair.  Each warp holds one accumulator over the whole head_dim, so no
// product is formed twice (the single-warp kernel splits D = 256 over two
// blocks, each forming S^T and dP^T).
template <int D>
__global__ void __launch_bounds__(2 * kThreads, 1)
    flash_bwd_dkv_f32_pair_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                  const float* __restrict__ v, const float* __restrict__ dout,
                                  const float* __restrict__ lse,
                                  const float* __restrict__ delta, float* __restrict__ dk,
                                  float* __restrict__ dv, Strides sq, Strides sk, Strides sv,
                                  Strides sdo, Strides sdk, Strides sdv,
                                  float* __restrict__ partial, int chunk, int max_parts, int B,
                                  int H, int KV, int S, int dh, int causal, int window,
                                  float scale, float softcap) {
  using T = F32Tiles<D>;
  constexpr int THREADS = 2 * kThreads;
  constexpr int QT = T::KV_QT;
  constexpr int GP = QT + 8;    // the exchange's row pitch (floats)
  constexpr int BKV = kF32Rows;
  constexpr int P = T::P;
  constexpr int ST = T::STAGES;
  constexpr int NT = QT / 8;    // n tiles of S^T / dP^T (queries)
  constexpr int OT = D / 8;     // n tiles of dK, dV
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KV;
  int tile = 0, part = blockIdx.x, steps, parts, q_lo;
  for (;; ++tile) {
    steps = f32_kv_steps(tile, S, G, QT, causal, window, &q_lo);
    parts = f32_kv_parts(steps, chunk);
    if (part < parts) break;
    part -= parts;
  }
  const int k0 = tile * BKV;
  const int s0 = (int)((long long)part * steps / parts);
  const int n_steps = (int)((long long)(part + 1) * steps / parts) - s0;
  const int n_qt = steps / G;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int grp = warp % kWarps;        // the key group: keys [16 grp, 16 grp + 16)
  const bool first = warp < kWarps;     // S^T, P^T, dV (else dP^T, dS^T, dK)
  const int wk = grp * 16;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);   // (BKV, P)
  float* vs = ks + BKV * P;                         // (BKV, P)
  float* qs = vs + BKV * P;                         // ST x (QT, P)
  float* dos = qs + ST * QT * P;                    // ST x (QT, P)
  float* lse_s = dos + ST * QT * P;                 // ST x QT
  float* dl_s = lse_s + ST * QT;                    // ST x QT
  float* gs = dl_s + ST * QT + grp * 16 * GP;       // this pair's (16, GP): P^T (1 - t^2)

  auto prefetch = [&](int i) {
    const int hh = kvh * G + (s0 + i) / n_qt;
    const int qq = q_lo + (s0 + i) % n_qt * QT;
    const int st = i % ST;
    load_tile_f32_async<QT, D, THREADS>(qs + st * QT * P, q + b * sq.b + hh * sq.h, sq.s, qq,
                                        S, dh);
    load_tile_f32_async<QT, D, THREADS>(dos + st * QT * P, dout + b * sdo.b + hh * sdo.h,
                                        sdo.s, qq, S, dh);
    load_rows_async<QT, THREADS>(lse_s + st * QT, lse + ((long long)b * H + hh) * S, qq, S);
    load_rows_async<QT, THREADS>(dl_s + st * QT, delta + ((long long)b * H + hh) * S, qq, S);
  };

  load_tile_f32_async<BKV, D, THREADS>(ks, k + b * sk.b + kvh * sk.h, sk.s, k0, S, dh);
  load_tile_f32_async<BKV, D, THREADS>(vs, v + b * sv.b + kvh * sv.h, sv.s, k0, S, dh);
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    if (i < n_steps) prefetch(i);
    cp_async_commit();
  }

  float acc[OT][4];   // dV (first) or dK
#pragma unroll
  for (int j = 0; j < OT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const int kw_lo = k0 + wk, kw_hi = kw_lo + 15;
  const float* a_tile = first ? ks : vs;

  for (int i = 0; i < n_steps; ++i) {
    cp_async_wait<ST - 2>();
    __syncthreads();
    if (i + ST - 1 < n_steps) prefetch(i + ST - 1);
    cp_async_commit();
    const int q0 = q_lo + (s0 + i) % n_qt * QT;
    const int stage = i % ST;
    const float* qt = qs + stage * QT * P;
    const float* dt = dos + stage * QT * P;
    if ((causal && kw_lo > q0 + QT - 1) || (window > 0 && q0 - kw_hi >= window)) continue;

    // S^T = K Q^T (first) or dP^T = V dO^T over the whole head_dim
    const float* b_tile = first ? qt : dt;
    float x[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      uint32_t a[4];
      lda_f32<P>(a, a_tile, wk, 8 * kk, lane);
      const Split<4> sa = split_tf32<4>(a);
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        uint32_t bb[4];
        ldb_f32<P>(bb, b_tile, 16 * j, 8 * kk, lane);
        mma3(x[2 * j], sa, split_tf32<2>(bb));
        mma3(x[2 * j + 1], sa, split_tf32<2>(bb + 2));
      }
    }
    const bool need_mask = (causal && k0 + BKV - 1 > q0) ||
                           (window > 0 && q0 + QT - 1 - k0 >= window) || q0 + QT > S ||
                           k0 + BKV > S;
    if (first) {
      // P^T, and P^T (1 - t^2) for the pair's other warp; 0 where masked
      const float* lse_c = lse_s + stage * QT;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = lane / 4 + 8 * (e >> 1);
          const int c = 8 * j + 2 * (lane & 3) + (e & 1);
          float xs = x[j][e] * scale;
          float th = 0.f;
          if (softcap > 0.f) {
            th = tanhf(xs / softcap);
            xs = softcap * th;
          }
          float p = exp2f((xs - lse_c[c]) * kLog2e);
          if (need_mask && (q0 + c >= S || kw_lo + r >= S ||
                            !visible(q0 + c, kw_lo + r, causal, window)))
            p = 0.f;
          x[j][e] = p;
          gs[r * GP + c] = softcap > 0.f ? p * (1.f - th * th) : p;
        }
      }
      named_arrive(1 + grp, 64);
      // dV += P^T dO
      Split<4> pa[NT];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t a[4];
        c_to_a(a, x[j]);
        pa[j] = split_tf32<4>(a);
      }
#pragma unroll
      for (int n = 0; n < OT; ++n)
        mma3_tile_add<NT>(acc[n], pa, [&](int j, uint32_t* bb) {
          ldb_kn_f32<P>(bb, dt, 8 * j, 8 * n, lane);
        });
    } else {
      // dS^T = P^T (1 - t^2) (dP^T - delta)
      const float* dl_c = dl_s + stage * QT;
      named_sync(1 + grp, 64);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = lane / 4 + 8 * (e >> 1);
          const int c = 8 * j + 2 * (lane & 3) + (e & 1);
          x[j][e] = gs[r * GP + c] * (x[j][e] - dl_c[c]);
        }
      }
      // dK += dS^T Q
      Split<4> da[NT];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t a[4];
        c_to_a(a, x[j]);
        da[j] = split_tf32<4>(a);
      }
#pragma unroll
      for (int n = 0; n < OT; ++n)
        mma3_tile_add<NT>(acc[n], da, [&](int j, uint32_t* bb) {
          ldb_kn_f32<P>(bb, qt, 8 * j, 8 * n, lane);
        });
    }
  }

  const long long n_el = (long long)B * KV * S * dh;
  const float mul = first ? 1.f : scale;
  float* out = first ? dv : dk;
  const Strides so = first ? sdv : sdk;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int kpos = kw_lo + lane / 4 + 8 * hf;
    if (kpos >= S) continue;
    const long long row = ((long long)b * KV + kvh) * S + kpos;
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      if (col >= dh) continue;
      if (parts == 1) {
        *reinterpret_cast<float2*>(out + b * so.b + kvh * so.h + kpos * so.s + col) =
            make_float2(acc[j][2 * hf] * mul, acc[j][2 * hf + 1] * mul);
      } else {
        *reinterpret_cast<float2*>(partial + ((first ? max_parts : 0) + part) * n_el +
                                   row * dh + col) =
            make_float2(acc[j][2 * hf], acc[j][2 * hf + 1]);
      }
    }
  }
}

// dQ as flash_bwd_dq_f32_kernel computes it, with each 16-row group's work
// split between two warps of a block of 8: warp g (g < 4) forms S = Q K^T
// and P (times 1 - t^2 under a softcap), warp 4 + g forms dP = dO V^T; they
// trade P and dP through shared memory behind a named barrier of the pair,
// both form dS = P (dP - delta), and each adds dS K into half of dQ's
// columns.  Each warp holds half an accumulator (the single-warp kernel
// holds dQ, S and dP whole: 255 registers at D = 256).
template <int D>
__global__ void __launch_bounds__(2 * kThreads, 1)
    flash_bwd_dq_f32_pair_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                 const float* __restrict__ v, const float* __restrict__ dout,
                                 const float* __restrict__ lse, const float* __restrict__ delta,
                                 float* __restrict__ dq, Strides sq, Strides sk, Strides sv,
                                 Strides sdo, Strides sdq, int H, int KV, int S, int dh,
                                 int causal, int window, float scale, float softcap) {
  using T = F32Tiles<D>;
  constexpr int THREADS = 2 * kThreads;
  constexpr int BK = T::DQ_BK;
  constexpr int XP = BK + 8;    // the exchange's row pitch (floats)
  constexpr int BQ = kF32Rows;
  constexpr int P = T::P;
  constexpr int ST = T::STAGES;
  constexpr int NT = BK / 8;
  constexpr int HT = D / 16;    // n tiles of this warp's half of dQ
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int grp = warp % kWarps;        // rows [16 grp, 16 grp + 16) of the block
  const bool first = warp < kWarps;     // S and P (else dP)
  const int wr = grp * 16;
  const int c0 = first ? 0 : D / 2;     // this warp's dQ columns [c0, c0 + D / 2)

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);   // (BQ, P)
  float* dos = qs + BQ * P;                         // (BQ, P)
  float* ks = dos + BQ * P;                         // ST x (BK, P)
  float* vs = ks + ST * BK * P;                     // ST x (BK, P)
  float* xs = vs + ST * BK * P + grp * 2 * 16 * XP; // this pair's P (16, XP), then dP
  float* mine = xs + (first ? 0 : 16 * XP);
  const float* theirs = xs + (first ? 16 * XP : 0);

  const float* kg = k + b * sk.b + kvh * sk.h;
  const float* vg = v + b * sv.b + kvh * sv.h;
  int k_lo, k_hi;
  key_range(q0, BQ, S, causal, window, BK, &k_lo, &k_hi);
  const int n_tiles = (k_hi - k_lo + BK - 1) / BK;

  load_tile_f32_async<BQ, D, THREADS>(qs, q + b * sq.b + h * sq.h, sq.s, q0, S, dh);
  load_tile_f32_async<BQ, D, THREADS>(dos, dout + b * sdo.b + h * sdo.h, sdo.s, q0, S, dh);
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    if (i < n_tiles) {
      load_tile_f32_async<BK, D, THREADS>(ks + i * BK * P, kg, sk.s, k_lo + i * BK, S, dh);
      load_tile_f32_async<BK, D, THREADS>(vs + i * BK * P, vg, sv.s, k_lo + i * BK, S, dh);
    }
    cp_async_commit();
  }

  const float* lse_h = lse + ((long long)b * H + h) * S;
  const float* delta_h = delta + ((long long)b * H + h) * S;
  const int r0 = q0 + wr + lane / 4;
  const float lse0 = r0 < S ? lse_h[r0] : 0.f, lse1 = r0 + 8 < S ? lse_h[r0 + 8] : 0.f;
  const float dl0 = r0 < S ? delta_h[r0] : 0.f, dl1 = r0 + 8 < S ? delta_h[r0 + 8] : 0.f;

  float acc[HT][4];
#pragma unroll
  for (int j = 0; j < HT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const int r_lo = q0 + wr, r_hi = r_lo + 15;
  const float* a_tile = first ? qs : dos;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<ST - 2>();
    __syncthreads();
    if (t + ST - 1 < n_tiles) {
      const int nxt = (t + ST - 1) % ST;
      const int kn = k_lo + (t + ST - 1) * BK;
      load_tile_f32_async<BK, D, THREADS>(ks + nxt * BK * P, kg, sk.s, kn, S, dh);
      load_tile_f32_async<BK, D, THREADS>(vs + nxt * BK * P, vg, sv.s, kn, S, dh);
    }
    cp_async_commit();
    const int k0 = k_lo + t * BK;
    const float* kt = ks + (t % ST) * BK * P;
    const float* b_tile = first ? kt : vs + (t % ST) * BK * P;
    if ((causal && k0 > r_hi) || (window > 0 && r_lo - (k0 + BK - 1) >= window)) continue;

    // S = Q K^T (first) or dP = dO V^T over the whole head_dim
    float x[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      uint32_t a[4];
      lda_f32<P>(a, a_tile, wr, 8 * kk, lane);
      const Split<4> sa = split_tf32<4>(a);
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        uint32_t bb[4];
        ldb_f32<P>(bb, b_tile, 16 * j, 8 * kk, lane);
        mma3(x[2 * j], sa, split_tf32<2>(bb));
        mma3(x[2 * j + 1], sa, split_tf32<2>(bb + 2));
      }
    }
    const bool need_mask = (causal && k0 + BK - 1 > r_lo) ||
                           (window > 0 && r_hi - k0 >= window) || k0 + BK > S ||
                           q0 + BQ > S;
    if (first) {
      // P (1 - t^2 under a softcap), 0 where masked
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = lane / 4 + 8 * (e >> 1);
          const int c = 8 * j + 2 * (lane & 3) + (e & 1);
          float xv = x[j][e] * scale;
          float th = 0.f;
          if (softcap > 0.f) {
            th = tanhf(xv / softcap);
            xv = softcap * th;
          }
          float p = exp2f((xv - ((e >> 1) ? lse1 : lse0)) * kLog2e);
          if (need_mask && (r_lo + r >= S || k0 + c >= S ||
                            !visible(r_lo + r, k0 + c, causal, window)))
            p = 0.f;
          if (softcap > 0.f) p *= 1.f - th * th;
          x[j][e] = p;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        mine[(lane / 4 + 8 * (e >> 1)) * XP + 8 * j + 2 * (lane & 3) + (e & 1)] = x[j][e];
    }
    named_sync(1 + grp, 64);
    // dS = P (dP - delta)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float other =
            theirs[(lane / 4 + 8 * (e >> 1)) * XP + 8 * j + 2 * (lane & 3) + (e & 1)];
        const float p = first ? x[j][e] : other;
        const float dp = first ? other : x[j][e];
        x[j][e] = p * (dp - ((e >> 1) ? dl1 : dl0));
      }
    }
    // dQ[:, c0 .. c0 + D / 2) += dS K
    Split<4> da[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t a[4];
      c_to_a(a, x[j]);
      da[j] = split_tf32<4>(a);
    }
#pragma unroll
    for (int n = 0; n < HT; ++n)
      mma3_tile_add<NT>(acc[n], da, [&](int j, uint32_t* bb) {
        ldb_kn_f32<P>(bb, kt, 8 * j, c0 + 8 * n, lane);
      });
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = r0 + 8 * hf;
    if (row >= S) continue;
    float* p = dq + b * sdq.b + h * sdq.h + row * sdq.s;
#pragma unroll
    for (int j = 0; j < HT; ++j) {
      const int col = c0 + 8 * j + 2 * (lane & 3);
      if (col < dh)
        *reinterpret_cast<float2*>(p + col) =
            make_float2(acc[j][2 * hf] * scale, acc[j][2 * hf + 1] * scale);
    }
  }
}

// dK = scale x the sum of the dK partials, dV the sum of the dV partials,
// parts in order (the same bits every run), for the keys of tiles cut into
// more than one part (the others were written whole); two columns a
// thread.
__global__ void flash_bwd_dkv_sum_f32_kernel(const float* __restrict__ partial,
                                             float* __restrict__ dk, float* __restrict__ dv,
                                             Strides sdk, Strides sdv, int chunk, int max_parts,
                                             int B, int H, int KV, int S, int dh, int QT,
                                             int causal, int window, float scale) {
  const long long n = (long long)B * KV * S * dh;
  const long long e = 2 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  if (e >= n) return;
  const int col = (int)(e % dh);
  const long long row = e / dh;
  const int s = (int)(row % S);
  int q_lo;
  const int parts = f32_kv_parts(f32_kv_steps(s / kF32Rows, S, H / KV, QT, causal, window,
                                              &q_lo),
                                 chunk);
  if (parts == 1) return;
  float2 sk = make_float2(0.f, 0.f), sv = make_float2(0.f, 0.f);
  for (int p = 0; p < parts; ++p) {
    const float2 x = *reinterpret_cast<const float2*>(partial + p * n + e);
    const float2 y = *reinterpret_cast<const float2*>(partial + (max_parts + p) * n + e);
    sk.x += x.x;
    sk.y += x.y;
    sv.x += y.x;
    sv.y += y.y;
  }
  const int kvh = (int)((row / S) % KV);
  const int b = (int)(row / ((long long)S * KV));
  *reinterpret_cast<float2*>(dk + b * sdk.b + kvh * sdk.h + s * sdk.s + col) =
      make_float2(sk.x * scale, sk.y * scale);
  *reinterpret_cast<float2*>(dv + b * sdv.b + kvh * sdv.h + s * sdv.s + col) = sv;
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *o, *dout;
  void *out, *lse, *dq, *dk, *dv, *delta;
  int B, H, KV, S, dh, causal, window;
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

template <typename T>
int launch_delta(const Args& a) {
  const long long rows = (long long)a.B * a.H * a.S;   // 16 per 256-thread block
  flash_bwd_delta_kernel<T><<<(unsigned)((rows + 15) / 16), 256, 0, a.stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), static_cast<float*>(a.delta),
      a.so, a.sdo, a.B, a.H, a.S, a.dh);
  return (int)cudaGetLastError();
}

template <int D>
int launch_fwd_bf16(const Args& a) {
  constexpr int BQ = 16 * kWarps;
  const size_t smem = sizeof(bf16) * (size_t)(BQ + 4 * kFwdBK) * (D + 8);
  auto kernel = flash_fwd_bf16_kernel<D>;
  int err = set_smem(kernel, smem);
  if (err) return err;
  kernel<<<dim3(a.H, a.B, cdiv(a.S, BQ)), kThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.out), static_cast<float*>(a.lse),
      a.sq, a.sk, a.sv, a.so, a.H, a.KV, a.S, a.dh, a.causal, a.window, a.scale, a.softcap);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bwd_bf16(const Args& a) {
  int err = launch_delta<bf16>(a);
  if (err) return err;

  constexpr int QT = kDkvQueryTile;
  const size_t smem_kv =
      sizeof(bf16) * (size_t)(2 * 16 * kWarps + 4 * QT) * (D + 8) + sizeof(float) * 4 * QT;
  auto kv_kernel = flash_bwd_dkv_bf16_kernel<D>;
  if ((err = set_smem(kv_kernel, smem_kv))) return err;
  kv_kernel<<<dim3(a.KV * dkv_split(D), a.B, cdiv(a.S, 16 * kWarps)), kThreads, smem_kv,
              a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.sq, a.sk, a.sv, a.sdo, a.sdk,
      a.sdv, a.H, a.KV, a.S, a.dh, a.causal, a.window, a.scale, a.softcap);
  if ((err = (int)cudaGetLastError())) return err;

  const size_t smem_q = sizeof(bf16) * (size_t)(2 * 16 * kWarps + 4 * kDqKeyTile) * (D + 8);
  auto q_kernel = flash_bwd_dq_bf16_kernel<D>;
  if ((err = set_smem(q_kernel, smem_q))) return err;
  q_kernel<<<dim3(a.H, a.B, cdiv(a.S, 16 * kWarps)), kThreads, smem_q, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<bf16*>(a.dq), a.sq, a.sk, a.sv, a.sdo, a.sdq, a.H, a.KV, a.S, a.dh, a.causal,
      a.window, a.scale, a.softcap);
  return (int)cudaGetLastError();
}

template <int D>
int launch_fwd_wgmma(const Args& a) {
  using C = sm90::Fwd<D>;
  CUtensorMap tq, tk, tv;
  int err;
  if ((err = sm90::make_map(&tq, a.q, a.sq, a.B, a.H, a.S, a.dh))) return err;
  if ((err = sm90::make_map(&tk, a.k, a.sk, a.B, a.KV, a.S, a.dh))) return err;
  if ((err = sm90::make_map(&tv, a.v, a.sv, a.B, a.KV, a.S, a.dh))) return err;
  const int smem = sm90::smem_bytes(D, C::NWG + 2 * C::STAGES, 2 * C::STAGES + 1, 0);
  auto kernel = sm90::flash_fwd_wgmma_kernel<D, C::NWG, C::STAGES>;
  if ((err = set_smem(kernel, smem))) return err;
  kernel<<<dim3(cdiv(a.S, sm90::kTileRows * C::NWG), a.H, a.B), 128 * (C::NWG + 1), smem,
           a.stream>>>(tq, tk, tv, static_cast<bf16*>(a.out), static_cast<float*>(a.lse), a.so,
                       a.H, a.KV, a.S, a.dh, a.window, a.scale, a.softcap);
  return (int)cudaGetLastError();
}

// prep (lse2, delta), dK/dV (+ the sum of its partials when it splits the
// heads), dQ.  a.delta is the workspace (sm90::workspace_floats).
template <int D>
int launch_bwd_wgmma(const Args& a) {
  CUtensorMap tq, tk, tv, tdo;
  int err;
  if ((err = sm90::make_map(&tq, a.q, a.sq, a.B, a.H, a.S, a.dh))) return err;
  if ((err = sm90::make_map(&tk, a.k, a.sk, a.B, a.KV, a.S, a.dh))) return err;
  if ((err = sm90::make_map(&tv, a.v, a.sv, a.B, a.KV, a.S, a.dh))) return err;
  if ((err = sm90::make_map(&tdo, a.dout, a.sdo, a.B, a.H, a.S, a.dh))) return err;
  const int S_pad = sm90::pad_rows(a.S);
  float* lse2 = static_cast<float*>(a.delta);
  float* delta = lse2 + (long long)a.B * a.H * S_pad;
  float* partial = delta + (long long)a.B * a.H * S_pad;

  const long long threads = (long long)a.B * a.H * S_pad * (D / 8);   // D / 8 lanes per row
  sm90::flash_bwd_prep_kernel<D / 8><<<(unsigned)((threads + 255) / 256), 256, 0, a.stream>>>(
      static_cast<const bf16*>(a.o), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), lse2, delta, a.so, a.sdo, a.B, a.H, a.S, S_pad, a.dh);
  if ((err = (int)cudaGetLastError())) return err;

  using KVc = sm90::Dkv<D>;
  const int bn = sm90::kTileRows * KVc::NWG;
  const int parts = sm90::dkv_parts(a.B, a.H, a.KV, a.S, bn);
  const int smem_kv = sm90::smem_bytes(D, 2 * KVc::NWG + 2 * KVc::STAGES, 2 * KVc::STAGES + 1,
                                       2 * KVc::STAGES * sm90::kTileRows * 4);
  auto kv_kernel = sm90::flash_bwd_dkv_wgmma_kernel<D, KVc::NWG, KVc::STAGES>;
  if ((err = set_smem(kv_kernel, smem_kv))) return err;
  kv_kernel<<<dim3(cdiv(a.S, bn), a.KV * parts, a.B), 128 * (KVc::NWG + 1), smem_kv,
              a.stream>>>(tq, tk, tv, tdo, lse2, delta, static_cast<bf16*>(a.dk),
                          static_cast<bf16*>(a.dv), a.sdk, a.sdv, partial, parts, a.B, a.H, a.KV,
                          a.S, S_pad, a.dh, a.window, a.scale, a.softcap);
  if ((err = (int)cudaGetLastError())) return err;
  if (parts > 1) {
    const long long pairs = (long long)a.B * a.KV * a.S * a.dh / 2;
    sm90::flash_bwd_dkv_sum_kernel<<<(unsigned)((pairs + 255) / 256), 256, 0, a.stream>>>(
        partial, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.sdk, a.sdv, parts, a.B,
        a.KV, a.S, a.dh, a.scale);
    if ((err = (int)cudaGetLastError())) return err;
  }

  using Qc = sm90::Dq<D>;
  const int smem_q = sm90::smem_bytes(D, 2 * Qc::NWG + 2 * Qc::STAGES, 2 * Qc::STAGES + 1, 0);
  auto q_kernel = sm90::flash_bwd_dq_wgmma_kernel<D, Qc::NWG, Qc::STAGES>;
  if ((err = set_smem(q_kernel, smem_q))) return err;
  q_kernel<<<dim3(cdiv(a.S, sm90::kTileRows * Qc::NWG), a.H, a.B), 128 * (Qc::NWG + 1), smem_q,
             a.stream>>>(tq, tk, tv, tdo, lse2, delta, static_cast<bf16*>(a.dq), a.sdq, a.H, a.KV,
                         a.S, S_pad, a.dh, a.window, a.scale, a.softcap);
  return (int)cudaGetLastError();
}

// How the fp32 dK/dV kernel cuts its work: `chunk`, the most steps a block
// takes (an even share of all steps over two blocks an SM, or a whole key
// tile's where that is more); `blocks` along x, the key tiles' parts
// together; `max_parts`, the most parts of one tile (1: no partials).
struct F32KvPlan {
  int chunk, blocks, max_parts;
};

template <int D>
F32KvPlan f32_kv_plan(int B, int H, int KV, int S, int causal, int window) {
  constexpr int QT = F32Tiles<D>::KV_QT;
  const int G = H / KV, tiles = cdiv(S, kF32Rows);
  long long total = 0;
  int most = 1, q_lo;
  for (int t = 0; t < tiles; ++t) {
    const int steps = f32_kv_steps(t, S, G, QT, causal, window, &q_lo);
    total += steps;
    most = steps > most ? steps : most;
  }
  const long long others = (long long)KV * B;   // grid y and z
  const long long want = 2LL * sm90::sm_count();
  long long chunk = (total * others + want - 1) / want;
  chunk = chunk < 1 ? 1 : (chunk > most ? most : chunk);
  F32KvPlan plan{(int)chunk, 0, f32_kv_parts(most, (int)chunk)};
  for (int t = 0; t < tiles; ++t)
    plan.blocks += f32_kv_parts(f32_kv_steps(t, S, G, QT, causal, window, &q_lo), plan.chunk);
  return plan;
}

// floats of the fp32 backward's delta, (B, H, S), rounded up to 16 bytes
// so that the dK/dV partials after it are aligned
inline long long f32_delta_floats(int B, int H, int S) {
  return ((long long)B * H * S + 3) / 4 * 4;
}

inline long long f32_workspace_floats(int B, int H, int KV, int S, int dh, int causal,
                                      int window) {
  const int parts = (dh <= 64    ? f32_kv_plan<64>(B, H, KV, S, causal, window)
                     : dh <= 128 ? f32_kv_plan<128>(B, H, KV, S, causal, window)
                                 : f32_kv_plan<256>(B, H, KV, S, causal, window))
                        .max_parts;
  return f32_delta_floats(B, H, S) + (parts > 1 ? 2LL * parts * B * KV * S * dh : 0);
}

template <int D>
int launch_fwd_f32(const Args& a) {
  using T = F32Tiles<D>;
  const size_t smem = sizeof(float) * (size_t)(kF32Rows + 2 * T::STAGES * T::FWD_BK) * T::P;
  auto kernel = flash_fwd_f32_kernel<D>;
  int err = set_smem(kernel, smem);
  if (err) return err;
  kernel<<<dim3(cdiv(a.S, kF32Rows), a.H, a.B), kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.out), static_cast<float*>(a.lse),
      a.sq, a.sk, a.sv, a.so, a.H, a.KV, a.S, a.dh, a.causal, a.window, a.scale, a.softcap);
  return (int)cudaGetLastError();
}

// delta, dK/dV (+ the sum of its partials when it splits the heads), dQ.
// a.delta is the workspace (f32_workspace_floats).
template <int D>
int launch_bwd_f32(const Args& a) {
  using T = F32Tiles<D>;
  int err = launch_delta<float>(a);
  if (err) return err;

  const F32KvPlan plan = f32_kv_plan<D>(a.B, a.H, a.KV, a.S, a.causal, a.window);
  float* partial = static_cast<float*>(a.delta) + f32_delta_floats(a.B, a.H, a.S);
  const dim3 kv_grid(plan.blocks, a.KV, a.B);
  if constexpr (T::PAIRS) {
    constexpr int QT = T::KV_QT;
    const size_t smem = sizeof(float) * ((size_t)(2 * kF32Rows + 2 * T::STAGES * QT) * T::P +
                                         2 * T::STAGES * QT + kWarps * 16 * (QT + 8));
    auto kernel = flash_bwd_dkv_f32_pair_kernel<D>;
    if ((err = set_smem(kernel, smem))) return err;
    kernel<<<kv_grid, 2 * kThreads, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.sq, a.sk, a.sv, a.sdo, a.sdk,
        a.sdv, partial, plan.chunk, plan.max_parts, a.B, a.H, a.KV, a.S, a.dh, a.causal,
        a.window, a.scale, a.softcap);
  } else {
    const size_t smem = sizeof(float) * ((size_t)(2 * kF32Rows + 2 * T::STAGES * T::KV_QT) *
                                             T::P +
                                         2 * T::STAGES * T::KV_QT);
    auto kernel = flash_bwd_dkv_f32_kernel<D>;
    if ((err = set_smem(kernel, smem))) return err;
    kernel<<<kv_grid, kThreads, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.sq, a.sk, a.sv, a.sdo, a.sdk,
        a.sdv, partial, plan.chunk, plan.max_parts, a.B, a.H, a.KV, a.S, a.dh, a.causal,
        a.window, a.scale, a.softcap);
  }
  if ((err = (int)cudaGetLastError())) return err;
  if (plan.max_parts > 1) {
    const long long pairs = (long long)a.B * a.KV * a.S * a.dh / 2;
    flash_bwd_dkv_sum_f32_kernel<<<(unsigned)((pairs + 255) / 256), 256, 0, a.stream>>>(
        partial, static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.sdk, a.sdv, plan.chunk,
        plan.max_parts, a.B, a.H, a.KV, a.S, a.dh, T::KV_QT, a.causal, a.window, a.scale);
    if ((err = (int)cudaGetLastError())) return err;
  }

  const dim3 q_grid(cdiv(a.S, kF32Rows), a.H, a.B);
  if constexpr (T::PAIRS) {
    constexpr int BK = T::DQ_BK;
    const size_t smem = sizeof(float) * ((size_t)(2 * kF32Rows + 2 * T::STAGES * BK) * T::P +
                                         kWarps * 2 * 16 * (BK + 8));
    auto kernel = flash_bwd_dq_f32_pair_kernel<D>;
    if ((err = set_smem(kernel, smem))) return err;
    kernel<<<q_grid, 2 * kThreads, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<float*>(a.dq), a.sq, a.sk, a.sv, a.sdo, a.sdq, a.H, a.KV, a.S, a.dh,
        a.causal, a.window, a.scale, a.softcap);
  } else {
    const size_t smem =
        sizeof(float) * (size_t)(2 * kF32Rows + 2 * T::STAGES * T::DQ_BK) * T::P;
    auto kernel = flash_bwd_dq_f32_kernel<D>;
    if ((err = set_smem(kernel, smem))) return err;
    kernel<<<q_grid, kThreads, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<float*>(a.dq), a.sq, a.sk, a.sv, a.sdo, a.sdq, a.H, a.KV, a.S, a.dh,
        a.causal, a.window, a.scale, a.softcap);
  }
  return (int)cudaGetLastError();
}

// The instance for head_dim: the next of 64, 128, 256 (any multiple of 8).
template <bool BWD, bool BF16>
int dispatch_head_dim(const Args& a) {
  if (a.dh < 8 || a.dh > 256 || a.dh % 8) return (int)cudaErrorInvalidValue;
  if (BF16) {
    if (a.dh <= 64) return BWD ? launch_bwd_bf16<64>(a) : launch_fwd_bf16<64>(a);
    if (a.dh <= 128) return BWD ? launch_bwd_bf16<128>(a) : launch_fwd_bf16<128>(a);
    return BWD ? launch_bwd_bf16<256>(a) : launch_fwd_bf16<256>(a);
  }
  if (a.dh <= 64) return BWD ? launch_bwd_f32<64>(a) : launch_fwd_f32<64>(a);
  if (a.dh <= 128) return BWD ? launch_bwd_f32<128>(a) : launch_fwd_f32<128>(a);
  return BWD ? launch_bwd_f32<256>(a) : launch_fwd_f32<256>(a);
}

// The route the wrapper chose (kernels/flash_attention.py: `route`):
// 0 fp32 (3xTF32 on mma.sync), 1 bf16 mma.sync (causal, or head_dim past 128),
// 2 bf16 wgmma (non-causal, head_dim up to 128).  A route given inputs
// that are not its own is refused.
template <bool BWD>
int dispatch(int route, const Args& a) {
  if (route == 0) return dispatch_head_dim<BWD, false>(a);
  if (route == 1) {
    if (!a.causal && a.dh <= 128) return (int)cudaErrorInvalidValue;
    return dispatch_head_dim<BWD, true>(a);
  }
  if (route == 2) {
    if (a.causal || a.dh < 8 || a.dh > 128 || a.dh % 8) return (int)cudaErrorInvalidValue;
    if (a.dh <= 64) return BWD ? launch_bwd_wgmma<64>(a) : launch_fwd_wgmma<64>(a);
    return BWD ? launch_bwd_wgmma<128>(a) : launch_fwd_wgmma<128>(a);
  }
  return (int)cudaErrorInvalidValue;
}

Strides strides_at(const long long* s, int i) { return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]}; }

}  // namespace

// route: 0 = float32 (3xTF32 on mma.sync), 1 = bfloat16 on mma.sync, 2 = bfloat16 on
// wgmma (see `dispatch`); every tensor but lse/delta has the route's dtype.
// head_dim: a multiple of 8 up to 256 (128 on route 2).  strides:
// (batch, head, sequence) element strides, three per tensor, in the order
// q, k, v, o.  window <= 0 means none, softcap <= 0 none.  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int route, int B, int H, int KV, int S,
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
  a.dh = head_dim;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  a.softcap = softcap;
  a.sq = strides_at(strides, 0);
  a.sk = strides_at(strides, 1);
  a.sv = strides_at(strides, 2);
  a.so = strides_at(strides, 3);
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch<false>(route, a);
}

// The floats of the backward's fp32 workspace (`delta` below) for these
// shapes: delta (B, H, S) on route 1; on route 0 delta, padded to 16
// bytes, on route 2 lse2 and delta padded; on routes 0 and 2 then the dK/dV
// partials when their blocks split the heads.
extern "C" long long flash_attention_bwd_workspace(int route, int B, int H, int KV, int S,
                                                   int head_dim, int causal, int window) {
  if (route == 2) return sm90::workspace_floats(B, H, KV, S, head_dim);
  if (route == 0) return f32_workspace_floats(B, H, KV, S, head_dim, causal, window);
  return (long long)B * H * S;
}

// Three launches (route 1: delta, dK/dV, dQ) or three to four (route 0:
// delta, dK/dV, the partials' sum, dQ; route 2: prep, dK/dV, the sum, dQ).
// strides: three per tensor in the order q, k, v, o, do, dq, dk, dv.  delta: the fp32 workspace
// (flash_attention_bwd_workspace floats).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* lse, const void* dout, void* dq, void* dk,
                                   void* dv, void* delta, int route, int B, int H, int KV, int S,
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
  a.dh = head_dim;
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
  return dispatch<true>(route, a);
}
