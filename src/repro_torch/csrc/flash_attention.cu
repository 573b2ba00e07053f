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
// are -inf: they never count.  Any S is accepted.  Both routes visit only
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
// * fp32: the first version's kernels, fp32 FMAs on the CUDA cores (exact
//   enough for the fp32 gates at 2e-5).  A block holds a whole KV group
//   (128 threads per query head, D/2 accumulators each), so it needs
//   G x D <= 512 (D rounded up to 64, 128 or 256).
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

// Four 8x8 bf16 matrices from shared memory; lane i gives the address of
// row i % 8 of matrix i / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
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
template <int ROWS>
__device__ __forceinline__ void load_rows_async(float* dst, const float* src, int row0, int S) {
  for (int i = threadIdx.x; i < ROWS; i += kThreads) {
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
// fp32 route: fp32 FMAs on the CUDA cores
// ===========================================================================

constexpr int kF32BQ = 64;          // forward: query rows per head per block
constexpr int kF32BK = 32;          // forward: keys per tile
constexpr int kHeadThreads = 128;   // forward: threads per query head
constexpr int kBwdThreads = 256;
constexpr int kKvBK = 64;           // dK/dV kernel: keys per block
constexpr int kKvBQ = 32;           // dK/dV kernel: queries per tile
constexpr int kDqBQ = 64;           // dQ kernel: queries per block
constexpr int kDqBK = 32;           // dQ kernel: keys per tile

// Rows [row0, row0 + rows) of one (batch, head) into a shared tile of
// row pitch D + 1 (no bank conflicts on column walks), times `mul`; rows
// at or past S and columns at or past dh are zero.
template <int D>
__device__ __forceinline__ void load_tile_f32(const float* __restrict__ base, Strides st, int b,
                                              int head, int row0, int rows, int S, int dh,
                                              float mul, float* tile) {
  constexpr int VPR = D / 4;
  const float* p = base + b * st.b + head * st.h;
  for (int i = threadIdx.x; i < rows * VPR; i += blockDim.x) {
    const int r = i / VPR;
    const int c = (i - r * VPR) * 4;
    const int pos = row0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (pos < S && c < dh) x = *reinterpret_cast<const float4*>(p + pos * st.s + c);
    float* dst = tile + r * (D + 1) + c;
    dst[0] = x.x * mul;
    dst[1] = x.y * mul;
    dst[2] = x.z * mul;
    dst[3] = x.w * mul;
  }
}

template <int D>
__global__ void __launch_bounds__(kHeadThreads * (512 / D))
    flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, Strides sq, Strides sk, Strides sv,
                         Strides so, int H, int KV, int S, int dh, int causal, int window,
                         float scale, float softcap) {
  constexpr int LD = D + 1;
  constexpr int LDP = kF32BK + 1;
  constexpr int CPT = D / 8;  // accumulator columns per thread
  const int G = H / KV;
  const int q0 = blockIdx.x * kF32BQ;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int g = threadIdx.x / kHeadThreads;  // this thread's head in the group
  const int ht = threadIdx.x % kHeadThreads;
  const int tr = ht / 8;  // rows tr + 16 i
  const int tc = ht % 8;  // score columns tc + 8 j, accumulator columns tc + 8 c
  const int h = kvh * G + g;

  extern __shared__ float smem[];
  float* qs = smem;                     // G x (kF32BQ, LD): q * scale
  float* ks = qs + G * kF32BQ * LD;     // (kF32BK, LD)
  float* vs = ks + kF32BK * LD;         // (kF32BK, LD)
  float* ps = vs + kF32BK * LD;         // G x (kF32BQ, LDP): P of the tile
  const float* my_q = qs + g * kF32BQ * LD;
  float* my_p = ps + g * kF32BQ * LDP;

  for (int gg = 0; gg < G; ++gg)
    load_tile_f32<D>(q, sq, b, kvh * G + gg, q0, kF32BQ, S, dh, scale, qs + gg * kF32BQ * LD);

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  int k_lo, k_hi;
  key_range(q0, kF32BQ, S, causal, window, kF32BK, &k_lo, &k_hi);
  for (int k0 = k_lo; k0 < k_hi; k0 += kF32BK) {
    __syncthreads();  // every head is done with the previous tile
    load_tile_f32<D>(k, sk, b, kvh, k0, kF32BK, S, dh, 1.f, ks);
    load_tile_f32<D>(v, sv, b, kvh, k0, kF32BK, S, dh, 1.f, vs);
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
    for (int t = 0; t < kF32BK; ++t) {
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
    float* op = o + b * so.b + h * so.h + qpos * so.s;
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      if (tc + 8 * c < dh) op[tc + 8 * c] = acc[i][c] / denom;
    if (tc == 0) lse[((long long)b * H + h) * S + qpos] = m[i] + logf(l[i]);
  }
}

// dK, dV for a (batch, KV head, 64-key tile), summed over the G heads.
template <int D>
__global__ void __launch_bounds__(kBwdThreads)
    flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             float* __restrict__ dk, float* __restrict__ dv, Strides sq,
                             Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv,
                             int H, int KV, int S, int dh, int causal, int window, float scale,
                             float softcap) {
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

  load_tile_f32<D>(k, sk, b, kvh, k0, kKvBK, S, dh, 1.f, ks);
  load_tile_f32<D>(v, sv, b, kvh, k0, kKvBK, S, dh, 1.f, vs);

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
      load_tile_f32<D>(q, sq, b, h, q0, kKvBQ, S, dh, scale, qs);
      load_tile_f32<D>(dout, sdo, b, h, q0, kKvBQ, S, dh, 1.f, dos);
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
    float* dkp = dk + b * sdk.b + kvh * sdk.h + kpos * sdk.s;
    float* dvp = dv + b * sdv.b + kvh * sdv.h + kpos * sdv.s;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      if (tq + 16 * c >= dh) continue;
      dkp[tq + 16 * c] = dk_acc[i][c];  // q was stored pre-scaled
      dvp[tq + 16 * c] = dv_acc[i][c];
    }
  }
}

// dQ for a (batch, head, 64-row query tile).
template <int D>
__global__ void __launch_bounds__(kBwdThreads)
    flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            float* __restrict__ dq, Strides sq, Strides sk, Strides sv,
                            Strides sdo, Strides sdq, int H, int KV, int S, int dh, int causal,
                            int window, float scale, float softcap) {
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

  load_tile_f32<D>(q, sq, b, h, q0, kDqBQ, S, dh, scale, qs);
  load_tile_f32<D>(dout, sdo, b, h, q0, kDqBQ, S, dh, 1.f, dos);
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
    load_tile_f32<D>(k, sk, b, kvh, k0, kDqBK, S, dh, 1.f, ks);
    load_tile_f32<D>(v, sv, b, kvh, k0, kDqBK, S, dh, 1.f, vs);
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
    float* dqp = dq + b * sdq.b + h * sdq.h + qpos * sdq.s;
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      if (tc + 16 * c < dh) dqp[tc + 16 * c] = dq_acc[i][c] * scale;
  }
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

template <int D>
int launch_fwd_f32(const Args& a) {
  const int G = a.H / a.KV;
  if (G * D > 512) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)G * kF32BQ * (D + 1) + 2 * kF32BK * (D + 1) +
                                       (size_t)G * kF32BQ * (kF32BK + 1));
  auto kernel = flash_fwd_f32_kernel<D>;
  int err = set_smem(kernel, smem);
  if (err) return err;
  kernel<<<dim3(cdiv(a.S, kF32BQ), a.KV, a.B), G * kHeadThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.out), static_cast<float*>(a.lse),
      a.sq, a.sk, a.sv, a.so, a.H, a.KV, a.S, a.dh, a.causal, a.window, a.scale, a.softcap);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bwd_f32(const Args& a) {
  int err = launch_delta<float>(a);
  if (err) return err;

  const size_t smem_kv = sizeof(float) * (2 * kKvBK * (D + 1) + 2 * kKvBQ * (D + 1) +
                                          2 * kKvBK * (kKvBQ + 1) + 2 * kKvBQ);
  auto kv_kernel = flash_bwd_dkv_f32_kernel<D>;
  if ((err = set_smem(kv_kernel, smem_kv))) return err;
  kv_kernel<<<dim3(cdiv(a.S, kKvBK), a.KV, a.B), kBwdThreads, smem_kv, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.sq, a.sk, a.sv, a.sdo, a.sdk,
      a.sdv, a.H, a.KV, a.S, a.dh, a.causal, a.window, a.scale, a.softcap);
  if ((err = (int)cudaGetLastError())) return err;

  const size_t smem_q = sizeof(float) * (2 * kDqBQ * (D + 1) + 2 * kDqBK * (D + 1) +
                                         kDqBQ * (kDqBK + 1) + 2 * kDqBQ);
  auto q_kernel = flash_bwd_dq_f32_kernel<D>;
  if ((err = set_smem(q_kernel, smem_q))) return err;
  q_kernel<<<dim3(cdiv(a.S, kDqBQ), a.H, a.B), kBwdThreads, smem_q, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(a.dq), a.sq, a.sk, a.sv, a.sdo, a.sdq, a.H, a.KV, a.S, a.dh,
      a.causal, a.window, a.scale, a.softcap);
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
// 0 fp32 (CUDA cores), 1 bf16 mma.sync (causal, or head_dim past 128),
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

// route: 0 = float32 (CUDA cores), 1 = bfloat16 on mma.sync, 2 = bfloat16 on
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
// shapes: (B, H, S) on routes 0 and 1; on route 2 lse2 and delta padded,
// and the dK/dV partials when its blocks split the heads.
extern "C" long long flash_attention_bwd_workspace(int route, int B, int H, int KV, int S,
                                                   int head_dim) {
  if (route == 2) return sm90::workspace_floats(B, H, KV, S, head_dim);
  return (long long)B * H * S;
}

// Three launches (routes 0, 1: delta, dK/dV, dQ) or three to four (route
// 2: prep, dK/dV, the partials' sum, dQ).  strides: three per tensor in the
// order q, k, v, o, do, dq, dk, dv.  delta: the fp32 workspace
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
