// Device code shared by the split decode-attention kernels for Hopper
// (decode_attention.cu, paged_decode_attention.cu): warp reductions, element
// conversions (int8 codes without the conversion unit), cp.async copies, the
// mma.sync m16n8k16 fragments, q's load into shared memory, and the
// in-launch merge of the splits' partials.  Each kernel's source includes it
// into its own library.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr int kMaxWarps = 8;
constexpr int kMinWarps = 4;
constexpr int kMaxHeadsPerWarp = 4;
constexpr int kStages = 2;      // depth of the cp.async ring
constexpr int kPad = 16;        // bytes after each K and V row in shared memory
constexpr int kMaxSplits = 64;  // two per lane in the combine
constexpr int kMmaRows = 16;    // query heads per tensor-core tile

// Bytes of q in shared memory: fp32 (group, D) for the CUDA cores, bf16
// (16, D + 8) for the tensor cores; room for the larger.
__host__ __device__ __forceinline__ int q_bytes(int group, int d) {
  return 4 * group * d > 2 * kMmaRows * (d + 8) ? 4 * group * d : 2 * kMmaRows * (d + 8);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ void store(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void store(float x, bf16* dst) { *dst = __float2bfloat16(x); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// BYTES (16, 8 or 4) from global to shared memory, asynchronously; `bytes`
// < BYTES zero-fills the rest (0: nothing is read).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
                 "r"(bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_u32(dst)), "l"(src),
                 "n"(BYTES), "r"(bytes));
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

// The part of (lo, hi) that pack_bf16 rounded away, as a bf16x2 register.
__device__ __forceinline__ uint32_t pack_bf16_rest(float lo, float hi, uint32_t packed) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&packed);
  return pack_bf16(lo - __low2float(v), hi - __high2float(v));
}

// Fragment addressing (m16n8k16; lane = 4 * g + c, g = lane / 4, c = lane % 4):
//   A 16x16: a0 (g, 2c..), a1 (g + 8, 2c..), a2 (g, 2c + 8..), a3 (g + 8, 2c + 8..)
//   B 16x8:  b0 (k 2c.., n g), b1 (k 2c + 8.., n g)
//   C 16x8:  c0, c1 (g, 2c..); c2, c3 (g + 8, 2c..)
// So a C fragment pair (n tiles 2j, 2j + 1), rounded to bf16, is the A
// fragment of the k16 step j.

// A fragment of rows [0, 16), columns [k0, k0 + 16) of a row-major shared
// tile with pitch P (elements).
template <int P>
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* tile, int k0, int lane) {
  ldsm_x4(a, tile + (lane & 15) * P + k0 + (lane >> 4) * 8);
}

// B fragments of two n tiles from a tile stored (n, k): b[0], b[1] for rows
// n0..n0+7, b[2], b[3] for n0+8..n0+15, columns k0..k0+15.  For S = q K^T.
template <int P>
__device__ __forceinline__ void load_b(uint32_t* b, const bf16* tile, int n0, int k0, int lane) {
  ldsm_x4(b, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * P + k0 + ((lane >> 3) & 1) * 8);
}

// B fragments of two n tiles from a tile stored (k, n): rows k0..k0+15,
// columns n0..n0+7 (b[0], b[1]) and n0+8..n0+15 (b[2], b[3]).  For P V.
template <int P>
__device__ __forceinline__ void load_b_trans(uint32_t* b, const bf16* tile, int k0, int n0,
                                             int lane) {
  ldsm_x4_trans(b, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * P + n0 + (lane >> 4) * 8);
}

template <int BYTES>
struct Raw;
template <>
struct Raw<16> { using type = uint4; };
template <>
struct Raw<8> { using type = uint2; };
template <>
struct Raw<4> { using type = unsigned; };
template <>
struct Raw<2> { using type = unsigned short; };
template <>
struct Raw<1> { using type = unsigned char; };

// N elements of T (N * sizeof(T) bytes, aligned to min(that, 16)) widened
// to floats in registers.
template <typename T, int N>
__device__ __forceinline__ void load_floats(const T* src, float* dst) {
  constexpr int BYTES = N * (int)sizeof(T) > 16 ? 16 : N * (int)sizeof(T);
  constexpr int PER = BYTES / (int)sizeof(T);
  using R = typename Raw<BYTES>::type;
#pragma unroll
  for (int i = 0; i < N; i += PER) {
    const R raw = *reinterpret_cast<const R*>(src + i);
    if constexpr (std::is_same<T, int8_t>::value && BYTES >= 4) {
      // int8 codes without the conversion unit: the float with bits
      // 0x4B0000uu is 2^23 + uu, and uu = code + 128 (code ^ 0x80)
      const unsigned* w = reinterpret_cast<const unsigned*>(&raw);
#pragma unroll
      for (int j = 0; j < BYTES / 4; ++j) {
        const unsigned x = w[j] ^ 0x80808080u;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dst[i + 4 * j + e] = __int_as_float(__byte_perm(x, 0x4B000000u, 0x7440 + e)) - 8388736.f;
      }
    } else {
      const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < PER; ++j) dst[i + j] = to_float(x[j]);
    }
  }
}

template <int N>
__device__ __forceinline__ void store_cg(const float* x, float* dst) {
  if constexpr (N >= 4) {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      __stcg(reinterpret_cast<float4*>(dst + i), make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]));
  } else if constexpr (N == 2) {
    __stcg(reinterpret_cast<float2*>(dst), make_float2(x[0], x[1]));
  } else {
    __stcg(dst, x[0]);
  }
}

// The group's q (contiguous, 16-byte aligned) into shared memory: rows of
// pitch P, each element f(value); zeros past head_dim and in rows from
// `group` to `rows`.  Every thread issues all its 16-byte loads before it
// uses the first.
template <typename T, typename S, int P, typename F>
__device__ __forceinline__ void load_q(const T* __restrict__ qb, S* q_s, int group, int rows,
                                       int head_dim, F f) {
  constexpr int QV = 16 / (int)sizeof(T);
  constexpr int BATCH = 8;
  const int nvec = group * head_dim / QV;
  for (int x0 = threadIdx.x; x0 < nvec; x0 += BATCH * blockDim.x) {
    uint4 raw[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int x = x0 + k * blockDim.x;
      if (x < nvec) raw[k] = __ldg(reinterpret_cast<const uint4*>(qb) + x);
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int x = x0 + k * blockDim.x;
      if (x < nvec) {
        const int e = x * QV;
        const int g = e / head_dim;
        const int c = e - g * head_dim;
        const T* v = reinterpret_cast<const T*>(&raw[k]);
#pragma unroll
        for (int j = 0; j < QV; ++j) q_s[g * P + c + j] = f(v[j]);
      }
    }
  }
  // zeros: columns [head_dim, P) of the group's rows, every column after
  const int pad = P - head_dim;
  for (int x = threadIdx.x; x < group * pad + (rows - group) * P; x += blockDim.x) {
    const int g = x < group * pad ? x / pad : group + (x - group * pad) / P;
    const int c = x < group * pad ? head_dim + x - g * pad : (x - group * pad) % P;
    q_s[g * P + c] = S(0.f);
  }
}

// The end of a block of a split row, once its partial is written (acc at
// ws[((rowkv * splits + split) * group + g) * D], (m, l) after all
// rows * splits * group accumulators): fence, and bump the row's counter;
// the block that bumps it last zeroes it and merges the splits into `ob`.
// `comb`: group * (splits + 1) floats of shared memory.
template <typename T, int D>
__device__ __forceinline__ void merge(float* ws, int* counters, T* ob, float* comb,
                                      long long rows, long long rowkv, int splits, int group,
                                      int head_dim) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nthreads = blockDim.x;
  const int nwarps = nthreads >> 5;
  const float* ws_acc = ws;
  const float* ws_ml = ws + rows * splits * group * D;
  __threadfence();
  __syncthreads();
  __shared__ int last;
  if (tid == 0) {
    last = atomicAdd(counters + rowkv, 1) == splits - 1;
    if (last) counters[rowkv] = 0;  // zero again for the next launch
  }
  __syncthreads();
  if (!last) return;
  __threadfence();

  // weights e^(m_s - m*) per (head, split), 0 for an empty split, and
  // max(l*, 1e-30) per head, into shared memory; each warp loads the (m, l)
  // of all its heads before it uses the first
  const long long first = rowkv * splits * group;
  float* w_s = comb;                     // (group, splits)
  float* den_s = comb + group * splits;  // (group)
  for (int g0 = warp; g0 < group; g0 += kMaxHeadsPerWarp * nwarps) {
    float2 ml[kMaxHeadsPerWarp][2];
#pragma unroll
    for (int h = 0; h < kMaxHeadsPerWarp; ++h) {
      const int g = g0 + h * nwarps;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int sp = lane + 32 * r;
        ml[h][r] = make_float2(kNegInf, 0.f);
        if (g < group && sp < splits)
          ml[h][r] = __ldcg(
              reinterpret_cast<const float2*>(ws_ml + (first + (long long)sp * group + g) * 2));
      }
    }
#pragma unroll
    for (int h = 0; h < kMaxHeadsPerWarp; ++h) {
      const int g = g0 + h * nwarps;
      if (g >= group) break;  // uniform across the warp
      const float m_star = warp_max(fmaxf(ml[h][0].x, ml[h][1].x));
      float l_part = 0.f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int sp = lane + 32 * r;
        const float w = ml[h][r].y > 0.f ? expf(ml[h][r].x - m_star) : 0.f;
        if (sp < splits) w_s[g * splits + sp] = w;
        l_part += ml[h][r].y * w;
      }
      const float l_star = warp_sum(l_part);
      if (lane == 0) den_s[g] = fmaxf(l_star, 1e-30f);
    }
  }
  __syncthreads();
  // out = sum_s w_s acc_s / max(l*, 1e-30): each thread sums four columns
  // of one head's row, or of up to kItems heads' rows, over the splits,
  // with 16 loads in flight (16 splits of one row, or 2 of 8 rows)
  constexpr int Q4 = D / 4;
  constexpr int kItems = 8;  // >= group * D / 4 / threads: 8 * group <= threads
  const int items = group * Q4;
  auto finish = [&](int x, const float* o) {
    const int g = x / Q4;
    const int col = (x - g * Q4) * 4;
    if (col >= head_dim) return;
    const float denom = den_s[g];
#pragma unroll
    for (int e = 0; e < 4; ++e) store(o[e] / denom, ob + g * head_dim + col + e);
  };
  if (items <= nthreads) {
    const int x = tid;
    if (x >= items) return;
    const float* wg = w_s + (x / Q4) * splits;
    float o[4] = {0.f, 0.f, 0.f, 0.f};
    for (int s0 = 0; s0 < splits; s0 += 16) {
      float4 a[16];
#pragma unroll
      for (int s = 0; s < 16; ++s) {
        a[s] = make_float4(0.f, 0.f, 0.f, 0.f);
        // an empty split's acc was never written: not read
        if (s0 + s < splits && wg[s0 + s] != 0.f)
          a[s] = __ldcg(reinterpret_cast<const float4*>(
              ws_acc + (first + (long long)(s0 + s) * group) * D + (long long)x * 4));
      }
#pragma unroll
      for (int s = 0; s < 16; ++s) {
        const float w = s0 + s < splits ? wg[s0 + s] : 0.f;
        o[0] = fmaf(w, a[s].x, o[0]);
        o[1] = fmaf(w, a[s].y, o[1]);
        o[2] = fmaf(w, a[s].z, o[2]);
        o[3] = fmaf(w, a[s].w, o[3]);
      }
    }
    finish(x, o);
    return;
  }
  int head[kItems];
  float o[kItems][4];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int x = tid + k * nthreads;
    head[k] = x < items ? x / Q4 : -1;
#pragma unroll
    for (int e = 0; e < 4; ++e) o[k][e] = 0.f;
  }
#pragma unroll 2
  for (int sp = 0; sp < splits; ++sp) {
    float4 a[kItems];
    float w[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int x = tid + k * nthreads;
      w[k] = head[k] >= 0 ? w_s[head[k] * splits + sp] : 0.f;
      a[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (w[k] != 0.f)
        a[k] = __ldcg(reinterpret_cast<const float4*>(
            ws_acc + (first + (long long)sp * group) * D + (long long)x * 4));
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      o[k][0] = fmaf(w[k], a[k].x, o[k][0]);
      o[k][1] = fmaf(w[k], a[k].y, o[k][1]);
      o[k][2] = fmaf(w[k], a[k].z, o[k][2]);
      o[k][3] = fmaf(w[k], a[k].w, o[k][3]);
    }
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k)
    if (head[k] >= 0) finish(tid + k * nthreads, o[k]);
}

}  // namespace
