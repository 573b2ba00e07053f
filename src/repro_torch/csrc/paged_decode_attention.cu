// Paged decode attention for Hopper (sm_90a), with a plain C interface for
// ctypes.
//
// Replaces the Pallas TPU kernel `_paged_kernel` /
// `paged_decode_attention` in src/repro/kernels/paged_decode_attention.py,
// both variants: one query token per sequence, GQA, against a shared page
// pool addressed through per-sequence block tables.
//
//   q            (B, H, D)            fp32 or bf16, contiguous
//   k/v pages    (N, page, KV, D)     q's dtype, or int8 codes; read in
//                                     place by strides
//   k/v scales   (N, page, KV) fp32   int8 pools only: per-(slot, kv-head)
//                                     scales, read in place by strides
//   block_tables (B, P) int32         physical page ids, -1 = unassigned
//   lengths      (B,)   int32         tokens written so far
//   out          (B, H, D)            q's dtype
//
// head_dim is any multiple of 8 up to 256: the kernel is instantiated at
// the next of 32, 64, 128, 256 and takes the true head_dim at run time.
// Columns past it are zeros in the shared tiles and in q, and the lanes
// that hold them store nothing (the lane loop's bound), so D=120 runs the
// D=128 instance with the tail of the last lanes idle.
//
// int8 pools (the TPU kernel's `quantized=True`): each code row is widened
// to fp32 and multiplied by its (slot, kv-head) scale as it lands in the
// shared-memory tile, so QK^T and PV see k * k_scale and v * v_scale in
// fp32, exactly as the reference dequantizes; a -1 table entry reads page
// 0's codes AND scales, like the TPU kernel's `scale_map`.
//
// Semantics are those of the TPU kernel: every one of the P table entries is
// visited (a -1 entry reads page 0 and is masked), scores are fp32 with the
// 1/sqrt(D) scale applied to q, an optional tanh softcap, masked scores are
// -1e30 (a fully masked row averages V uniformly), the online softmax starts
// from m = -1e30, l = 0, and the output is acc / max(l, 1e-30).
//
// Design.  The TPU grid (B, KV, P) ran its page axis in order and carried
// the softmax state in scratch; here one thread block owns one
// (sequence, KV head) and loops over the pages itself.  Per page, the whole
// block loads that page's (page, D) K and V tiles for its KV head into
// shared memory with 16-byte loads (8-byte for int8 rows whose head_dim is
// not a multiple of 16), once for all G query heads of the group
// (the GQA saving).  Each warp then runs the online-softmax update for one
// query head (or several, when G exceeds the warps): each lane holds D/32
// elements of q and of the fp32 accumulator, and dot products are reduced
// with warp shuffles.
//
// Bound.  Decode attention does ~2 flops per byte read: it is bound by the
// bytes of K/V it reads from device memory (an int8 pool: D + 4 bytes per
// (slot, kv-head) row instead of 2D for bf16).  This first version keeps one
// page in flight per block and loops over all P entries; splitting the
// pages of a long sequence over several blocks, double-buffering the tiles
// with cp.async/TMA, and stopping at ceil(length / page) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxWarps = 8;
constexpr int kMinWarps = 4;
constexpr int kMaxHeadsPerWarp = 4;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void store(float x, __nv_bfloat16* dst) { *dst = __float2bfloat16(x); }
// Four floats into shared memory as one 16-byte store (dst 16-byte aligned).
__device__ __forceinline__ void store4(const float* x, float* dst) {
  *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
}

// One vector of BYTES bytes of T, widened to floats (into registers).
template <typename T, int BYTES>
struct Vec;

template <>
struct Vec<float, 16> {
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
struct Vec<__nv_bfloat16, 16> {
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

template <>
struct Vec<int8_t, 16> {
  static constexpr int N = 16;
  __device__ __forceinline__ static void load(const int8_t* src, float* dst) {
    const int4 raw = *reinterpret_cast<const int4*>(src);
    const int words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int w = 0; w < 4; ++w) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dst[4 * w + j] = static_cast<float>(static_cast<int8_t>(words[w] >> (8 * j)));
    }
  }
};

// int8 rows of a head_dim that is a multiple of 8 but not of 16 (120) are
// 8-byte aligned only: their codes move 8 at a time.
template <>
struct Vec<int8_t, 8> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const int8_t* src, float* dst) {
    const int2 raw = *reinterpret_cast<const int2*>(src);
    const int words[2] = {raw.x, raw.y};
#pragma unroll
    for (int w = 0; w < 2; ++w) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dst[4 * w + j] = static_cast<float>(static_cast<int8_t>(words[w] >> (8 * j)));
    }
  }
};

// Tq: q and out; Tpool: the pages; QUANT: int8 pages with fp32 scales; VB:
// bytes per vector load of the pages (16, or 8 for int8 rows of 8 bytes'
// alignment).
template <typename Tq, typename Tpool, bool QUANT, int D, int VB>
__global__ void paged_decode_kernel(const Tq* __restrict__ q, const Tpool* __restrict__ k_pages,
                                    const Tpool* __restrict__ v_pages,
                                    const float* __restrict__ k_scales,
                                    const float* __restrict__ v_scales,
                                    const int* __restrict__ block_tables,
                                    const int* __restrict__ lengths, Tq* __restrict__ out,
                                    int num_heads, int num_kv, int head_dim,
                                    int pages_per_seq, int page_size,
                                    long long stride_page, long long stride_slot,
                                    long long stride_head, long long scale_stride_page,
                                    long long scale_stride_slot, long long scale_stride_head,
                                    float scale, float softcap) {
  constexpr int EPL = D / 32;          // head_dim elements per lane
  constexpr int VN = Vec<Tpool, VB>::N;  // pool elements per vector load
  constexpr int VPR = D / VN;          // vector loads per (slot, head) row
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int group = num_heads / num_kv;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;

  extern __shared__ float smem[];
  float* k_tile = smem;                           // (page_size, D)
  float* v_tile = k_tile + page_size * D;         // (page_size, D)
  float* my_scores = v_tile + page_size * D + warp * page_size;

  // Per query head of this warp: q (pre-scaled), running max, sum, acc.
  float qr[kMaxHeadsPerWarp][EPL];
  float acc[kMaxHeadsPerWarp][EPL];
  float m[kMaxHeadsPerWarp];
  float l[kMaxHeadsPerWarp];
#pragma unroll
  for (int i = 0; i < kMaxHeadsPerWarp; ++i) {
    const int g = warp + i * nwarps;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      acc[i][e] = 0.f;
      qr[i][e] = g < group && lane + 32 * e < head_dim
                     ? to_float(q[((long long)b * num_heads + kvh * group + g) * head_dim + lane +
                                  32 * e]) *
                           scale
                     : 0.f;
    }
  }

  const int length = lengths[b];
  const int* row = block_tables + (long long)b * pages_per_seq;
  for (int j = 0; j < pages_per_seq; ++j) {
    const int entry = row[j];
    const bool assigned = entry >= 0;
    const int phys = assigned ? entry : 0;  // -1 reads page 0 (codes and scales)
    const long long base = (long long)phys * stride_page + (long long)kvh * stride_head;
    const long long scale_base =
        (long long)phys * scale_stride_page + (long long)kvh * scale_stride_head;
    __syncthreads();  // every warp is done with the previous page's tiles
    for (int i = threadIdx.x; i < page_size * VPR; i += blockDim.x) {
      const int t = i / VPR;
      const int c = (i - t * VPR) * VN;
      const long long off = base + t * stride_slot + c;
      float kr[VN] = {}, vr[VN] = {};   // zeros past head_dim
      if (c < head_dim) {
        Vec<Tpool, VB>::load(k_pages + off, kr);
        Vec<Tpool, VB>::load(v_pages + off, vr);
      }
      if constexpr (QUANT) {
        const long long soff = scale_base + t * scale_stride_slot;
        const float ks = k_scales[soff];
        const float vs = v_scales[soff];
#pragma unroll
        for (int e = 0; e < VN; ++e) {
          kr[e] *= ks;
          vr[e] *= vs;
        }
      }
#pragma unroll
      for (int e = 0; e < VN; e += 4) {
        store4(kr + e, k_tile + t * D + c + e);
        store4(vr + e, v_tile + t * D + c + e);
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kMaxHeadsPerWarp; ++i) {
      if (warp + i * nwarps >= group) break;  // uniform across the warp
      float m_page = kNegInf;
      for (int t = 0; t < page_size; ++t) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) part += qr[i][e] * k_tile[t * D + lane + 32 * e];
        float s = warp_sum(part);
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        if (!(assigned && j * page_size + t < length)) s = kNegInf;
        if (lane == 0) my_scores[t] = s;
        m_page = fmaxf(m_page, s);
      }
      __syncwarp();
      const float m_new = fmaxf(m[i], m_page);
      const float alpha = expf(m[i] - m_new);
      float p_sum = 0.f;
      float pv[EPL];
#pragma unroll
      for (int e = 0; e < EPL; ++e) pv[e] = 0.f;
      for (int t = 0; t < page_size; ++t) {
        const float p = expf(my_scores[t] - m_new);
        p_sum += p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) pv[e] += p * v_tile[t * D + lane + 32 * e];
      }
      l[i] = l[i] * alpha + p_sum;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[i][e] = acc[i][e] * alpha + pv[e];
      m[i] = m_new;
      __syncwarp();  // my_scores is rewritten for the next head
    }
  }

#pragma unroll
  for (int i = 0; i < kMaxHeadsPerWarp; ++i) {
    const int g = warp + i * nwarps;
    if (g >= group) break;
    const float denom = fmaxf(l[i], 1e-30f);
    Tq* o = out + ((long long)b * num_heads + kvh * group + g) * head_dim;
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      if (lane + 32 * e < head_dim) store(acc[i][e] / denom, o + lane + 32 * e);
  }
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
  int batch, num_heads, num_kv, head_dim, pages_per_seq, page_size;
  long long stride_page, stride_slot, stride_head;
  long long scale_stride_page, scale_stride_slot, scale_stride_head;
  float scale, softcap;
  cudaStream_t stream;
};

template <typename Tq, typename Tpool, bool QUANT, int D, int VB>
int launch(const Args& a) {
  const int group = a.num_heads / a.num_kv;
  int nwarps = group < kMinWarps ? kMinWarps : group;
  if (nwarps > kMaxWarps) nwarps = kMaxWarps;
  if (group > nwarps * kMaxHeadsPerWarp) return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)2 * a.page_size * D + (size_t)nwarps * a.page_size);
  auto kernel = paged_decode_kernel<Tq, Tpool, QUANT, D, VB>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3(a.batch, a.num_kv), nwarps * 32, smem, a.stream>>>(
      static_cast<const Tq*>(a.q), static_cast<const Tpool*>(a.k_pages),
      static_cast<const Tpool*>(a.v_pages), static_cast<const float*>(a.k_scales),
      static_cast<const float*>(a.v_scales), static_cast<const int*>(a.block_tables),
      static_cast<const int*>(a.lengths), static_cast<Tq*>(a.out), a.num_heads, a.num_kv,
      a.head_dim, a.pages_per_seq, a.page_size, a.stride_page, a.stride_slot, a.stride_head,
      a.scale_stride_page, a.scale_stride_slot, a.scale_stride_head, a.scale, a.softcap);
  return (int)cudaGetLastError();
}

template <typename Tq, typename Tpool, bool QUANT, int VB>
int dispatch_instance(int head_dim, const Args& a) {
  if (head_dim <= 32) return launch<Tq, Tpool, QUANT, 32, VB>(a);
  if (head_dim <= 64) return launch<Tq, Tpool, QUANT, 64, VB>(a);
  if (head_dim <= 128) return launch<Tq, Tpool, QUANT, 128, VB>(a);
  return launch<Tq, Tpool, QUANT, 256, VB>(a);
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
// head_dim: a multiple of 8 up to 256.
// softcap <= 0 means none.  Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages, const void* k_scales,
    const void* v_scales, const void* block_tables, const void* lengths, void* out,
    int q_dtype, int pool_dtype, int batch, int num_heads, int num_kv, int head_dim,
    int pages_per_seq, int page_size, long long stride_page, long long stride_slot,
    long long stride_head, long long scale_stride_page, long long scale_stride_slot,
    long long scale_stride_head, float scale, float softcap, void* stream) {
  const Args a{q,           k_pages,     v_pages,     k_scales,          v_scales,
               block_tables, lengths,     out,         batch,             num_heads,
               num_kv,      head_dim,    pages_per_seq, page_size, stride_page,       stride_slot,
               stride_head, scale_stride_page, scale_stride_slot, scale_stride_head, scale,
               softcap,     static_cast<cudaStream_t>(stream)};
  if (q_dtype == 0 && pool_dtype == 0) return dispatch_head_dim<float, float, false>(head_dim, a);
  if (q_dtype == 1 && pool_dtype == 1)
    return dispatch_head_dim<__nv_bfloat16, __nv_bfloat16, false>(head_dim, a);
  if (q_dtype == 0 && pool_dtype == 2) return dispatch_head_dim<float, int8_t, true>(head_dim, a);
  if (q_dtype == 1 && pool_dtype == 2)
    return dispatch_head_dim<__nv_bfloat16, int8_t, true>(head_dim, a);
  return (int)cudaErrorInvalidValue;
}
