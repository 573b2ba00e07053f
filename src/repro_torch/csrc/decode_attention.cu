// Dense-cache decode attention for Hopper (sm_90a), with a plain C
// interface for ctypes.
//
// Replaces the Pallas TPU kernel `_decode_kernel` / `decode_attention` in
// src/repro/kernels/decode_attention.py: one query token per row, GQA,
// against a statically shaped KV cache whose slot index is the position.
//
//   q        (B, H, D)       fp32 or bf16, contiguous
//   k/v      (B, S, KV, D)   q's dtype, read in place by strides (the slot
//                            engine's per-layer cache view)
//   lengths  (B,)  int32     valid entries: positions 0..len-1
//   out      (B, H, D)       q's dtype
//
// head_dim is any multiple of 8 up to 256: the kernel is instantiated at
// the next of 32, 64, 128, 256 and takes the true head_dim at run time.
// Columns past it are zeros in the shared tiles and in q, and the lanes
// that hold them store nothing (the lane loop's bound), so D=120 runs the
// D=128 instance with the tail of the last lanes idle.
//
// Semantics are those of the TPU kernel and of `decode_attention_ref`:
// fp32 scores with the 1/sqrt(D) scale applied to q, position p valid iff
// p < len (and p >= len - window with a window), masked scores -1e30, fp32
// online softmax, output acc / max(l, 1e-30).  No softcap (the TPU kernel
// has none).
//
// Design.  The TPU grid (B, KV, S / block_k) ran its key axis in order and
// carried the softmax state in scratch, visiting every tile of the cache.
// Here one thread block owns one (row, KV head) and loops over key tiles
// itself, and it walks only the keys in [max(0, len - window), min(len, S)):
// a masked key adds exactly exp(-1e30 - m) = 0 once one key is valid, so
// skipping it is exact.  A row with no valid key (len <= 0, or a window
// that lies past S) averages V uniformly over all S, as the -1e30 fill does
// in the reference: the block then walks every key with a score of 0.
// Per tile, the whole block loads the (T, D) K and V tiles of its KV head
// into shared memory as fp32 with 16-byte loads, once for all G query
// heads of the group.  Each warp then runs the online-softmax update for
// one query head (or several, when G exceeds the warps): each lane holds
// D/32 elements of q and of the fp32 accumulator, and dot products are
// reduced with warp shuffles.
//
// Bound.  Decode attention does ~2 flops per byte read: it is bound by the
// bytes of live K/V it reads from device memory.  This first version keeps
// one tile in flight per block, and a long row runs on one block; splitting
// long rows over several blocks, asynchronous copies (cp.async / TMA) and
// tensor cores are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxWarps = 8;
constexpr int kMinWarps = 4;
constexpr int kMaxHeadsPerWarp = 4;
constexpr int kTile = 32;  // keys per shared-memory tile

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void store(float x, __nv_bfloat16* dst) { *dst = __float2bfloat16(x); }
__device__ __forceinline__ void store4(const float* x, float* dst) {
  *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
}

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

template <typename T, int D>
__global__ void decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const int* __restrict__ lengths,
                              T* __restrict__ out, int num_heads, int num_kv, int head_dim,
                              int seq_len,
                              long long stride_b, long long stride_s, long long stride_h,
                              int window, float scale) {
  constexpr int EPL = D / 32;          // head_dim elements per lane
  constexpr int VN = Vec16<T>::N;      // elements per 16-byte load
  constexpr int VPR = D / VN;          // 16-byte loads per (key, head) row
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int group = num_heads / num_kv;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;

  extern __shared__ float smem[];
  float* k_tile = smem;                      // (kTile, D)
  float* v_tile = k_tile + kTile * D;        // (kTile, D)
  float* my_scores = v_tile + kTile * D + warp * kTile;

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

  const long long base = (long long)b * stride_b + (long long)kvh * stride_h;
  for (int t0 = lo; t0 < hi; t0 += kTile) {
    const int n = hi - t0 < kTile ? hi - t0 : kTile;
    __syncthreads();  // every warp is done with the previous tiles
    for (int i = threadIdx.x; i < n * VPR; i += blockDim.x) {
      const int t = i / VPR;
      const int c = (i - t * VPR) * VN;
      const long long off = base + (long long)(t0 + t) * stride_s + c;
      float kr[VN] = {}, vr[VN] = {};   // zeros past head_dim
      if (c < head_dim) {
        Vec16<T>::load(k + off, kr);
        Vec16<T>::load(v + off, vr);
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
      float m_tile = kNegInf;
      for (int t = 0; t < n; ++t) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) part += qr[i][e] * k_tile[t * D + lane + 32 * e];
        const float s = uniform ? 0.f : warp_sum(part);
        if (lane == 0) my_scores[t] = s;
        m_tile = fmaxf(m_tile, s);
      }
      __syncwarp();
      const float m_new = fmaxf(m[i], m_tile);
      const float alpha = expf(m[i] - m_new);
      float p_sum = 0.f;
      float pv[EPL];
#pragma unroll
      for (int e = 0; e < EPL; ++e) pv[e] = 0.f;
      for (int t = 0; t < n; ++t) {
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
    T* o = out + ((long long)b * num_heads + kvh * group + g) * head_dim;
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      if (lane + 32 * e < head_dim) store(acc[i][e] / denom, o + lane + 32 * e);
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* lengths;
  void* out;
  int batch, num_heads, num_kv, head_dim, seq_len;
  long long stride_b, stride_s, stride_h;
  int window;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D>
int launch(const Args& a) {
  const int group = a.num_heads / a.num_kv;
  int nwarps = group < kMinWarps ? kMinWarps : group;
  if (nwarps > kMaxWarps) nwarps = kMaxWarps;
  if (group > nwarps * kMaxHeadsPerWarp) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)2 * kTile * D + (size_t)nwarps * kTile);
  auto kernel = decode_kernel<T, D>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3(a.batch, a.num_kv), nwarps * 32, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const int*>(a.lengths), static_cast<T*>(a.out), a.num_heads, a.num_kv,
      a.head_dim, a.seq_len, a.stride_b, a.stride_s, a.stride_h, a.window, a.scale);
  return (int)cudaGetLastError();
}

// The instance for head_dim: the next of 32, 64, 128, 256 (any multiple
// of 8 up to 256).
template <typename T>
int dispatch_head_dim(int head_dim, const Args& a) {
  if (head_dim < 8 || head_dim > 256 || head_dim % 8) return (int)cudaErrorInvalidValue;
  if (head_dim <= 32) return launch<T, 32>(a);
  if (head_dim <= 64) return launch<T, 64>(a);
  if (head_dim <= 128) return launch<T, 128>(a);
  return launch<T, 256>(a);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out).  Strides of k and v
// (equal) are in elements; their last (head_dim) stride must be 1.
// head_dim: a multiple of 8 up to 256.
// window <= 0 means none.  Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* lengths, void* out, int dtype, int batch,
                                int num_heads, int num_kv, int head_dim, int seq_len,
                                long long stride_b, long long stride_s, long long stride_h,
                                int window, float scale, void* stream) {
  const Args a{q,        k,        v,        lengths,  out,    batch,
               num_heads, num_kv,  head_dim, seq_len,  stride_b, stride_s, stride_h,
               window,   scale,    static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch_head_dim<float>(head_dim, a);
  if (dtype == 1) return dispatch_head_dim<__nv_bfloat16>(head_dim, a);
  return (int)cudaErrorInvalidValue;
}
