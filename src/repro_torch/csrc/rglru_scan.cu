// RG-LRU linear recurrence for Hopper (sm_90a), with a plain C interface for
// ctypes.
//
// Replaces the Pallas TPU kernel `_rglru_kernel` / `rglru_scan` in
// src/repro/kernels/rglru_scan.py:
//
//   h_t[w] = a_t[w] * h_{t-1}[w] + b_t[w]     elementwise over w, serial over t
//
//   a, b     (B, T, W)   each fp32 or bf16, read in place by strides (the
//                        width stride must be 1), widened to fp32
//   h0       (B, W)      fp32, contiguous
//   hs       (B, T, W)   fp32, contiguous: every h_t
//   h_last   (B, W)      fp32, contiguous: h_{T-1}
//
// Two routes, picked by the wrapper from static shapes
// (src/repro_torch/kernels/rglru_scan.py, `plan`):
//
// The direct route (decode, short T, or batches wide enough to fill the
// card).  The TPU grid (B, W / 512, T / 256) ran its time axis in order and
// carried a (1, 512) state in VMEM scratch; its wrapper made fp32 copies of
// a and b and needed T % 256 == 0.  Here one thread owns one (batch,
// channel) pair for the whole sequence and keeps h in a register: blocks of
// 64 threads cover 64 neighbouring channels, so a warp's loads and stores
// of one step are one contiguous run of 32 values.  The loads of a_t and b_t
// do not depend on h: the loop is unrolled by kUnroll steps, whose 2 x
// kUnroll loads are all in flight before the first multiply-add, so the
// serial chain is one FMA per step.  At a one-sequence prefill (B = 1, W =
// 4096) that is 64 blocks on 132 SMs, serial over T.
//
// The chunked route (prefill).  T is cut into chunks of L steps and two
// kernels run one thread per (batch, chunk, channel):
//   aggregate: the chunk's pair (prod_t a_t, its h from h = 0);
//   finish:    the incoming h folded from h0 through the preceding chunks'
//              pairs (h <- P h + H, at most T / L - 1 of them, loads all
//              independent of h), then the chunk rerun from it, writing hs
//              (and h_last from the last chunk).
// a and b are read twice (they are usually still in the 50 MB L2 at the
// second read) and hs written once.
//
// Both routes read a and b in their own dtypes (no fp32 copies) by
// strides and take any T >= 1.
//
// Bound.  2 loads and 1 store per element: the bytes of a, b and hs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kUnroll = 8;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename TA, typename TB>
__global__ void rglru_kernel(const TA* __restrict__ a, const TB* __restrict__ b,
                             const float* __restrict__ h0, float* __restrict__ hs,
                             float* __restrict__ h_last, int seq_len, int width,
                             long long a_sb, long long a_st, long long b_sb, long long b_st) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  const int bb = blockIdx.y;
  if (w >= width) return;
  const TA* ap = a + (long long)bb * a_sb + w;
  const TB* bp = b + (long long)bb * b_sb + w;
  float* out = hs + (long long)bb * seq_len * width + w;
  float h = h0[(long long)bb * width + w];

  int t = 0;
  for (; t + kUnroll <= seq_len; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      av[u] = to_float(ap[(long long)(t + u) * a_st]);
      bv[u] = to_float(bp[(long long)(t + u) * b_st]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = fmaf(av[u], h, bv[u]);
      out[(long long)(t + u) * width] = h;
    }
  }
  for (; t < seq_len; ++t) {
    h = fmaf(to_float(ap[(long long)t * a_st]), h, to_float(bp[(long long)t * b_st]));
    out[(long long)t * width] = h;
  }
  h_last[(long long)bb * width + w] = h;
}

template <typename TA, typename TB>
int launch(const void* a, const void* b, const void* h0, void* hs, void* h_last, int batch,
           int seq_len, int width, const long long* strides, cudaStream_t stream) {
  const dim3 grid((width + kThreads - 1) / kThreads, batch);
  rglru_kernel<TA, TB><<<grid, kThreads, 0, stream>>>(
      static_cast<const TA*>(a), static_cast<const TB*>(b), static_cast<const float*>(h0),
      static_cast<float*>(hs), static_cast<float*>(h_last), seq_len, width, strides[0],
      strides[1], strides[2], strides[3]);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The chunked route: grid (width / kChunkThreads, chunk, batch).
// ---------------------------------------------------------------------------

constexpr int kChunkThreads = 128;

struct ChunkArgs {
  long long a_sb, a_st, b_sb, b_st;
  int seq_len, width, chunk, num_chunks;
};

// h over steps [t0, t1) of one (batch, channel) from h, each step's loads in flight
// kUnroll at a time; prod (if given) multiplies in every a_t.
template <bool kStore, typename TA, typename TB>
__device__ __forceinline__ float run(const TA* ap, const TB* bp, float* out, float h, float* prod,
                                     int t0, int t1, long long a_st, long long b_st,
                                     int width) {
  float p = 1.f;
  int t = t0;
  for (; t + kUnroll <= t1; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      av[q] = to_float(ap[(long long)(t + q) * a_st]);
      bv[q] = to_float(bp[(long long)(t + q) * b_st]);
    }
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      h = fmaf(av[q], h, bv[q]);
      p *= av[q];
      if (kStore) out[(long long)(t + q) * width] = h;
    }
  }
  for (; t < t1; ++t) {
    const float av = to_float(ap[(long long)t * a_st]);
    h = fmaf(av, h, to_float(bp[(long long)t * b_st]));
    p *= av;
    if (kStore) out[(long long)t * width] = h;
  }
  if (prod) *prod = p;
  return h;
}

template <typename TA, typename TB>
__global__ void __launch_bounds__(kChunkThreads)
rglru_chunk_aggregate(const TA* __restrict__ a, const TB* __restrict__ b,
                      float* __restrict__ agg_a, float* __restrict__ agg_h, ChunkArgs g) {
  const int w = blockIdx.x * kChunkThreads + threadIdx.x;
  const int c = blockIdx.y, bb = blockIdx.z;
  if (w >= g.width) return;
  const int t0 = c * g.chunk, t1 = min(g.seq_len, t0 + g.chunk);
  float p;
  const float h = run<false>(a + bb * g.a_sb + w, b + bb * g.b_sb + w, nullptr, 0.f, &p, t0,
                             t1, g.a_st, g.b_st, g.width);
  const long long idx = ((long long)bb * g.num_chunks + c) * g.width + w;
  agg_a[idx] = p;
  agg_h[idx] = h;
}

template <typename TA, typename TB>
__global__ void __launch_bounds__(kChunkThreads)
rglru_chunk_finish(const TA* __restrict__ a, const TB* __restrict__ b,
                   const float* __restrict__ h0, const float* __restrict__ agg_a,
                   const float* __restrict__ agg_h, float* __restrict__ hs,
                   float* __restrict__ h_last, ChunkArgs g) {
  const int w = blockIdx.x * kChunkThreads + threadIdx.x;
  const int c = blockIdx.y, bb = blockIdx.z;
  if (w >= g.width) return;
  float h = h0[(long long)bb * g.width + w];
  const float* pa = agg_a + (long long)bb * g.num_chunks * g.width + w;
  const float* ph = agg_h + (long long)bb * g.num_chunks * g.width + w;
  int q0 = 0;
  for (; q0 + kUnroll <= c; q0 += kUnroll) {
    float av[kUnroll], hv[kUnroll];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      av[q] = pa[(long long)(q0 + q) * g.width];
      hv[q] = ph[(long long)(q0 + q) * g.width];
    }
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) h = fmaf(av[q], h, hv[q]);
  }
  for (; q0 < c; ++q0) h = fmaf(pa[(long long)q0 * g.width], h, ph[(long long)q0 * g.width]);
  const int t0 = c * g.chunk, t1 = min(g.seq_len, t0 + g.chunk);
  h = run<true>(a + bb * g.a_sb + w, b + bb * g.b_sb + w,
                hs + (long long)bb * g.seq_len * g.width + w, h, nullptr, t0, t1, g.a_st,
                g.b_st, g.width);
  if (c == g.num_chunks - 1) h_last[(long long)bb * g.width + w] = h;
}

template <typename TA, typename TB>
int launch_chunked(const void* a, const void* b, const void* h0, void* hs, void* h_last,
                   float* workspace, int batch, int seq_len, int width, int chunk,
                   const long long* strides, cudaStream_t stream) {
  ChunkArgs g{strides[0], strides[1], strides[2], strides[3], seq_len, width, chunk,
              (seq_len + chunk - 1) / chunk};
  float* agg_a = workspace;  // (B, chunks, W) each
  float* agg_h = workspace + (long long)batch * g.num_chunks * width;
  const dim3 grid((width + kChunkThreads - 1) / kChunkThreads, g.num_chunks, batch);
  rglru_chunk_aggregate<TA, TB><<<grid, kChunkThreads, 0, stream>>>(
      static_cast<const TA*>(a), static_cast<const TB*>(b), agg_a, agg_h, g);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rglru_chunk_finish<TA, TB><<<grid, kChunkThreads, 0, stream>>>(
      static_cast<const TA*>(a), static_cast<const TB*>(b), static_cast<const float*>(h0),
      agg_a, agg_h, static_cast<float*>(hs), static_cast<float*>(h_last), g);
  return (int)cudaGetLastError();
}

}  // namespace

// dtypes: bit 0 set = a is bfloat16, bit 1 set = b is bfloat16 (else
// float32).  strides: 4 element strides, (batch, time) of a, then of b;
// the width stride of each must be 1.  Each entry point returns
// cudaGetLastError() after its launches (0 = launched).

#define RGLRU_DISPATCH(CALL)                                      \
  switch (dtypes) {                                               \
    case 0: return CALL(float, float);                            \
    case 1: return CALL(__nv_bfloat16, float);                    \
    case 2: return CALL(float, __nv_bfloat16);                    \
    case 3: return CALL(__nv_bfloat16, __nv_bfloat16);            \
    default: return (int)cudaErrorInvalidValue;                   \
  }

// The direct route: one launch.
extern "C" int rglru_scan(const void* a, const void* b, const void* h0, void* hs,
                          void* h_last, int dtypes, int batch, int seq_len, int width,
                          const long long* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DIRECT(TA, TB) launch<TA, TB>(a, b, h0, hs, h_last, batch, seq_len, width, strides, s)
  RGLRU_DISPATCH(DIRECT)
#undef DIRECT
}

// The chunked route: two launches.  chunk: L >= 1.  workspace: 2 * B * ceil(T / L) * W
// fp32.
extern "C" int rglru_scan_chunked(const void* a, const void* b, const void* h0, void* hs,
                                  void* h_last, void* workspace, int dtypes, int batch,
                                  int seq_len, int width, int chunk, const long long* strides,
                                  void* stream) {
  if (chunk < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(workspace);
#define CHUNKED(TA, TB)                                                                     \
  launch_chunked<TA, TB>(a, b, h0, hs, h_last, ws, batch, seq_len, width, chunk, strides, s)
  RGLRU_DISPATCH(CHUNKED)
#undef CHUNKED
}
