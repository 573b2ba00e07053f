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
// Design.  The TPU grid (B, W / 512, T / 256) ran its time axis in order and
// carried a (1, 512) state in VMEM scratch; its wrapper made fp32 copies of
// a and b and needed T % 256 == 0.  Here one thread owns one (batch,
// channel) pair for the whole sequence and keeps h in a register: blocks of
// 64 threads cover 64 neighbouring channels, so a warp's loads and stores
// of one step are one contiguous run of 32 values.  The loads of a_t and b_t
// do not depend on h: the loop is unrolled by kUnroll steps, whose 2 x
// kUnroll loads are all in flight before the first multiply-add, so the
// serial chain is one FMA per step.  a and b are read in their own dtypes
// (no fp32 copies) and any T >= 1 is taken.
//
// Bound.  2 loads and 1 store per element: the bytes of a, b and hs.  This
// first version parallelises over B x W only: at a one-sequence prefill (B =
// 1, W = 4096) that is 64 blocks on 132 SMs, each with kUnroll steps of loads
// in flight, well short of what it takes to fill the memory system.
// Splitting T into chunks (a first pass for each chunk's decay product and
// local state, a second to carry states across chunks) is the later work
// that spreads a prefill over the whole card.

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

}  // namespace

// dtypes: bit 0 set = a is bfloat16, bit 1 set = b is bfloat16 (else
// float32).  strides: 4 element strides, (batch, time) of a, then of b;
// the width stride of each must be 1.  Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int rglru_scan(const void* a, const void* b, const void* h0, void* hs,
                          void* h_last, int dtypes, int batch, int seq_len, int width,
                          const long long* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtypes) {
    case 0:
      return launch<float, float>(a, b, h0, hs, h_last, batch, seq_len, width, strides, s);
    case 1:
      return launch<__nv_bfloat16, float>(a, b, h0, hs, h_last, batch, seq_len, width,
                                          strides, s);
    case 2:
      return launch<float, __nv_bfloat16>(a, b, h0, hs, h_last, batch, seq_len, width,
                                          strides, s);
    case 3:
      return launch<__nv_bfloat16, __nv_bfloat16>(a, b, h0, hs, h_last, batch, seq_len,
                                                  width, strides, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
