// RWKV-6 WKV recurrence for Hopper (sm_90a), with a plain C interface for
// ctypes.
//
// Replaces the Pallas TPU kernel `_wkv_kernel` / `rwkv6_scan` in
// src/repro/kernels/rwkv6_scan.py:
//
//   y_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//   S[i][j] <- w_t[i] * S[i][j] + k_t[i] * v_t[j]
//
//   r, k, v, w  (B, T, H, D)   each fp32 or bf16, read in place by strides
//                              (the model hands over bf16 r/k/v, fp32 w)
//   u           (H, D)         fp32, contiguous
//   state       (B, H, D, D)   fp32, contiguous (S[i][j] at i * D + j)
//   y           (B, T, H, D)   fp32, contiguous
//   new state   (B, H, D, D)   fp32, contiguous
//
// Design.  The TPU grid (B, H, T / block_t) ran its time axis in order and
// carried the (D, D) state in VMEM scratch, updating it as whole outer
// products on the vector unit.  Here one thread block owns one (batch,
// head) and loops over t itself, and thread j owns column j of the state in
// D registers for the whole sequence: the state never leaves the chip
// between its first read and its last write.  Each step stages r_t, k_t,
// v_t, w_t (D values each, one per thread, widened to fp32) in a
// double-buffered shared-memory tile, so one barrier a step suffices, and
// the next step's four values are loaded into registers before this step's
// arithmetic runs, hiding their latency.  The sum over i runs in increasing
// i, the reference's order.
//
// Bound.  Per (b, t, h) the recurrence does ~5 D^2 flops on 4 D inputs and D
// outputs; with fp32 CUDA-core arithmetic (67 TFLOP/s) and 3.35 TB/s it
// sits near the ridge at D = 64: both bounds are of the same size.  What
// limits this version is the serial dependence over t: a (b, h) pair is one
// block of D threads, so a prefill of one sequence runs H blocks on 132
// SMs, one step after another.  The chunked form of the recurrence (intra-
// chunk products on tensor cores, the state carried between chunks) is the
// later work that parallelises T.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Strides {
  // elements; per tensor (r, k, v, w): batch, time, head
  long long b[4], t[4], h[4];
};

__device__ __forceinline__ float load(const void* p, bool bf16, long long idx) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[idx])
              : static_cast<const float*>(p)[idx];
}

template <int D>
__global__ void wkv_kernel(const void* __restrict__ r, const void* __restrict__ k,
                           const void* __restrict__ v, const void* __restrict__ w,
                           const float* __restrict__ u, const float* __restrict__ s0,
                           float* __restrict__ y, float* __restrict__ s_out, int dtypes,
                           int seq_len, int num_heads, Strides st) {
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int j = threadIdx.x;
  const void* src[4] = {r, k, v, w};
  bool bf16[4];
  long long off[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    bf16[n] = (dtypes >> n) & 1;
    off[n] = (long long)b * st.b[n] + (long long)h * st.h[n] + j;
  }

  __shared__ float stage[2][4][D];  // r, k, v, w of one step, double-buffered
  __shared__ float u_s[D];
  u_s[j] = u[h * D + j];

  const long long state_base = ((long long)b * num_heads + h) * D * D + j;
  float s[D];
#pragma unroll
  for (int i = 0; i < D; ++i) s[i] = s0[state_base + (long long)i * D];

  float next[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) next[n] = load(src[n], bf16[n], off[n]);

  float* y_row = y + (long long)h * D + j;
  const long long y_step = (long long)num_heads * D;
  for (int t = 0; t < seq_len; ++t) {
    float(*cur)[D] = stage[t & 1];
#pragma unroll
    for (int n = 0; n < 4; ++n) cur[n][j] = next[n];
    if (t + 1 < seq_len) {
#pragma unroll
      for (int n = 0; n < 4; ++n)
        next[n] = load(src[n], bf16[n], off[n] + (long long)(t + 1) * st.t[n]);
    }
    __syncthreads();  // this step's tile is staged; the other one is free
    const float vj = cur[2][j];
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const float a = cur[1][i] * vj;
      acc += cur[0][i] * (s[i] + u_s[i] * a);
      s[i] = cur[3][i] * s[i] + a;
    }
    y_row[((long long)b * seq_len + t) * y_step] = acc;
  }

#pragma unroll
  for (int i = 0; i < D; ++i) s_out[state_base + (long long)i * D] = s[i];
}

template <int D>
int launch(const void* r, const void* k, const void* v, const void* w, const void* u,
           const void* s0, void* y, void* s_out, int dtypes, int batch, int seq_len,
           int num_heads, const Strides& st, cudaStream_t stream) {
  wkv_kernel<D><<<dim3(batch, num_heads), D, 0, stream>>>(
      r, k, v, w, static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(y), static_cast<float*>(s_out), dtypes, seq_len, num_heads, st);
  return (int)cudaGetLastError();
}

}  // namespace

// dtypes: bit n set = tensor n of (r, k, v, w) is bfloat16, else float32.
// strides: 12 element strides, (batch, time, head) of r, k, v, w in turn;
// the last (head_dim) stride of each must be 1.  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int rwkv6_scan(const void* r, const void* k, const void* v, const void* w,
                          const void* u, const void* state, void* y, void* new_state,
                          int dtypes, int batch, int seq_len, int num_heads, int head_dim,
                          const long long* strides, void* stream) {
  Strides st;
  for (int n = 0; n < 4; ++n) {
    st.b[n] = strides[3 * n];
    st.t[n] = strides[3 * n + 1];
    st.h[n] = strides[3 * n + 2];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return launch<32>(r, k, v, w, u, state, y, new_state, dtypes, batch, seq_len, num_heads,
                        st, s);
    case 64:
      return launch<64>(r, k, v, w, u, state, y, new_state, dtypes, batch, seq_len, num_heads,
                        st, s);
    case 128:
      return launch<128>(r, k, v, w, u, state, y, new_state, dtypes, batch, seq_len,
                         num_heads, st, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
