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
// Two routes, picked by the wrapper from static shapes
// (src/repro_torch/kernels/rwkv6_scan.py, `plan`):
//
// The step route (decode, T = 1, and short prompts).  The TPU grid (B, H,
// T / block_t) ran its time axis in order and carried the (D, D) state in
// VMEM scratch, updating it as whole outer products on the vector unit.
// Here one thread block owns one (batch, head) and loops over t itself,
// and thread j owns column j of the state in D registers for the whole
// sequence: the state never leaves the chip between its first read and its
// last write.  Each step stages r_t, k_t, v_t, w_t (D values each, one per
// thread, widened to fp32) in a double-buffered shared-memory tile, so one
// barrier a step suffices, and the next step's four values are loaded into
// registers before this step's arithmetic runs, hiding their latency.  The
// sum over i runs in increasing i, the reference's order.  A one-sequence
// prefill is B x H blocks, 40 on 132 SMs for RWKV-6 3B, one step after
// another: this route is serial over T.
//
// The chunked route (prefill).  T is cut into chunks of L steps, and three
// kernels spread a prefill over (batch, head, chunk):
//   (a) wkv_chunk_state: per chunk, from a zero state, the chunk's decayed
//       sum A_c = sum_s diag(prod_{tau > s} w_tau) k_s v_s^T and its total
//       decay g_c = prod_s w_s;
//   (b) wkv_carry: per (batch, head), each state element folds the chunks
//       in order, S_{c+1} = g_c * S_c + A_c, writing each chunk's incoming
//       state S_c over A_c; serial over T / L only;
//   (c) wkv_chunk_out: per chunk, y_t = (r_t * e_t)^T S_c + sum_{s<t} P_ts
//       v_s + (r_t . u k_t) v_t, where e_t = prod_{tau < t} w_tau and
//       P_ts = sum_i r_t[i] k_s[i] prod_{s < tau < t} w_tau[i].
// Decays are carried as log2 sums relative to the chunk's start, and each
// decay factor is an exp2 of a difference, <= 1: per pair within a 4-step
// tile of P, and split at the row tile's first step m for pairs in
// different tiles, (r_t 2^(lc_t - lc_m)) (k_s 2^(lc_m - lc_{s+1})), both
// factors <= 1.  Never as (r e^{lc}) (k e^{-lc}) over the whole chunk,
// since RWKV-6's w = exp(-exp(x)) reaches -log w ~ 7 a step and e^{-lc}
// overflows fp32 within 16 steps.  The
// prefix sums are taken in float64 and kept as fp32 (hi, lo) pairs, so a
// difference of two long prefixes is as exact as the difference itself.
// log2 w is floored at -128 (w = 0 decays as 2^-128); a NaN w stays NaN,
// as on the step route.  The chunked route takes w in [0, 1], as the model
// makes it.  L is 16 for every head_dim (kChunk): the one-sequence prefills
// the engines serve (T <= 1,024) run fastest there.  Arithmetic is fp32 on the
// CUDA cores; moving the intra-chunk products to the tensor cores is
// later work.
//
// Bound.  Per (b, t, h) the recurrence does ~5 D^2 flops on 4 D inputs and
// D outputs; with fp32 CUDA-core arithmetic (67 TFLOP/s) and 3.35 TB/s a
// prefill is bound by operations, a decode step (the two states) by bytes.
// The chunked route does about twice the recurrence's flops (its per-pair
// decays and the chunk states) but runs B x H x T / L blocks.

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


// ---------------------------------------------------------------------------
// The chunked route: three kernels, grid (chunk, head, batch) for (a) and
// (c), (state elements / 256, head, batch) for (b).
// ---------------------------------------------------------------------------

constexpr int kChunk = 16;  // L
constexpr int kChunkThreads = 256;
constexpr float kLog2Floor = -128.f;

// log2 w, floored: w = 0 (log2 -inf) decays as 2^-128; a NaN passes through
__device__ __forceinline__ float log2_decay(float w) {
  return isnan(w) ? w : fmaxf(log2f(w), kLog2Floor);
}

__device__ __forceinline__ long long base(const Strides& st, int n, int b, int h, int t0) {
  return (long long)b * st.b[n] + (long long)h * st.h[n] + (long long)t0 * st.t[n];
}

// (a) one block per (chunk, head, batch): A_c[i][j] = sum_s k_s[i] 2^(sum_{s<tau<n} log2 w_tau[i])
// v_s[j] from a zero state, and g_c[i] = 2^(sum_s log2 w_s[i]).  The suffix sums are float64.
template <int L, int D>
__global__ void __launch_bounds__(kChunkThreads)
wkv_chunk_state(const void* __restrict__ k, const void* __restrict__ v,
                const void* __restrict__ w, float* __restrict__ states,
                float* __restrict__ decays, int dtypes, int seq_len, int num_heads,
                Strides st) {
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t0 = c * L;
  const int n = min(L, seq_len - t0);
  const long long bhc = ((long long)b * num_heads + h) * gridDim.x + c;
  __shared__ __align__(16) float ks[L][D];  // k_s, then k_s times its decay to the chunk's end
  __shared__ float vs[L][D];
  __shared__ float lw[L][D];  // log2 w_s
  const bool kb = (dtypes >> 1) & 1, vb = (dtypes >> 2) & 1, wb = (dtypes >> 3) & 1;
  const long long ko = base(st, 1, b, h, t0), vo = base(st, 2, b, h, t0),
                  wo = base(st, 3, b, h, t0);
#pragma unroll
  for (int m = 0; m < L * D / kChunkThreads; ++m) {  // every load in flight at once
    const int e = threadIdx.x + m * kChunkThreads, s = e / D, i = e % D;
    float kv = 0.f, vv = 0.f, lv = 0.f;
    if (s < n) {
      kv = load(k, kb, ko + s * st.t[1] + i);
      vv = load(v, vb, vo + s * st.t[2] + i);
      lv = log2_decay(load(w, wb, wo + s * st.t[3] + i));
    }
    ks[s][i] = kv;
    vs[s][i] = vv;
    lw[s][i] = lv;
  }
  __syncthreads();
  if (threadIdx.x < D) {
    const int i = threadIdx.x;
    float lws[L], x[L];
#pragma unroll
    for (int s = 0; s < L; ++s) lws[s] = lw[s][i];
    double suffix = 0.0;  // log2 of the decay from after step s to the chunk's end
#pragma unroll
    for (int s = L - 1; s >= 0; --s) {  // the padding steps add log2 1 = 0
      x[s] = exp2f((float)suffix);
      suffix += lws[s];
    }
#pragma unroll
    for (int s = 0; s < L; ++s) ks[s][i] *= x[s];
    decays[bhc * D + i] = exp2f((float)suffix);
  }
  __syncthreads();
  // thread (ig, j) sums the rows i0 .. i0 + kRows of column j; the k row reads are
  // float4 broadcasts
  constexpr int kGroups = kChunkThreads / D;
  constexpr int kRows = D / kGroups;
  const int j = threadIdx.x % D, i0 = threadIdx.x / D * kRows;
  float acc[kRows];
#pragma unroll
  for (int m = 0; m < kRows; ++m) acc[m] = 0.f;
  for (int s = 0; s < n; ++s) {
    const float vj = vs[s][j];
#pragma unroll
    for (int m = 0; m < kRows; m += 4) {
      const float4 k4 = *reinterpret_cast<const float4*>(&ks[s][i0 + m]);
      acc[m] = fmaf(k4.x, vj, acc[m]);
      acc[m + 1] = fmaf(k4.y, vj, acc[m + 1]);
      acc[m + 2] = fmaf(k4.z, vj, acc[m + 2]);
      acc[m + 3] = fmaf(k4.w, vj, acc[m + 3]);
    }
  }
  float* out = states + bhc * D * D + (long long)i0 * D + j;
#pragma unroll
  for (int m = 0; m < kRows; ++m) out[m * D] = acc[m];
}

// (b) one thread per state element (i, j) of a (batch, head): folds the chunks in order,
// S_{c+1} = g_c[i] S_c + A_c, writing S_c over A_c; the last S is the new state.
template <int D>
__global__ void __launch_bounds__(kChunkThreads)
wkv_carry(const float* __restrict__ s0, float* __restrict__ states,
          const float* __restrict__ decays, float* __restrict__ s_out, int num_heads,
          int num_chunks) {
  constexpr int kUnroll = 8;
  constexpr long long kDD = (long long)D * D;
  const int e = blockIdx.x * kChunkThreads + threadIdx.x;
  const long long bh = (long long)blockIdx.z * num_heads + blockIdx.y;
  float s = s0[bh * kDD + e];
  float* a = states + bh * num_chunks * kDD + e;
  const float* g = decays + bh * num_chunks * D + e / D;
  int c = 0;
  for (; c + kUnroll <= num_chunks; c += kUnroll) {
    float av[kUnroll], gv[kUnroll];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      av[q] = a[(c + q) * kDD];
      gv[q] = g[(c + q) * D];
    }
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      a[(c + q) * kDD] = s;
      s = fmaf(gv[q], s, av[q]);
    }
  }
  for (; c < num_chunks; ++c) {
    const float av = a[c * kDD], gv = g[c * D];
    a[c * kDD] = s;
    s = fmaf(gv, s, av);
  }
  s_out[bh * kDD + e] = s;
}

// One warp's 4 x 4 tile of P (rows t0.., columns s0..), lanes over i:
// acc[4 tt + ss] = the lane's part of the pair's sum.  kDiag: s0 == t0, the
// pairs above the diagonal stay 0, the diagonal takes the u bonus, and each
// pair below it takes its own exp2; off the diagonal 8 exp2 serve 16 pairs.
template <int L, int D, bool kDiag>
__device__ __forceinline__ void p_tile(float (&acc)[16], const float (*rs)[D],
                                       const float (*ks)[D], const float (*hi)[D],
                                       const float (*lo)[D], const float* us, int t0, int s0,
                                       int lane) {
#pragma unroll
  for (int q = 0; q < 16; ++q) acc[q] = 0.f;
#pragma unroll
  for (int ii = 0; ii < D / 32; ++ii) {
    const int i = lane + 32 * ii;
    float rt[4], ht[4], lt[4], kk[4], hs[4], ls[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      rt[q] = rs[t0 + q][i];
      ht[q] = hi[t0 + q][i];
      lt[q] = lo[t0 + q][i];
      kk[q] = ks[s0 + q][i];
      hs[q] = hi[s0 + q + 1][i];
      ls[q] = lo[s0 + q + 1][i];
    }
    if (!kDiag) {
      // every column s < s0 + 4 <= t0 <= every row t: the decay factor splits at the
      // tile's first row t0 into two factors, each <= 1
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        rt[q] *= exp2f((ht[q] - ht[0]) + (lt[q] - lt[0]));
        kk[q] *= exp2f((ht[0] - hs[q]) + (lt[0] - ls[q]));
      }
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) {
#pragma unroll
        for (int ss = 0; ss < 4; ++ss) acc[4 * tt + ss] = fmaf(rt[tt], kk[ss], acc[4 * tt + ss]);
      }
    } else {
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) {
#pragma unroll
        for (int ss = 0; ss < tt; ++ss) {
          const float d = (ht[tt] - hs[ss]) + (lt[tt] - ls[ss]);
          acc[4 * tt + ss] = fmaf(rt[tt] * kk[ss], exp2f(d), acc[4 * tt + ss]);
        }
        acc[5 * tt] = fmaf(rt[tt] * us[i], kk[tt], acc[5 * tt]);
      }
    }
  }
}

// (c) one block per (chunk, head, batch): y_t = (r_t e_t)^T S_c + sum_{s<t} P_ts v_s +
// (r_t . u k_t) v_t, each decay factor one exp2 of a difference of prefix sums (<= 0).
template <int L, int D>
__global__ void __launch_bounds__(kChunkThreads)
wkv_chunk_out(const void* __restrict__ r, const void* __restrict__ k,
              const void* __restrict__ v, const void* __restrict__ w,
              const float* __restrict__ u, const float* __restrict__ states,
              float* __restrict__ y, int dtypes, int seq_len, int num_heads, Strides st) {
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t0 = c * L;
  const int n = min(L, seq_len - t0);
  const long long bhc = ((long long)b * num_heads + h) * gridDim.x + c;
  __shared__ __align__(16) float rs[L][D];  // r_t, then r_t * e_t
  __shared__ float ks[L][D];
  __shared__ float vs[L][D];
  __shared__ float hi[L + 1][D];            // log2 e_t (the decay before step t) = hi + lo
  __shared__ float lo[L + 1][D];
  __shared__ __align__(16) float p[L][L];   // P_ts for s < t, the u bonus at s = t, 0 above
  __shared__ float us[D];
  const long long ro = base(st, 0, b, h, t0), ko = base(st, 1, b, h, t0),
                  vo = base(st, 2, b, h, t0), wo = base(st, 3, b, h, t0);
  // the padding past the sequence is r = k = v = 0, w = 1: it changes nothing
#pragma unroll
  for (int m = 0; m < L * D / kChunkThreads; ++m) {  // every load in flight at once
    const int e = threadIdx.x + m * kChunkThreads, t = e / D, i = e % D;
    float rv = 0.f, kv = 0.f, vv = 0.f, lv = 0.f;
    if (t < n) {
      rv = load(r, dtypes & 1, ro + t * st.t[0] + i);
      kv = load(k, (dtypes >> 1) & 1, ko + t * st.t[1] + i);
      vv = load(v, (dtypes >> 2) & 1, vo + t * st.t[2] + i);
      lv = log2_decay(load(w, (dtypes >> 3) & 1, wo + t * st.t[3] + i));
    }
    rs[t][i] = rv;
    ks[t][i] = kv;
    vs[t][i] = vv;
    hi[t + 1][i] = lv;
  }
  for (int e = threadIdx.x; e < L * L; e += kChunkThreads) (&p[0][0])[e] = 0.f;
  if (threadIdx.x < D) us[threadIdx.x] = u[h * D + threadIdx.x];
  __syncthreads();
  if (threadIdx.x < D) {
    const int i = threadIdx.x;
    float x[L];
#pragma unroll
    for (int t = 0; t < L; ++t) x[t] = hi[t + 1][i];
    double lc = 0.0;
    hi[0][i] = lo[0][i] = 0.f;
#pragma unroll
    for (int t = 0; t < L; ++t) {
      lc += x[t];
      const float f = (float)lc;
      hi[t + 1][i] = f;
      lo[t + 1][i] = (float)(lc - (double)f);
    }
  }
  __syncthreads();
  // P by 4 x 4 tiles on or below the diagonal, one warp each; its 16 sums are
  // reduce-scattered over the lanes (16 shuffles), lanes 2q and 2q + 1 ending with entry q
  constexpr int kTiles = L / 4;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int e = warp; e < kTiles * (kTiles + 1) / 2; e += kChunkThreads / 32) {
    int tb = (int)((sqrtf(8.f * e + 1.f) - 1.f) * 0.5f);
    while (tb * (tb + 1) / 2 > e) --tb;
    while ((tb + 1) * (tb + 2) / 2 <= e) ++tb;
    const int sb = e - tb * (tb + 1) / 2;
    if (4 * tb >= n) continue;  // padding rows only
    float acc[16];
    if (tb == sb)
      p_tile<L, D, true>(acc, rs, ks, hi, lo, us, 4 * tb, 4 * sb, lane);
    else
      p_tile<L, D, false>(acc, rs, ks, hi, lo, us, 4 * tb, 4 * sb, lane);
#pragma unroll
    for (int step = 0; step < 4; ++step) {
      const int width = 16 >> step, half = 8 >> step;
      const bool upper = lane & width;
#pragma unroll
      for (int q = 0; q < half; ++q) {
        const float keep = upper ? acc[q + half] : acc[q];
        const float send = upper ? acc[q] : acc[q + half];
        acc[q] = keep + __shfl_xor_sync(0xffffffffu, send, width);
      }
    }
    const float sum = acc[0] + __shfl_xor_sync(0xffffffffu, acc[0], 1);
    const int q = lane >> 1, t = 4 * tb + (q >> 2), s = 4 * sb + (q & 3);
    if (!(lane & 1) && s <= t) p[t][s] = sum;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < L * D; e += kChunkThreads) {
    const int t = e / D, i = e % D;
    rs[t][i] *= exp2f(hi[t][i] + lo[t][i]);
  }
  __syncthreads();
  // thread (tg, j) writes rows t = tg + kGroups m of column j; the row reads of r and P
  // are float4 broadcasts
  constexpr int kGroups = kChunkThreads / D;
  constexpr int kRows = L / kGroups;
  const int j = threadIdx.x % D, tg = threadIdx.x / D;
  float acc[kRows];
#pragma unroll
  for (int m = 0; m < kRows; ++m) acc[m] = 0.f;
  const float* sc = states + bhc * D * D + j;  // S_c, column j
#pragma unroll 4
  for (int i = 0; i < D; i += 4) {
    const float s0 = sc[i * D], s1 = sc[(i + 1) * D], s2 = sc[(i + 2) * D],
                s3 = sc[(i + 3) * D];
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      const float4 r4 = *reinterpret_cast<const float4*>(&rs[tg + kGroups * m][i]);
      acc[m] = fmaf(r4.x, s0, fmaf(r4.y, s1, fmaf(r4.z, s2, fmaf(r4.w, s3, acc[m]))));
    }
  }
  for (int s = 0; s < n; s += 4) {  // P is 0 above the diagonal, v 0 past n
    const float v0 = vs[s][j], v1 = vs[s + 1][j], v2 = vs[s + 2][j], v3 = vs[s + 3][j];
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      const float4 p4 = *reinterpret_cast<const float4*>(&p[tg + kGroups * m][s]);
      acc[m] = fmaf(p4.x, v0, fmaf(p4.y, v1, fmaf(p4.z, v2, fmaf(p4.w, v3, acc[m]))));
    }
  }
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
    const int t = tg + kGroups * m;
    if (t < n) y[(((long long)b * seq_len + t0 + t) * num_heads + h) * D + j] = acc[m];
  }
}

template <int L, int D>
int launch_chunked(const void* r, const void* k, const void* v, const void* w,
                   const void* u, const void* s0, void* y, void* s_out, float* workspace,
                   int dtypes, int batch, int seq_len, int num_heads, const Strides& st,
                   cudaStream_t stream) {
  static_assert(kChunkThreads % D == 0 && L % (kChunkThreads / D) == 0 && L % 4 == 0 &&
                    D % 32 == 0 && (D / (kChunkThreads / D)) % 4 == 0 &&
                    (D * D) % kChunkThreads == 0,
                "thread layout");
  const int num_chunks = (seq_len + L - 1) / L;
  float* states = workspace;  // (B, H, chunks, D, D): A_c, then S_c
  float* decays = workspace + (long long)batch * num_heads * num_chunks * D * D;  // (B, H, chunks, D)
  const dim3 chunks(num_chunks, num_heads, batch);
  wkv_chunk_state<L, D><<<chunks, kChunkThreads, 0, stream>>>(
      k, v, w, states, decays, dtypes, seq_len, num_heads, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wkv_carry<D><<<dim3(D * D / kChunkThreads, num_heads, batch), kChunkThreads, 0, stream>>>(
      static_cast<const float*>(s0), states, decays, static_cast<float*>(s_out), num_heads,
      num_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wkv_chunk_out<L, D><<<chunks, kChunkThreads, 0, stream>>>(
      r, k, v, w, static_cast<const float*>(u), states, static_cast<float*>(y), dtypes,
      seq_len, num_heads, st);
  return (int)cudaGetLastError();
}

Strides unpack(const long long* strides) {
  Strides st;
  for (int n = 0; n < 4; ++n) {
    st.b[n] = strides[3 * n];
    st.t[n] = strides[3 * n + 1];
    st.h[n] = strides[3 * n + 2];
  }
  return st;
}

}  // namespace

// dtypes: bit n set = tensor n of (r, k, v, w) is bfloat16, else float32.
// strides: 12 element strides, (batch, time, head) of r, k, v, w in turn;
// the last (head_dim) stride of each must be 1.  Each entry point returns
// cudaGetLastError() after its launches (0 = launched).

// The step route: one launch.
extern "C" int rwkv6_scan(const void* r, const void* k, const void* v, const void* w,
                          const void* u, const void* state, void* y, void* new_state,
                          int dtypes, int batch, int seq_len, int num_heads, int head_dim,
                          const long long* strides, void* stream) {
  const Strides st = unpack(strides);
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

// The chunked route: three launches over chunks of kChunk = 16 steps.
// workspace: B * H * ceil(T / 16) * D * (D + 1) fp32.
extern "C" int rwkv6_scan_chunked(const void* r, const void* k, const void* v, const void* w,
                                  const void* u, const void* state, void* y, void* new_state,
                                  void* workspace, int dtypes, int batch, int seq_len,
                                  int num_heads, int head_dim, const long long* strides,
                                  void* stream) {
  const Strides st = unpack(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(workspace);
  switch (head_dim) {
    case 32:
      return launch_chunked<kChunk, 32>(r, k, v, w, u, state, y, new_state, ws, dtypes, batch,
                                        seq_len, num_heads, st, s);
    case 64:
      return launch_chunked<kChunk, 64>(r, k, v, w, u, state, y, new_state, ws, dtypes, batch,
                                        seq_len, num_heads, st, s);
    case 128:
      return launch_chunked<kChunk, 128>(r, k, v, w, u, state, y, new_state, ws, dtypes,
                                         batch, seq_len, num_heads, st, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
