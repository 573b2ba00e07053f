// Flash attention's non-causal bf16 route for Hopper: `wgmma` products on
// tiles that TMA brings into shared memory, a producer keeping a ring of
// them in flight.  Included by flash_attention.cu, which holds the C entry
// points and the other routes; see the note at its top for the route choice.
// It replaces the same Pallas kernel (src/repro/kernels/flash_attention.py,
// pallas_call at :108, with causal=False) and adds its gradient.
//
// Bound.  At Seamless' encoder (B=16, H=KV=16, S=1,024, D=64) the forward
// does 6.9e10 flops against 0.13 GB: the operations bound it (0.069 ms at
// 989 TFLOP/s), and at D=64 the softmax's exponentials (one per score, 16
// a clock on an SM) take as long as the products.  So the design keeps the
// tensor cores and the exponentials busy at once: several warpgroups per
// SM, and in the forward each warpgroup's next S on the tensor cores while
// it runs a softmax.
//
// Shapes.  Every tile is 64 rows by D (64 or 128) bf16, stored as D / 64
// "panels" of 64 x 64: one TMA box each, rows of 128 bytes in the 128-byte
// swizzle, 1,024-byte aligned, which is the layout `wgmma`'s 128-byte
// swizzle mode reads.  A block is NWG consumer warpgroups of 64 rows each
// plus a producer warpgroup (the block's last: one of its threads issues
// every load, and it hands its registers to the consumers).  The operand a
// block keeps (Q in the forward, Q and dO in dQ, K and V in dK/dV) is
// loaded once; the operand it streams comes through a ring of STAGES tiles
// of 64 rows, each stage with a `full` barrier (TMA's byte count) and an
// `empty` barrier (one arrival per consumer warp).  A block's warpgroups
// whose rows all lie past S leave at once (the ring counts only the others).
//
// Products, per warpgroup (64 rows), per streamed tile (64 rows):
//   forward  S = Q K^T  (SS: both K-major)      O += P V     (RS: P in registers, V MN-major)
//   dQ       S = Q K^T, dP = dO V^T              dQ += dS K   (RS: K MN-major)
//   dK/dV    S^T = K Q^T, dP^T = V dO^T          dV += P^T dO, dK += dS^T Q (RS)
// The fp32 accumulator of S (64 x 64) is laid out as `mma.sync`'s m16n8
// fragments stacked over the 4 warps, so P (or dS), rounded to bf16 in
// registers, is directly the A operand of the next product.
//
// Tensors are read by TMA through 4-D maps (head_dim, S, heads, batch) made
// on the host from each tensor's strides: rows past S and columns past
// head_dim arrive as zeros, so no load is masked.  Outputs are written by
// strides from registers.  The backward's per-row terms come from a
// workspace the wrapper allocates: lse * log2(e) and delta = rowsum(dO * O),
// (B, H, S_pad) each with S_pad = S rounded up to 64, +inf and 0 past S, so
// a query past S weighs nothing without a mask.  When the dK/dV grid would
// leave SMs idle, its blocks split the group's G query heads into parts,
// each writing fp32 partials to the workspace, and a last kernel sums them
// in a fixed order: the backward stays free of atomics and deterministic.

namespace sm90 {

constexpr int kTileRows = 64;            // rows of every tile, and of a warpgroup
constexpr int kPanel = 64 * 64 * 2;      // bytes of one 64 x 64 bf16 panel
constexpr int kRowBytes = 128;           // a panel row: the swizzle's width
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ uint32_t mbar_try_wait(uint64_t* bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done;
}

// Until the barrier's phase of parity `parity` has completed.  A wait past
// ~2^34 cycles (seconds) traps: a lost completion becomes a launch error
// that the next synchronisation reports, not a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1LL << 34)) __trap();
}

// One 64 x 64 box of a 4-D tensor map at (column, row, head, batch).
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int col,
                                         int row, int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(row), "r"(head),
      "r"(batch)
      : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) global -> shared.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accumulator registers across a wgmma.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// A shared-memory matrix descriptor in the 128-byte swizzle mode.  K-major
// operands (rows of 128 bytes along the product's depth): the 8-row groups
// are 1,024 bytes apart (SBO) and LBO is unused.  MN-major operands (the
// product's depth runs down the rows): SBO the same, LBO the distance from
// one 64-column panel to the next.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// K-major k step kk (16 columns) of a tile at `addr`: 4 steps per panel,
// 32 bytes apart inside the swizzled row.
__device__ __forceinline__ uint64_t desc_k(uint32_t addr, int kk) {
  return desc(addr + (kk / 4) * kPanel + (kk % 4) * 32, 16);
}

// MN-major k step kk (16 rows) of a tile at `addr`.
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr, int kk) {
  return desc(addr + kk * 16 * kRowBytes, kPanel);
}

// d (64 x 64 fp32) (+)= A B^T: A (64 x 16) and B (64 x 16) both K-major in
// shared memory, by descriptor.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64 fp32) (+)= A B: A (64 x 16 bf16) from registers (each warp's
// 16 rows as the m16n8k16 A fragment), B (16 x 64) MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (64 x 128 fp32) (+)= A B: A (64 x 16 bf16) from registers (each warp's
// 16 rows as the m16n8k16 A fragment), B (16 x 128) MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// acc (64 x D) += A (registers) times the MN-major tile at `addr`, k step kk.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint32_t addr,
                                         int kk) {
  wgmma_rs_n64(d, a, desc_mn(addr, kk), 1);
}
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint32_t addr,
                                         int kk) {
  wgmma_rs_n128(d, a, desc_mn(addr, kk), 1);
}

// S (64 x 64 fp32) = A B^T over depth D: A and B tiles K-major at `a`, `b`.
template <int D>
__device__ __forceinline__ void product_ss(float (&s)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n64(s, desc_k(a, kk), desc_k(b, kk), kk > 0);
}

// 2^x (MUFU; 2^-inf = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The A fragment of k step kk (16 columns) from a 64 x 64 accumulator:
// n8 chunks 2kk and 2kk + 1, rounded to bf16.
__device__ __forceinline__ void to_a(uint32_t (&a)[4], const float (&s)[32], int kk) {
  a[0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
  a[1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
  a[2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
  a[3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
}

// The byte size of a block's shared memory: `tiles` tiles of D columns, `barriers`
// mbarriers and `extra` bytes, plus the slack to align the tiles to 1,024.
__host__ __device__ constexpr int smem_bytes(int D, int tiles, int barriers, int extra) {
  return 1024 + tiles * (D / 64) * kPanel + 8 * barriers + extra;
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// Loads the D / 64 panels of the tile at (row, head, batch) into `dst`.
template <int D>
__device__ __forceinline__ void tma_tile(unsigned char* dst, const CUtensorMap* map,
                                         uint64_t* bar, int row, int head, int batch) {
#pragma unroll
  for (int p = 0; p < D / 64; ++p) tma_load(dst + p * kPanel, map, bar, 64 * p, row, head, batch);
}

__device__ __forceinline__ void init_barriers(uint64_t* bars, int stages, int consumers_warps,
                                              int extra) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&bars[s], 1);                            // full: the producer's expect_tx
      mbar_init(&bars[stages + s], consumers_warps);     // empty: one arrival per consumer warp
    }
    for (int i = 0; i < extra; ++i) mbar_init(&bars[2 * stages + i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The warpgroup index, known to the compiler to be warp-uniform: the shared
// memory descriptors built from it then live in uniform registers, which
// wgmma reads without a move between the wgmmas of a group (a move there
// serializes them).
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
}

// Every consumer warp's release of a ring stage.
__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(empty);
}

// Register budgets: the block's last warpgroup is the producer and gives
// its registers up to the consumers (`setmaxnreg`): a dK/dV consumer holds
// four 64 x D accumulators, a forward one its output beside a tile's S in
// flight.  A block launches with `launch_regs` a thread; what the producer
// gives up is all the consumers may take.
constexpr int kProducerRegs = 40;
__host__ __device__ constexpr int launch_regs(int nwg) { return 65536 / (128 * (nwg + 1)) / 8 * 8; }
__host__ __device__ constexpr int consumer_regs(int nwg) {
  return launch_regs(nwg) + (launch_regs(nwg) - kProducerRegs) / nwg / 8 * 8 > 240
             ? 240
             : launch_regs(nwg) + (launch_regs(nwg) - kProducerRegs) / nwg / 8 * 8;
}

template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wg_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// Keeps A fragments alive until an asynchronous wgmma that reads them has
// completed, and makes them final before a wgmma.fence (so that no copy
// into them is scheduled among the wgmmas, which would serialize them).
template <int N>
__device__ __forceinline__ void pin(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// ---------------------------------------------------------------------------
// the pieces every consumer warpgroup runs (force-inlined: the arrays they
// take stay in registers)
// ---------------------------------------------------------------------------

// P (or dS) of a 64 x 64 tile as the four A fragments of its k steps.
__device__ __forceinline__ void frags(uint32_t (&a)[4][4], const float (&s)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) to_a(a[kk], s, kk);
}

// One wgmma group: s = A B^T over depth D, A and B K-major at `a`, `b`.
template <int D>
__device__ __forceinline__ void group_ss(float (&s)[32], uint32_t a, uint32_t b) {
  pin(s);
  wg_fence();
  product_ss<D>(s, a, b);
  wg_commit();
}

// One wgmma group: s = A B^T and dp = C E^T, all K-major.
template <int D>
__device__ __forceinline__ void group_ss2(float (&s)[32], uint32_t a, uint32_t b,
                                          float (&dp)[32], uint32_t c, uint32_t e) {
  pin(s);
  pin(dp);
  wg_fence();
  product_ss<D>(s, a, b);
  product_ss<D>(dp, c, e);
  wg_commit();
}

// One wgmma group: acc (64 x D) += A (the fragments `a`, 64 x 64) times the
// MN-major tile at `b` (64 x D).
template <int N>
__device__ __forceinline__ void group_rs(float (&acc)[N], uint32_t (&a)[4][4], uint32_t b) {
  pin(acc);
  pin(a);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc, a[kk], b, kk);
  wg_commit();
}

// The consumer warpgroups that have rows (or keys) below S: a block's last
// warpgroups may have none, and then leave at once.
__device__ __forceinline__ int live_groups(int nwg, int first_row, int S) {
  return min(nwg, (S - first_row + kTileRows - 1) / kTileRows);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// The online softmax of one 64-key tile on the accumulator fragments: s
// (raw scores) becomes P, m (log2 units) and l (this lane's part) move on,
// alpha is each row's rescale of the output.  Without a softcap or a mask
// the row max is taken on the raw scores and one FMA scales and shifts.
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int row0, int k0, int c,
                                             bool need_mask, int S, int window, float scale,
                                             float sl2, float softcap) {
  const bool plain = !need_mask && softcap <= 0.f;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float mx = kNegInf;
    if (plain) {
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * hf], s[4 * j + 2 * hf + 1]));
    } else {
      const int row = row0 + 8 * hf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * j + 2 * hf + e];
          x = softcap > 0.f ? softcap * tanhf(x * scale / softcap) * kLog2e : x * sl2;
          if (need_mask) {
            const int kpos = k0 + 8 * j + 2 * c + e;
            if (kpos >= S) {
              x = -INFINITY;
            } else if (window > 0 && row - kpos >= window) {
              x = kNegInf;
            }
          }
          mx = fmaxf(mx, x);
        }
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[hf], plain ? mx * sl2 : mx);
    alpha[hf] = ex2(m[hf] - m_new);
    const float mul = plain ? sl2 : 1.f;
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // the difference first: a row masked so far has x = m = -1e30 and
        // must weigh 1 (then 0 once a key is seen), as in ref.py
        float& x = s[4 * j + 2 * hf + e];
        x = ex2(fmaf(x, mul, -m_new));
        rs += x;
      }
    }
    l[hf] = l[hf] * alpha[hf] + rs;   // this lane's part; the quad sums at the end
    m[hf] = m_new;
  }
}

// One block per (query tile of 64 * NWG rows, head, batch).  Each consumer
// warpgroup holds 64 query rows and runs two tiles at once: while the
// tensor cores compute S of key tile t + 1 and O += P V of tile t, the
// warpgroup runs the softmax of tile t + 1 (its wgmma groups are waited one
// at a time).
template <int D, int NWG, int STAGES>
__global__ void __launch_bounds__(128 * (NWG + 1), 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                           float* __restrict__ lse, Strides so, int H, int KV, int S, int dh,
                           int window, float scale, float softcap) {
  constexpr int TILE = (D / 64) * kPanel;
  constexpr int BQ = kTileRows * NWG;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = align1024(smem_raw);          // NWG tiles
  unsigned char* ks = qs + NWG * TILE;              // STAGES tiles
  unsigned char* vs = ks + STAGES * TILE;           // STAGES tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(vs + STAGES * TILE);
  uint64_t* full = bars;
  uint64_t* empty = bars + STAGES;
  uint64_t* qbar = bars + 2 * STAGES;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int k_lo = window > 0 ? (max(0, q0 - window + 1) / kTileRows) * kTileRows : 0;
  const int n_tiles = (S - k_lo + kTileRows - 1) / kTileRows;
  const int live = live_groups(NWG, q0, S);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  init_barriers(bars, STAGES, 4 * live, 1);

  if (warp >= 4 * NWG) {   // the producer warpgroup: one thread issues every load
    regs_dec<kProducerRegs>();
    if (threadIdx.x == 128 * NWG) {
      mbar_expect_tx(qbar, live * TILE);
      for (int w = 0; w < live; ++w)
        tma_tile<D>(qs + w * TILE, &tq, qbar, q0 + kTileRows * w, h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % STAGES;
        if (t >= STAGES) mbar_wait(&empty[st], (t / STAGES - 1) & 1);
        mbar_expect_tx(&full[st], 2 * TILE);
        tma_tile<D>(ks + st * TILE, &tk, &full[st], k_lo + kTileRows * t, kvh, b);
        tma_tile<D>(vs + st * TILE, &tv, &full[st], k_lo + kTileRows * t, kvh, b);
      }
    }
    return;
  }
  const int wg = warpgroup();
  if (wg >= live) return;
  regs_inc<consumer_regs(NWG)>();

  const int c = lane % 4;
  const int r_lo = q0 + kTileRows * wg;                  // this warpgroup's rows
  const int row0 = r_lo + 16 * (warp % 4) + lane / 4;    // this thread's rows: row0, row0 + 8
  const uint32_t q_addr = smem_u32(qs + wg * TILE);
  const float sl2 = scale * kLog2e;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
  float s[32];        // S of a tile, then its P (fp32)
  uint32_t pa[4][4];  // P of the tile in O += P V, bf16
  // the window's edge or S cuts the tile at k0 for some row of the warpgroup
#define FWD_SOFTMAX(k0)                                                                      \
  softmax_tile(s, m, l, alpha, row0, k0, c,                                                  \
               (k0) + kTileRows > S || (window > 0 && r_lo + kTileRows - 1 - (k0) >= window), \
               S, window, scale, sl2, softcap)

  mbar_wait(qbar, 0);
  mbar_wait(&full[0], 0);
  __syncwarp();
  group_ss<D>(s, q_addr, smem_u32(ks));
  wg_wait_all();
  pin(s);
  FWD_SOFTMAX(k_lo);
  frags(pa, s);

  // every tile but the last: its P V beside the next tile's S (two groups,
  // waited one at a time: the softmax of the next tile runs in between)
  for (int t = 0; t + 1 < n_tiles; ++t) {
    const int st = t % STAGES, nx = (t + 1) % STAGES;
    mbar_wait(&full[nx], ((t + 1) / STAGES) & 1);
    __syncwarp();
    group_ss<D>(s, q_addr, smem_u32(ks + nx * TILE));
    group_rs(acc, pa, smem_u32(vs + st * TILE));
    wg_wait_one();
    pin(s);
    FWD_SOFTMAX(k_lo + kTileRows * (t + 1));
    wg_wait_all();
    pin(acc);
    pin(pa);
    release(&empty[st], lane);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[4 * j] *= alpha[0];
      acc[4 * j + 1] *= alpha[0];
      acc[4 * j + 2] *= alpha[1];
      acc[4 * j + 3] *= alpha[1];
    }
    frags(pa, s);
  }
#undef FWD_SOFTMAX
  group_rs(acc, pa, smem_u32(vs + ((n_tiles - 1) % STAGES) * TILE));
  wg_wait_all();
  pin(acc);
  pin(pa);
  release(&empty[(n_tiles - 1) % STAGES], lane);

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float lsum = l[hf];
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
    const int row = row0 + 8 * hf;
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(lsum, 1e-30f);
    bf16* op = o + b * so.b + h * so.h + row * so.s;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * c;
      if (col < dh)
        *reinterpret_cast<uint32_t*>(op + col) =
            pack_bf16(acc[4 * j + 2 * hf] * inv, acc[4 * j + 2 * hf + 1] * inv);
    }
    if (c == 0) lse[((long long)b * H + h) * S + row] = m[hf] * kLn2 + logf(lsum);
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// lse2 = lse * log2 e and delta = rowsum(dO * O) into the workspace, rows of
// S_pad: +inf and 0 past S.  LANES (D / 8) lanes per row, 16-byte loads.
template <int LANES>
__global__ void flash_bwd_prep_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                                      const float* __restrict__ lse, float* __restrict__ lse2,
                                      float* __restrict__ delta, Strides so, Strides sdo, int B,
                                      int H, int S, int S_pad, int dh) {
  const long long row = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / LANES;
  const int sub = threadIdx.x % LANES;
  const bool live = row < (long long)B * H * S_pad;
  const int s = (int)(row % S_pad);
  const int bh = (int)(row / S_pad);
  float part = 0.f;
  if (live && s < S && sub * 8 < dh) {
    const int h = bh % H, b = bh / H;
    float x[8], y[8];
    Vec16<bf16>::load(o + b * so.b + h * so.h + s * so.s + sub * 8, x);
    Vec16<bf16>::load(dout + b * sdo.b + h * sdo.h + s * sdo.s + sub * 8, y);
#pragma unroll
    for (int e = 0; e < 8; ++e) part += x[e] * y[e];
  }
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
  if (live && sub == 0) {
    delta[row] = part;
    lse2[row] = s < S ? lse[(long long)bh * S + s] * kLog2e : INFINITY;
  }
}

// P and dS of one score element: s the raw score, dp = dO . v, lse2 and dl
// the query's terms; `seen` false for a masked pair.  s becomes P, dp dS.
__device__ __forceinline__ void grad_elem(float& s, float& dp, float lse2, float dl, bool seen,
                                          float sl2, float scale, float softcap) {
  float p, ds;
  if (softcap > 0.f) {
    const float th = tanhf(s * scale / softcap);
    p = ex2(softcap * th * kLog2e - lse2);
    ds = p * (dp - dl) * (1.f - th * th);
  } else {
    p = ex2(fmaf(s, sl2, -lse2));
    ds = p * (dp - dl);
  }
  s = seen ? p : 0.f;
  dp = seen ? ds : 0.f;
}

// dQ's P and dS of the key tile at k0, in place in s and dp: rows queries
// (row0, row0 + 8 with their lse2 lq and delta dl), columns keys.
__device__ __forceinline__ void dq_grads(float (&s)[32], float (&dp)[32], const float (&lq)[2],
                                         const float (&dl)[2], int row0, int r_lo, int k0, int c,
                                         int S, int window, float sl2, float scale,
                                         float softcap) {
  const bool need_mask =
      k0 + kTileRows > S || (window > 0 && r_lo + kTileRows - 1 - k0 >= window);
  if (!need_mask && softcap <= 0.f) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = ex2(fmaf(s[i], sl2, -lq[(i >> 1) & 1]));
      dp[i] = p * (dp[i] - dl[(i >> 1) & 1]);
      s[i] = p;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + 8 * (e >> 1);
      const int kpos = k0 + 8 * j + 2 * c + (e & 1);
      const bool seen = kpos < S && !(window > 0 && row - kpos >= window);
      grad_elem(s[4 * j + e], dp[4 * j + e], lq[e >> 1], dl[e >> 1], seen, sl2, scale, softcap);
    }
  }
}

// dQ for a (query tile of 64 * NWG rows, head, batch): Q and dO loaded once,
// K and V streamed.  Each tile's two groups (S and dP, then dQ += dS K) run
// one after the other: overlapping the next tile's S and dP with this
// tile's dQ product, as the forward does, ran no faster at D = 64 and
// slower at D = 128 (PERF.md, flash findings); the warpgroups overlap each other.
template <int D, int NWG, int STAGES>
__global__ void __launch_bounds__(128 * (NWG + 1), 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo,
                              const float* __restrict__ lse2, const float* __restrict__ delta,
                              bf16* __restrict__ dq, Strides sdq, int H, int KV, int S, int S_pad,
                              int dh, int window, float scale, float softcap) {
  constexpr int TILE = (D / 64) * kPanel;
  constexpr int BQ = kTileRows * NWG;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = align1024(smem_raw);          // NWG tiles
  unsigned char* dos = qs + NWG * TILE;             // NWG tiles
  unsigned char* ks = dos + NWG * TILE;             // STAGES tiles
  unsigned char* vs = ks + STAGES * TILE;           // STAGES tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(vs + STAGES * TILE);
  uint64_t* full = bars;
  uint64_t* empty = bars + STAGES;
  uint64_t* qbar = bars + 2 * STAGES;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int k_lo = window > 0 ? (max(0, q0 - window + 1) / kTileRows) * kTileRows : 0;
  const int n_tiles = (S - k_lo + kTileRows - 1) / kTileRows;
  const int live = live_groups(NWG, q0, S);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  init_barriers(bars, STAGES, 4 * live, 1);

  if (warp >= 4 * NWG) {
    regs_dec<kProducerRegs>();
    if (threadIdx.x == 128 * NWG) {
      mbar_expect_tx(qbar, 2 * live * TILE);
      for (int w = 0; w < live; ++w) {
        tma_tile<D>(qs + w * TILE, &tq, qbar, q0 + kTileRows * w, h, b);
        tma_tile<D>(dos + w * TILE, &tdo, qbar, q0 + kTileRows * w, h, b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % STAGES;
        if (t >= STAGES) mbar_wait(&empty[st], (t / STAGES - 1) & 1);
        mbar_expect_tx(&full[st], 2 * TILE);
        tma_tile<D>(ks + st * TILE, &tk, &full[st], k_lo + kTileRows * t, kvh, b);
        tma_tile<D>(vs + st * TILE, &tv, &full[st], k_lo + kTileRows * t, kvh, b);
      }
    }
    return;
  }
  const int wg = warpgroup();
  if (wg >= live) return;
  regs_inc<consumer_regs(NWG)>();

  const int c = lane % 4;
  const int r_lo = q0 + kTileRows * wg;
  const int row0 = r_lo + 16 * (warp % 4) + lane / 4;
  const uint32_t q_addr = smem_u32(qs + wg * TILE);
  const uint32_t do_addr = smem_u32(dos + wg * TILE);
  const float sl2 = scale * kLog2e;
  const long long bh = (long long)b * H + h;
  float lq[2], dl[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = row0 + 8 * hf;
    lq[hf] = row < S_pad ? lse2[bh * S_pad + row] : INFINITY;
    dl[hf] = row < S_pad ? delta[bh * S_pad + row] : 0.f;
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float s[32], dp[32];   // S and dP of a key tile; then P and dS
  uint32_t da[4][4];     // dS of the tile in dQ += dS K, bf16

  mbar_wait(qbar, 0);
  mbar_wait(&full[0], 0);
  __syncwarp();
  group_ss2<D>(s, q_addr, smem_u32(ks), dp, do_addr, smem_u32(vs));
  wg_wait_all();
  pin(s);
  pin(dp);
  dq_grads(s, dp, lq, dl, row0, r_lo, k_lo, c, S, window, sl2, scale, softcap);
  frags(da, dp);

  for (int t = 0; t + 1 < n_tiles; ++t) {
    const int st = t % STAGES, nx = (t + 1) % STAGES;
    group_rs(acc, da, smem_u32(ks + st * TILE));
    wg_wait_all();
    pin(acc);
    pin(da);
    release(&empty[st], lane);
    mbar_wait(&full[nx], ((t + 1) / STAGES) & 1);
    __syncwarp();
    group_ss2<D>(s, q_addr, smem_u32(ks + nx * TILE), dp, do_addr, smem_u32(vs + nx * TILE));
    wg_wait_all();
    pin(s);
    pin(dp);
    dq_grads(s, dp, lq, dl, row0, r_lo, k_lo + kTileRows * (t + 1), c, S, window, sl2, scale,
             softcap);
    frags(da, dp);
  }
  group_rs(acc, da, smem_u32(ks + ((n_tiles - 1) % STAGES) * TILE));
  wg_wait_all();
  pin(acc);
  pin(da);
  release(&empty[(n_tiles - 1) % STAGES], lane);

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = row0 + 8 * hf;
    if (row >= S) continue;
    bf16* p = dq + b * sdq.b + h * sdq.h + row * sdq.s;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * c;
      if (col < dh)
        *reinterpret_cast<uint32_t*>(p + col) =
            pack_bf16(acc[4 * j + 2 * hf] * scale, acc[4 * j + 2 * hf + 1] * scale);
    }
  }
}

// dK/dV's P^T and dS^T of the query tile at qq, in place in s and dp: rows
// keys (key0, key0 + 8), columns queries, whose lse2 and delta are in
// shared memory (lq, dlt).
__device__ __forceinline__ void dkv_grads(float (&s)[32], float (&dp)[32], const float* lq,
                                          const float* dlt, int qq, int key0, int kw_lo, int c,
                                          int window, float sl2, float scale, float softcap) {
  const bool need_mask = window > 0 && qq + kTileRows - 1 - kw_lo >= window;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * c;
    const float2 l2 = *reinterpret_cast<const float2*>(lq + col);
    const float2 d2 = *reinterpret_cast<const float2*>(dlt + col);
    if (!need_mask && softcap <= 0.f) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(s[4 * j + e], sl2, -((e & 1) ? l2.y : l2.x)));
        dp[4 * j + e] = p * (dp[4 * j + e] - ((e & 1) ? d2.y : d2.x));
        s[4 * j + e] = p;
      }
      continue;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kpos = key0 + 8 * (e >> 1);
      const int qpos = qq + col + (e & 1);
      const bool seen = !need_mask || qpos - kpos < window;
      grad_elem(s[4 * j + e], dp[4 * j + e], (e & 1) ? l2.y : l2.x, (e & 1) ? d2.y : d2.x, seen,
                sl2, scale, softcap);
    }
  }
}

// One wgmma group: dV += P^T dO and dK += dS^T Q, dO and Q MN-major.
template <int N>
__device__ __forceinline__ void group_dkv(float (&dv)[N], uint32_t (&pa)[4][4], uint32_t do_addr,
                                          float (&dk)[N], uint32_t (&da)[4][4], uint32_t q_addr) {
  pin(dv);
  pin(dk);
  pin(pa);
  pin(da);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_rs(dv, pa[kk], do_addr, kk);
    wgmma_rs(dk, da[kk], q_addr, kk);
  }
  wg_commit();
}

// dK, dV for a (key tile of 64 * NWG keys, KV head x part, batch): K and V
// loaded once, the tiles of Q and dO (with their lse2 and delta) of the
// part's query heads streamed.  Each step's two groups (S^T and dP^T, then
// dV, dK +=) run one after the other: holding the next step's S^T and dP^T
// beside four accumulators in flight left ptxas short of registers, and
// it serialized every wgmma (slower on the card: PERF.md, flash findings).
// parts == 1: dK (times scale) and dV written in bf16; else fp32 partials
// into `partial` for flash_bwd_dkv_sum_kernel.
template <int D, int NWG, int STAGES>
__global__ void __launch_bounds__(128 * (NWG + 1), 1)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tdo,
                               const float* __restrict__ lse2, const float* __restrict__ delta,
                               bf16* __restrict__ dk, bf16* __restrict__ dv, Strides sdk,
                               Strides sdv, float* __restrict__ partial, int parts, int B, int H,
                               int KV, int S, int S_pad, int dh, int window, float scale,
                               float softcap) {
  constexpr int TILE = (D / 64) * kPanel;
  constexpr int BN = kTileRows * NWG;
  constexpr int ROWS_BYTES = kTileRows * 4;                // one tile's lse2 (or delta)
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ks = align1024(smem_raw);          // NWG tiles
  unsigned char* vs = ks + NWG * TILE;              // NWG tiles
  unsigned char* qs = vs + NWG * TILE;              // STAGES tiles
  unsigned char* dos = qs + STAGES * TILE;          // STAGES tiles
  float* ls = reinterpret_cast<float*>(dos + STAGES * TILE);   // STAGES x 64
  float* dls = ls + STAGES * kTileRows;                         // STAGES x 64
  uint64_t* bars = reinterpret_cast<uint64_t*>(dls + STAGES * kTileRows);
  uint64_t* full = bars;
  uint64_t* empty = bars + STAGES;
  uint64_t* kbar = bars + 2 * STAGES;

  const int k0 = blockIdx.x * BN;
  const int kvh = blockIdx.y / parts;
  const int part = blockIdx.y % parts;
  const int b = blockIdx.z;
  const int G = H / KV;
  const int heads = G / parts;                      // query heads of this part
  const int h0 = kvh * G + part * heads;
  // the query tiles that see a key of this block
  const int q_hi = window > 0 ? min(S, k0 + BN - 1 + window) : S;
  const int n_qt = (q_hi + kTileRows - 1) / kTileRows;
  const int n_steps = heads * n_qt;
  const int live = live_groups(NWG, k0, S);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  init_barriers(bars, STAGES, 4 * live, 1);

  if (warp >= 4 * NWG) {
    regs_dec<kProducerRegs>();
    if (threadIdx.x == 128 * NWG) {
      mbar_expect_tx(kbar, 2 * live * TILE);
      for (int w = 0; w < live; ++w) {
        tma_tile<D>(ks + w * TILE, &tk, kbar, k0 + kTileRows * w, kvh, b);
        tma_tile<D>(vs + w * TILE, &tv, kbar, k0 + kTileRows * w, kvh, b);
      }
      const float* lrow = lse2 + ((long long)b * H + h0) * S_pad;
      const float* drow = delta + ((long long)b * H + h0) * S_pad;
      for (int i = 0, hh = h0, qq = 0; i < n_steps; ++i) {
        const int st = i % STAGES;
        if (i >= STAGES) mbar_wait(&empty[st], (i / STAGES - 1) & 1);
        mbar_expect_tx(&full[st], 2 * TILE + 2 * ROWS_BYTES);
        tma_tile<D>(qs + st * TILE, &tq, &full[st], qq, hh, b);
        tma_tile<D>(dos + st * TILE, &tdo, &full[st], qq, hh, b);
        bulk_load(ls + st * kTileRows, lrow + qq, ROWS_BYTES, &full[st]);
        bulk_load(dls + st * kTileRows, drow + qq, ROWS_BYTES, &full[st]);
        qq += kTileRows;
        if (qq >= n_qt * kTileRows) {   // the next query head of the part
          qq = 0;
          ++hh;
          lrow += S_pad;
          drow += S_pad;
        }
      }
    }
    return;
  }
  const int wg = warpgroup();
  if (wg >= live) return;
  regs_inc<consumer_regs(NWG)>();

  const int c = lane % 4;
  const int kw_lo = k0 + kTileRows * wg;                 // this warpgroup's keys
  const int key0 = kw_lo + 16 * (warp % 4) + lane / 4;   // this thread's keys: key0, key0 + 8
  const uint32_t k_addr = smem_u32(ks + wg * TILE);
  const uint32_t v_addr = smem_u32(vs + wg * TILE);
  const float sl2 = scale * kLog2e;

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  float s[32], dp[32];           // S^T and dP^T of a step; then P^T and dS^T
  uint32_t pa[4][4], da[4][4];   // P^T and dS^T of the step in dV, dK +=, bf16
#define DKV_SCORES(st) \
  group_ss2<D>(s, k_addr, smem_u32(qs + (st) * TILE), dp, v_addr, smem_u32(dos + (st) * TILE))
#define DKV_GRADS(i, st)                                                                     \
  dkv_grads(s, dp, ls + (st) * kTileRows, dls + (st) * kTileRows, ((i) % n_qt) * kTileRows, \
            key0, kw_lo, c, window, sl2, scale, softcap)
#define DKV_PRODUCTS(st)                                                 \
  group_dkv(dv_acc, pa, smem_u32(dos + (st) * TILE), dk_acc, da,        \
            smem_u32(qs + (st) * TILE))
#define DKV_RETIRE(st) \
  wg_wait_all();       \
  pin(dv_acc);         \
  pin(dk_acc);         \
  pin(pa);             \
  pin(da);             \
  release(&empty[st], lane)

  mbar_wait(kbar, 0);
  mbar_wait(&full[0], 0);
  __syncwarp();
  DKV_SCORES(0);
  wg_wait_all();
  pin(s);
  pin(dp);
  DKV_GRADS(0, 0);
  frags(pa, s);
  frags(da, dp);

  for (int i = 0; i + 1 < n_steps; ++i) {
    const int st = i % STAGES, nx = (i + 1) % STAGES;
    DKV_PRODUCTS(st);
    DKV_RETIRE(st);
    mbar_wait(&full[nx], ((i + 1) / STAGES) & 1);
    __syncwarp();
    DKV_SCORES(nx);
    wg_wait_all();
    pin(s);
    pin(dp);
    DKV_GRADS(i + 1, nx);
    frags(pa, s);
    frags(da, dp);
  }
  DKV_PRODUCTS((n_steps - 1) % STAGES);
  DKV_RETIRE((n_steps - 1) % STAGES);
#undef DKV_SCORES
#undef DKV_GRADS
#undef DKV_PRODUCTS
#undef DKV_RETIRE

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int kpos = key0 + 8 * hf;
    if (kpos >= S) continue;
    if (parts == 1) {
      bf16* dkp = dk + b * sdk.b + kvh * sdk.h + kpos * sdk.s;
      bf16* dvp = dv + b * sdv.b + kvh * sdv.h + kpos * sdv.s;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int col = 8 * j + 2 * c;
        if (col < dh) {
          *reinterpret_cast<uint32_t*>(dkp + col) =
              pack_bf16(dk_acc[4 * j + 2 * hf] * scale, dk_acc[4 * j + 2 * hf + 1] * scale);
          *reinterpret_cast<uint32_t*>(dvp + col) =
              pack_bf16(dv_acc[4 * j + 2 * hf], dv_acc[4 * j + 2 * hf + 1]);
        }
      }
    } else {
      const long long plane = (long long)parts * B * KV * S * dh;   // the dK partials' size
      float* pk = partial + ((((long long)part * B + b) * KV + kvh) * S + kpos) * dh;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int col = 8 * j + 2 * c;
        if (col < dh) {
          *reinterpret_cast<float2*>(pk + col) =
              make_float2(dk_acc[4 * j + 2 * hf], dk_acc[4 * j + 2 * hf + 1]);
          *reinterpret_cast<float2*>(pk + plane + col) =
              make_float2(dv_acc[4 * j + 2 * hf], dv_acc[4 * j + 2 * hf + 1]);
        }
      }
    }
  }
}

// dK (times scale) and dV in bf16 from the parts' fp32 partials, summed in
// part order: one thread per pair of columns.
__global__ void flash_bwd_dkv_sum_kernel(const float* __restrict__ partial, bf16* __restrict__ dk,
                                         bf16* __restrict__ dv, Strides sdk, Strides sdv,
                                         int parts, int B, int KV, int S, int dh, float scale) {
  const long long n = (long long)B * KV * S * dh;
  const long long e = 2 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  if (e >= n) return;
  float2 sk = make_float2(0.f, 0.f), sv = make_float2(0.f, 0.f);
  for (int p = 0; p < parts; ++p) {
    const float2 x = *reinterpret_cast<const float2*>(partial + p * n + e);
    const float2 y = *reinterpret_cast<const float2*>(partial + (parts + p) * n + e);
    sk.x += x.x;
    sk.y += x.y;
    sv.x += y.x;
    sv.y += y.y;
  }
  const int col = (int)(e % dh);
  const long long row = e / dh;
  const int s = (int)(row % S);
  const int kvh = (int)((row / S) % KV);
  const int b = (int)(row / ((long long)S * KV));
  *reinterpret_cast<uint32_t*>(dk + b * sdk.b + kvh * sdk.h + s * sdk.s + col) =
      pack_bf16(sk.x * scale, sk.y * scale);
  *reinterpret_cast<uint32_t*>(dv + b * sdv.b + kvh * sdv.h + s * sdv.s + col) =
      pack_bf16(sv.x, sv.y);
}

// ---------------------------------------------------------------------------
// host side: tensor maps, plans, launches
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled through the runtime (no -lcuda).
inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 4-D map (head_dim, S, heads, batch) of a bf16 tensor read by its
// strides, 64 x 64 boxes in the 128-byte swizzle; zeros out of bounds.
inline int make_map(CUtensorMap* map, const void* ptr, Strides st, int B, int heads, int S,
                    int dh) {
  const EncodeTiled enc = encoder();
  if (!enc) return (int)cudaErrorNotSupported;
  // a dimension of size 1 is never stepped: any legal stride does
  const cuuint64_t packed = (cuuint64_t)dh * 2 * S * heads;
  cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)S, (cuuint64_t)heads, (cuuint64_t)B};
  cuuint64_t strides[3] = {S > 1 ? (cuuint64_t)st.s * 2 : packed,
                           heads > 1 ? (cuuint64_t)st.h * 2 : packed,
                           B > 1 ? (cuuint64_t)st.b * 2 : packed};
  cuuint32_t box[4] = {64, 64, 1, 1};
  cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                         strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

inline int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (!counts[dev]) cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
  return counts[dev] > 0 ? counts[dev] : 132;
}

// Block shapes by instance (consumer warpgroups, ring stages), chosen on
// the card (PERF.md, flash findings; tools/flash_variants.py tries others).
template <int D>
struct Fwd {
  static constexpr int NWG = D <= 64 ? 3 : 2, STAGES = D <= 64 ? 4 : 3;
};
template <int D>
struct Dq {
  static constexpr int NWG = 2, STAGES = D <= 64 ? 3 : 2;
};
template <int D>
struct Dkv {
  static constexpr int NWG = 2, STAGES = D <= 64 ? 4 : 2;
};

inline int pad_rows(int S) { return (S + kTileRows - 1) / kTileRows * kTileRows; }

// The parts the dK/dV blocks split a group's G query heads into: the
// fewest (a divisor of G) that give every SM a block.
inline int dkv_parts(int B, int H, int KV, int S, int bn) {
  const int G = H / KV;
  const long long blocks = (long long)KV * B * ((S + bn - 1) / bn);
  const int sms = sm_count();
  int parts = 1;
  while (blocks * parts < sms && parts < G) {
    ++parts;
    while (G % parts) ++parts;
  }
  return parts;
}

inline int bn_of(int dh) { return kTileRows * (dh <= 64 ? Dkv<64>::NWG : Dkv<128>::NWG); }

// floats of the backward's workspace: lse2 and delta, (B, H, S_pad) each,
// then the dK and dV partials when the dK/dV blocks split the heads.
inline long long workspace_floats(int B, int H, int KV, int S, int dh) {
  const long long rows = 2LL * B * H * pad_rows(S);
  const int parts = dkv_parts(B, H, KV, S, bn_of(dh));
  return rows + (parts > 1 ? 2LL * parts * B * KV * S * dh : 0);
}

}  // namespace sm90
