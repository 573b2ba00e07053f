// Flash attention's bf16 route for Hopper: `wgmma` products on tiles that
// TMA brings into shared memory, a producer keeping a ring of them in
// flight.  Every bf16 call runs here, causal or not, at head_dim instances
// 64, 128 and 256.  Included by flash_attention.cu, which holds the C entry
// points and the fp32 route; see the note at its top for the route choice.
// It replaces the Pallas kernel `_flash_kernel`
// (src/repro/kernels/flash_attention.py, pallas_call at :108, its tile
// pruning at :38-51) and adds its gradient.
//
// Bound.  The trainer's causal shape (Qwen3-1.7B: B=8, H=16, KV=8, S=512,
// D=128) does ~8.6 GFLOP forward against ~50 MB: ~170 flops a byte, under
// bf16's ridge (~295), so the bytes bound it (15 us at 3.35 TB/s; 9 us of
// products at 989 TFLOP/s).  Seamless' encoder (B=16, H=KV=16, S=1,024,
// D=64, not causal) does 6.9e10 flops against 0.13 GB: the operations bound
// it (69 us), and at D=64 the softmax's exponentials (one per score, 16 a
// clock on an SM) take as long as the products.  Neither bound is what the
// earlier `mma.sync` kernels met: at 0.07 ms against 15 us the causal
// route was held by latency, a block's copies and products serialised in
// each warp and the tensor cores fed 32 keys at a time.  So the design
// keeps loads, products and exponentials apart and busy at once: a producer
// warp issuing TMA copies ahead, several consumer warpgroups per block, and
// up to D = 128 each forward warpgroup's next S on the tensor cores while
// it runs a softmax.
//
// Shapes.  Every tile is 64 rows by D (64, 128 or 256) bf16, stored as
// D / 64 "panels" of 64 x 64: one TMA box each, rows of 128 bytes in the
// 128-byte swizzle, 1,024-byte aligned, which is the layout `wgmma`'s
// 128-byte swizzle mode reads.  A block is NWG consumer warpgroups of 64
// rows each plus a producer warp (the block's last: one of its threads
// issues every load; `block_threads` says why not a warpgroup).  The
// operand a block keeps (Q in the forward, Q and dO in dQ, K and V in
// dK/dV) is loaded once; the operand it streams comes through a ring of
// STAGES tiles of 64 rows, each stage with a `full` barrier (TMA's byte
// count) and an `empty` barrier (one arrival per consumer warp).  A block's
// warpgroups whose rows all lie past S leave at once (the ring counts only
// the others).  Registers decide the shapes at D = 256 (`Fwd`, `Dq`, `Dkv`
// below): O, dQ, dK and dV are 128 fp32 registers a thread each, so the
// forward and dQ run one consumer warpgroup (255 registers a thread), and
// dK/dV (from D = 128) splits dV and dK over a pair of warpgroups that
// hand P^T over through shared memory, at D = 256 with no producer warp.
//
// Causality.  A query block's keys end at its last live row's diagonal
// (the TPU kernel's pruning), and only the tile that the diagonal, the
// window's edge or S cuts pays for element masks.  A block's warpgroups see
// a ragged band: under causality the first one's rows stop a tile before
// the next one's.  Every consumer warp still arrives on every stage's
// `empty` barrier, in order: a warpgroup passes the tiles it does not need
// (waits for each to land, so that its arrival falls in that tile's phase,
// and releases it unread).  In dK/dV the query tiles of a key block start
// at its diagonal, and its second warpgroup passes each head's first one.
// The latest query tiles (the most keys) launch first; dK/dV cuts each key
// block's (query head, query tile) steps into even parts over the SMs (the
// first key block sees every query tile), its parts writing fp32 partials
// that a last kernel sums in a fixed order: no atomics, so every backward
// gives the same bits run to run.
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
// a query past S weighs nothing without a mask; then the dK/dV partials.

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
// At D = 256, two n128 products: columns 0-127 (panels 0, 1) and 128-255
// (panels 2, 3), the accumulator's halves in the same fragment layout.
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4], uint32_t addr,
                                         int kk) {
  wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(&d[0]), a, desc_mn(addr, kk), 1);
  wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(&d[64]), a, desc_mn(addr + 2 * kPanel, kk), 1);
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

// A block's threads: NWG consumer warpgroups and one producer warp.  No
// warpgroup hands registers over by `setmaxnreg`: ptxas allocates every
// thread the count that the launch bound allows (with a producer warpgroup
// and `setmaxnreg.inc` 232 the D = 256 forward's SASS used no register
// past R171, spilled 1 KB a thread and serialized its wgmmas), and the
// same gate (16K registers a partition over its warps) holds for a
// producer warp: what frees registers is fewer warps (`Fwd`, `Dkv`).
constexpr int kProducer = 32;
__host__ __device__ constexpr int block_threads(int nwg) { return 128 * nwg + kProducer; }

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

// The 64-key tiles from k_lo (a multiple of 64) up to key k_hi.
__host__ __device__ __forceinline__ int tiles_to(int k_hi, int k_lo) {
  return (k_hi - k_lo + kTileRows - 1) / kTileRows;
}

// A query block's (head, batch, first row).  Under causality the grid is
// (H, B, query tiles) and the latest query tiles, which see the most keys,
// come first, so the grid's tail is short; without it (query tiles, H, B),
// so that the query tiles of one head run together and share its K and V
// in L2 (Seamless' encoder: 67 MB of K and V, more than L2's 50).
__device__ __forceinline__ void query_block(int causal, int rows, int* h, int* b, int* q0) {
  *h = causal ? blockIdx.x : blockIdx.y;
  *b = causal ? blockIdx.y : blockIdx.z;
  *q0 = (causal ? gridDim.z - 1 - blockIdx.z : blockIdx.x) * rows;
}

// The first key a query block from q0 sees, rounded down to a tile: the
// window's start (0 without a window).
__device__ __forceinline__ int first_key(int q0, int window) {
  return window > 0 ? (max(0, q0 - window + 1) / kTileRows) * kTileRows : 0;
}

// The end of the keys that rows [r0, r0 + rows) see: under causality their
// last row's diagonal, else S.
__device__ __forceinline__ int last_key(int r0, int rows, int S, int causal) {
  return causal ? min(S, r0 + rows) : S;
}

// Whether a 64 x 64 tile of query rows from r0 and keys from k0 needs
// element masks: S, the causal diagonal or the window's edge cuts it.
__device__ __forceinline__ bool cut_rows(int r0, int k0, int S, int causal, int window) {
  return k0 + kTileRows > S || (causal && k0 + kTileRows - 1 > r0) ||
         (window > 0 && r0 + kTileRows - 1 - k0 >= window);
}

// The same for a tile of keys from kw0 (rows) and queries from qq
// (columns): queries past S need no mask (their lse2 is +inf).
__device__ __forceinline__ bool cut_keys(int kw0, int qq, int causal, int window) {
  return (causal && qq < kw0 + kTileRows - 1) ||
         (window > 0 && qq + kTileRows - 1 - kw0 >= window);
}

// Whether no query of the tile at qq sees a key of the tile at kw0: all
// before the keys' diagonal, or all past the window.
__device__ __forceinline__ bool unseen_keys(int kw0, int qq, int causal, int window) {
  return (causal && qq + kTileRows - 1 < kw0) ||
         (window > 0 && qq - (kw0 + kTileRows - 1) >= window);
}

// A consumer's release of ring tiles it does not read (they belong to the
// block's other warpgroups): each waited for, so that the arrival lands in
// the stage's current phase, then released.
template <int STAGES>
__device__ __forceinline__ void pass_tiles(uint64_t* full, uint64_t* empty, int from, int to,
                                           int lane) {
  for (int t = from; t < to; ++t) {
    mbar_wait(&full[t % STAGES], (t / STAGES) & 1);
    release(&empty[t % STAGES], lane);
  }
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
                                             bool need_mask, int S, int causal, int window,
                                             float scale, float sl2, float softcap) {
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
            } else if (!visible(row, kpos, causal, window)) {
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

// One block per (head, batch, query tile of 64 * NWG rows), in
// `query_block`'s order.  Each consumer warpgroup holds 64 query rows and,
// up to D = 128, runs two tiles at once: while the tensor cores compute S
// of key tile t + 1 and O += P V of tile t, the warpgroup runs the softmax
// of tile t + 1 (its wgmma groups are waited one at a time).  The producer streams the key tiles of the block's last live
// warpgroup; under causality an earlier warpgroup stops at its own
// diagonal and passes the tiles after it.
template <int D, int NWG, int STAGES, bool CAUSAL>
__global__ void __launch_bounds__(block_threads(NWG), 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                           float* __restrict__ lse, Strides so, int H, int KV, int S, int dh,
                           int window, float scale, float softcap) {
  constexpr int causal = CAUSAL;   // a template argument: no causal code where it is false
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

  int h, b, q0;
  query_block(causal, BQ, &h, &b, &q0);
  const int kvh = h / (H / KV);
  const int live = live_groups(NWG, q0, S);
  const int k_lo = first_key(q0, window);
  const int n_tiles = tiles_to(last_key(q0, kTileRows * live, S, causal), k_lo);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  init_barriers(bars, STAGES, 4 * live, 1);

  if (warp >= 4 * NWG) {   // the producer warp: one thread issues every load
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

  const int c = lane % 4;
  const int r_lo = q0 + kTileRows * wg;                  // this warpgroup's rows
  const int row0 = r_lo + 16 * (warp % 4) + lane / 4;    // this thread's rows: row0, row0 + 8
  const int n_mine = tiles_to(last_key(r_lo, kTileRows, S, causal), k_lo);
  const uint32_t q_addr = smem_u32(qs + wg * TILE);
  const float sl2 = scale * kLog2e;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
  float s[32];        // S of a tile, then its P (fp32)
  uint32_t pa[4][4];  // P of the tile in O += P V, bf16
#define FWD_SOFTMAX(k0)                                                                 \
  softmax_tile(s, m, l, alpha, row0, k0, c, cut_rows(r_lo, k0, S, causal, window), S, \
               causal, window, scale, sl2, softcap)

  mbar_wait(qbar, 0);
  if constexpr (D > 128) {
    // At D = 256 one tile at a time: O's 128 registers beside S of the next
    // tile and P of this one in flight spilled a kilobyte a thread; the
    // block's two warpgroups still overlap each other.
    for (int t = 0; t < n_mine; ++t) {
      const int st = t % STAGES;
      mbar_wait(&full[st], (t / STAGES) & 1);
      __syncwarp();
      group_ss<D>(s, q_addr, smem_u32(ks + st * TILE));
      wg_wait_all();
      pin(s);
      FWD_SOFTMAX(k_lo + kTileRows * t);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j] *= alpha[0];
        acc[4 * j + 1] *= alpha[0];
        acc[4 * j + 2] *= alpha[1];
        acc[4 * j + 3] *= alpha[1];
      }
      frags(pa, s);
      group_rs(acc, pa, smem_u32(vs + st * TILE));
      wg_wait_all();
      pin(acc);
      pin(pa);
      release(&empty[st], lane);
    }
  } else {
    mbar_wait(&full[0], 0);
    __syncwarp();
    group_ss<D>(s, q_addr, smem_u32(ks));
    wg_wait_all();
    pin(s);
    FWD_SOFTMAX(k_lo);
    frags(pa, s);

    // every tile but the last: its P V beside the next tile's S (two groups,
    // waited one at a time: the softmax of the next tile runs in between)
    for (int t = 0; t + 1 < n_mine; ++t) {
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
    group_rs(acc, pa, smem_u32(vs + ((n_mine - 1) % STAGES) * TILE));
    wg_wait_all();
    pin(acc);
    pin(pa);
    release(&empty[(n_mine - 1) % STAGES], lane);
  }
#undef FWD_SOFTMAX

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
  if constexpr (CAUSAL) pass_tiles<STAGES>(full, empty, n_mine, n_tiles, lane);
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
                                         int S, int causal, int window, float sl2, float scale,
                                         float softcap) {
  if (!cut_rows(r_lo, k0, S, causal, window) && softcap <= 0.f) {
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
      const bool seen = kpos < S && visible(row, kpos, causal, window);
      grad_elem(s[4 * j + e], dp[4 * j + e], lq[e >> 1], dl[e >> 1], seen, sl2, scale, softcap);
    }
  }
}

// dQ for a (head, batch, query tile of 64 * NWG rows), in `query_block`'s
// order: Q and dO loaded once, K and V streamed (up to the last live
// warpgroup's diagonal under causality; an earlier warpgroup passes the
// tiles after its own).  Each tile's two groups (S and dP, then dQ += dS K)
// run one after the other: overlapping the next tile's S and dP with this
// tile's dQ product, as the forward does, ran no faster at D = 64 and
// slower at D = 128 (PERF.md, flash findings); the warpgroups overlap each
// other.
template <int D, int NWG, int STAGES, bool CAUSAL>
__global__ void __launch_bounds__(block_threads(NWG), 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo,
                              const float* __restrict__ lse2, const float* __restrict__ delta,
                              bf16* __restrict__ dq, Strides sdq, int H, int KV, int S, int S_pad,
                              int dh, int window, float scale, float softcap) {
  constexpr int causal = CAUSAL;   // a template argument: no causal code where it is false
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

  int h, b, q0;
  query_block(causal, BQ, &h, &b, &q0);
  const int kvh = h / (H / KV);
  const int live = live_groups(NWG, q0, S);
  const int k_lo = first_key(q0, window);
  const int n_tiles = tiles_to(last_key(q0, kTileRows * live, S, causal), k_lo);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  init_barriers(bars, STAGES, 4 * live, 1);

  if (warp >= 4 * NWG) {
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

  const int c = lane % 4;
  const int r_lo = q0 + kTileRows * wg;
  const int row0 = r_lo + 16 * (warp % 4) + lane / 4;
  const int n_mine = tiles_to(last_key(r_lo, kTileRows, S, causal), k_lo);
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
  dq_grads(s, dp, lq, dl, row0, r_lo, k_lo, c, S, causal, window, sl2, scale, softcap);
  frags(da, dp);

  for (int t = 0; t + 1 < n_mine; ++t) {
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
    dq_grads(s, dp, lq, dl, row0, r_lo, k_lo + kTileRows * (t + 1), c, S, causal, window, sl2,
             scale, softcap);
    frags(da, dp);
  }
  group_rs(acc, da, smem_u32(ks + ((n_mine - 1) % STAGES) * TILE));
  wg_wait_all();
  pin(acc);
  pin(da);
  release(&empty[(n_mine - 1) % STAGES], lane);

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
  if constexpr (CAUSAL) pass_tiles<STAGES>(full, empty, n_mine, n_tiles, lane);
}

// The work of a dK/dV block: the key block of `bn` keys from k0, the query
// tiles it sees (n_qt tiles of 64 from tile qt_lo), and its part: steps
// [s0, s0 + n_steps) of the block's G x n_qt (query head, query tile)
// steps, head-major; `parts` is the number of parts of its key block.
struct KvWork {
  int k0, qt_lo, n_qt, part, parts, s0, n_steps;
};

// The steps of the key block at k0 (bn keys): for each of the G query
// heads, the query tiles from the block's diagonal (under causality; else
// the first) to the last one the window lets see a key of the block.
__host__ __device__ inline int kv_steps(int k0, int bn, int S, int G, int causal, int window,
                                        int* qt_lo, int* n_qt) {
  const int lo = causal ? k0 / kTileRows : 0;
  const int hi = window > 0 ? min(S, k0 + bn - 1 + window) : S;
  *qt_lo = lo;
  *n_qt = (hi + kTileRows - 1) / kTileRows - lo;
  return G * *n_qt;
}

// A key block's steps are cut into ceil(steps / chunk) parts of even size,
// one block each; a key block of more than one part writes fp32 partials
// that flash_bwd_dkv_sum_kernel sums in part order.
__host__ __device__ inline int kv_parts(int steps, int chunk) { return (steps + chunk - 1) / chunk; }

// Block x of the dK/dV grid's work: the key blocks in order (under
// causality the first sees the most query tiles), each key block's parts
// in turn.  Under causality x is the grid's z, after (KV, B), so that the
// heaviest key blocks of every head start first; else its x, so that the
// blocks of one head run together and share its Q and dO in L2.
__device__ inline KvWork kv_work(int x, int bn, int S, int G, int causal, int window, int chunk) {
  KvWork w{};
  for (w.k0 = 0;; w.k0 += bn) {
    const int steps = kv_steps(w.k0, bn, S, G, causal, window, &w.qt_lo, &w.n_qt);
    w.parts = kv_parts(steps, chunk);
    if (x < w.parts) {
      w.part = x;
      w.s0 = (int)((long long)x * steps / w.parts);
      w.n_steps = (int)((long long)(x + 1) * steps / w.parts) - w.s0;
      return w;
    }
    x -= w.parts;
  }
}

// Step i of a dK/dV block into ring stage i % STAGES: the Q and dO tiles
// of query head h0 + step / n_qt, query tile qt_lo + step % n_qt (step =
// s0 + i), and their lse2 and delta rows.
template <int D, int STAGES>
__device__ __forceinline__ void kv_load(const KvWork& w, int i, const CUtensorMap* tq,
                                        const CUtensorMap* tdo, const float* lse2,
                                        const float* delta, unsigned char* qs, unsigned char* dos,
                                        float* ls, float* dls, uint64_t* full, int b, int H,
                                        int h0, int S_pad) {
  constexpr int TILE = (D / 64) * kPanel;
  constexpr int ROWS_BYTES = kTileRows * 4;   // one tile's lse2 (or delta)
  const int st = i % STAGES;
  const int step = w.s0 + i;
  const int hh = h0 + step / w.n_qt;
  const int qq = (w.qt_lo + step % w.n_qt) * kTileRows;
  mbar_expect_tx(&full[st], 2 * TILE + 2 * ROWS_BYTES);
  tma_tile<D>(qs + st * TILE, tq, &full[st], qq, hh, b);
  tma_tile<D>(dos + st * TILE, tdo, &full[st], qq, hh, b);
  const long long row = ((long long)b * H + hh) * S_pad + qq;
  bulk_load(ls + st * kTileRows, lse2 + row, ROWS_BYTES, &full[st]);
  bulk_load(dls + st * kTileRows, delta + row, ROWS_BYTES, &full[st]);
}

// The dK/dV producer's loop: every step, each once its stage is free.
template <int D, int STAGES>
__device__ __forceinline__ void kv_produce(const KvWork& w, const CUtensorMap* tq,
                                           const CUtensorMap* tdo, const float* lse2,
                                           const float* delta, unsigned char* qs,
                                           unsigned char* dos, float* ls, float* dls,
                                           uint64_t* full, uint64_t* empty, int b, int H, int h0,
                                           int S_pad) {
  for (int i = 0; i < w.n_steps; ++i) {
    if (i >= STAGES) mbar_wait(&empty[i % STAGES], (i / STAGES - 1) & 1);
    kv_load<D, STAGES>(w, i, tq, tdo, lse2, delta, qs, dos, ls, dls, full, b, H, h0, S_pad);
  }
}

// A dK or dV accumulator (keys key0, key0 + 8; D columns) out: bf16 times
// `mul` where the key block is one part, else into `part`, this part's
// fp32 plane (B, KV, S, dh) at (b, kvh).
template <int N>
__device__ __forceinline__ void kv_store(const float (&acc)[N], bf16* out, Strides so,
                                         float* part, bool whole, int b, int kvh, int key0,
                                         int c, int S, int dh, float mul) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int kpos = key0 + 8 * hf;
    if (kpos >= S) continue;
    if (whole) {
      bf16* p = out + b * so.b + kvh * so.h + kpos * so.s;
#pragma unroll
      for (int j = 0; j < N / 4; ++j) {
        const int col = 8 * j + 2 * c;
        if (col < dh)
          *reinterpret_cast<uint32_t*>(p + col) =
              pack_bf16(acc[4 * j + 2 * hf] * mul, acc[4 * j + 2 * hf + 1] * mul);
      }
    } else {
      float* p = part + (long long)kpos * dh;
#pragma unroll
      for (int j = 0; j < N / 4; ++j) {
        const int col = 8 * j + 2 * c;
        if (col < dh)
          *reinterpret_cast<float2*>(p + col) =
              make_float2(acc[4 * j + 2 * hf], acc[4 * j + 2 * hf + 1]);
      }
    }
  }
}

// dK/dV's P^T and dS^T of the query tile at qq, in place in s and dp: rows
// keys (key0, key0 + 8; the warpgroup's from kw_lo), columns queries,
// whose lse2 and delta are in shared memory (lq, dlt).
__device__ __forceinline__ void dkv_grads(float (&s)[32], float (&dp)[32], const float* lq,
                                          const float* dlt, int qq, int key0, int kw_lo, int c,
                                          int causal, int window, float sl2, float scale,
                                          float softcap) {
  const bool need_mask = cut_keys(kw_lo, qq, causal, window);
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
      const bool seen = !need_mask || visible(qpos, kpos, causal, window);
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

// dK, dV for a (KV head, batch, part of a key block of 64 * NWG keys): K
// and V loaded once, the part's steps (query head, query tile, with their
// lse2 and delta) streamed; `kv_work` maps the block to its part.  Under
// causality a warpgroup passes, unread, a step whose queries see none of
// its keys (the first query tile of each head lies before the second
// warpgroup's diagonal, or past the window); without it every step runs
// (a window's empty tiles, on no path, computed and masked).  Each step's two groups (S^T and dP^T, then dV, dK +=) run one
// after the other: holding the next step's S^T and dP^T beside four
// accumulators in flight left ptxas short of registers, and it serialized
// every wgmma (slower on the card: PERF.md, flash findings).
template <int D, int NWG, int STAGES, bool CAUSAL>
__global__ void __launch_bounds__(block_threads(NWG), 1)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tdo,
                               const float* __restrict__ lse2, const float* __restrict__ delta,
                               bf16* __restrict__ dk, bf16* __restrict__ dv, Strides sdk,
                               Strides sdv, float* __restrict__ partial, int chunk,
                               int max_parts, int B, int H, int KV, int S, int S_pad, int dh,
                               int window, float scale, float softcap) {
  constexpr int causal = CAUSAL;   // a template argument: no causal code where it is false
  constexpr int TILE = (D / 64) * kPanel;
  constexpr int BN = kTileRows * NWG;
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

  const int kvh = causal ? blockIdx.x : blockIdx.y;
  const int b = causal ? blockIdx.y : blockIdx.z;
  const int G = H / KV;
  const KvWork w = kv_work(causal ? blockIdx.z : blockIdx.x, BN, S, G, causal, window, chunk);
  const int live = live_groups(NWG, w.k0, S);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  init_barriers(bars, STAGES, 4 * live, 1);

  if (warp >= 4 * NWG) {
    if (threadIdx.x == 128 * NWG) {
      mbar_expect_tx(kbar, 2 * live * TILE);
      for (int g = 0; g < live; ++g) {
        tma_tile<D>(ks + g * TILE, &tk, kbar, w.k0 + kTileRows * g, kvh, b);
        tma_tile<D>(vs + g * TILE, &tv, kbar, w.k0 + kTileRows * g, kvh, b);
      }
      kv_produce<D, STAGES>(w, &tq, &tdo, lse2, delta, qs, dos, ls, dls, full, empty, b, H,
                            kvh * G, S_pad);
    }
    return;
  }
  const int wg = warpgroup();
  if (wg >= live) return;

  const int c = lane % 4;
  const int kw_lo = w.k0 + kTileRows * wg;               // this warpgroup's keys
  const int key0 = kw_lo + 16 * (warp % 4) + lane / 4;   // this thread's keys: key0, key0 + 8
  const uint32_t k_addr = smem_u32(ks + wg * TILE);
  const uint32_t v_addr = smem_u32(vs + wg * TILE);
  const float sl2 = scale * kLog2e;

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  float s[32], dp[32];           // S^T and dP^T of a step; then P^T and dS^T
  uint32_t pa[4][4], da[4][4];   // P^T and dS^T of the step in dV, dK +=, bf16

  mbar_wait(kbar, 0);
  for (int i = 0; i < w.n_steps; ++i) {
    const int st = i % STAGES;
    const int qq = (w.qt_lo + (w.s0 + i) % w.n_qt) * kTileRows;
    mbar_wait(&full[st], (i / STAGES) & 1);
    if (!CAUSAL || !unseen_keys(kw_lo, qq, causal, window)) {
      const uint32_t q_addr = smem_u32(qs + st * TILE), do_addr = smem_u32(dos + st * TILE);
      __syncwarp();
      group_ss2<D>(s, k_addr, q_addr, dp, v_addr, do_addr);
      wg_wait_all();
      pin(s);
      pin(dp);
      dkv_grads(s, dp, ls + st * kTileRows, dls + st * kTileRows, qq, key0, kw_lo, c, causal,
                window, sl2, scale, softcap);
      frags(pa, s);
      frags(da, dp);
      group_dkv(dv_acc, pa, do_addr, dk_acc, da, q_addr);
      wg_wait_all();
      pin(dv_acc);
      pin(dk_acc);
      pin(pa);
      pin(da);
    }
    release(&empty[st], lane);
  }

  const long long plane = (long long)B * KV * S * dh;   // one part's dK (or dV) partials
  float* pk = partial + ((long long)w.part * B + b) * KV * S * dh + (long long)kvh * S * dh;
  kv_store(dk_acc, dk, sdk, pk, w.parts == 1, b, kvh, key0, c, S, dh, scale);
  kv_store(dv_acc, dv, sdv, pk + max_parts * plane, w.parts == 1, b, kvh, key0, c, S, dh, 1.f);
}

// The pair's hand-over, written by the first warpgroup: x holds S^T of the
// block's keys (rows key0, key0 + 8; from kw_lo) against the query tile at
// qq (columns; lse2 in lq) and becomes P^T; P^T times 1 - tanh^2 (the
// softcap's derivative; P^T itself without one) goes to `xs`, the slot of
// this thread's 4 j-th values at xs[128 j].  Masked pairs are 0 in both.
__device__ __forceinline__ void pair_p(float (&x)[32], float4* xs, const float* lq, int qq,
                                       int key0, int kw_lo, int c, int causal, int window,
                                       float sl2, float scale, float softcap) {
  const bool need_mask = cut_keys(kw_lo, qq, causal, window);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * c;
    const float2 l2 = *reinterpret_cast<const float2*>(lq + col);
    float g[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float lse = (e & 1) ? l2.y : l2.x;
      float p, gate;
      if (softcap > 0.f) {
        const float th = tanhf(x[4 * j + e] * scale / softcap);
        p = ex2(softcap * th * kLog2e - lse);
        gate = p * (1.f - th * th);
      } else {
        p = ex2(fmaf(x[4 * j + e], sl2, -lse));
        gate = p;
      }
      if (need_mask && !visible(qq + col + (e & 1), key0 + 8 * (e >> 1), causal, window))
        p = gate = 0.f;
      x[4 * j + e] = p;
      g[e] = gate;
    }
    xs[128 * j] = make_float4(g[0], g[1], g[2], g[3]);
  }
}

// The second warpgroup's half: x holds dP^T (same fragment layout) and
// becomes dS^T = gate (dP^T - delta), the gate read from the hand-over.
__device__ __forceinline__ void pair_ds(float (&x)[32], const float4* xs, const float* dlt,
                                        int c) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 d2 = *reinterpret_cast<const float2*>(dlt + 8 * j + 2 * c);
    const float4 g = xs[128 * j];
    x[4 * j] = g.x * (x[4 * j] - d2.x);
    x[4 * j + 1] = g.y * (x[4 * j + 1] - d2.y);
    x[4 * j + 2] = g.z * (x[4 * j + 2] - d2.x);
    x[4 * j + 3] = g.w * (x[4 * j + 3] - d2.y);
  }
}

// dK, dV for a (KV head, batch, part of a key tile of 64 keys), where one
// warpgroup cannot hold both 64 x D accumulators (D = 256: 256 registers a
// thread): a pair of consumer warpgroups splits them.  The first computes
// S^T = K Q^T, P^T and dV += P^T dO; the second dP^T = V dO^T, then dS^T =
// P^T (1 - tanh^2) (dP^T - delta) with the first's factor handed over
// through shared memory (16 KB; mbarriers xfull: written, xempty: read,
// every thread arriving, so that a lost hand-over traps as the ring's
// waits do), and dK += dS^T Q.  No product is computed twice.  Steps,
// parts and the partials as in flash_bwd_dkv_wgmma_kernel.  With OWN_LOADS
// the block has no producer warp: its 8 warps (two on each of the SM's
// four register partitions) may hold 255 registers a thread, where a
// ninth warp caps every thread at 168 (three warps on one partition of
// 16K registers), too few for D = 256's 128-register accumulator beside
// S^T and its fragments; the first warpgroup's first thread then issues
// the loads, refilling the stage of step i - 1 once its S^T of step i is
// in flight.
template <int D, int STAGES, bool CAUSAL, bool OWN_LOADS>
__global__ void __launch_bounds__(OWN_LOADS ? 256 : block_threads(2), 1)
    flash_bwd_dkv_pair_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                    const __grid_constant__ CUtensorMap tk,
                                    const __grid_constant__ CUtensorMap tv,
                                    const __grid_constant__ CUtensorMap tdo,
                                    const float* __restrict__ lse2,
                                    const float* __restrict__ delta, bf16* __restrict__ dk,
                                    bf16* __restrict__ dv, Strides sdk, Strides sdv,
                                    float* __restrict__ partial, int chunk, int max_parts, int B,
                                    int H, int KV, int S, int S_pad, int dh, int window, float scale, float softcap) {
  constexpr int causal = CAUSAL;   // a template argument: no causal code where it is false
  constexpr int TILE = (D / 64) * kPanel;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ks = align1024(smem_raw);          // 1 tile
  unsigned char* vs = ks + TILE;                    // 1 tile
  unsigned char* qs = vs + TILE;                    // STAGES tiles
  unsigned char* dos = qs + STAGES * TILE;          // STAGES tiles
  float4* xs = reinterpret_cast<float4*>(dos + STAGES * TILE);   // the hand-over: 8 x 128
  float* ls = reinterpret_cast<float*>(xs + 8 * 128);            // STAGES x 64
  float* dls = ls + STAGES * kTileRows;                           // STAGES x 64
  uint64_t* bars = reinterpret_cast<uint64_t*>(dls + STAGES * kTileRows);
  uint64_t* full = bars;
  uint64_t* empty = bars + STAGES;
  uint64_t* kbar = bars + 2 * STAGES;
  uint64_t* xfull = bars + 2 * STAGES + 1;
  uint64_t* xempty = bars + 2 * STAGES + 2;

  const int kvh = causal ? blockIdx.x : blockIdx.y;
  const int b = causal ? blockIdx.y : blockIdx.z;
  const int G = H / KV;
  const KvWork w = kv_work(causal ? blockIdx.z : blockIdx.x, kTileRows, S, G, causal, window, chunk);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {   // before init_barriers' fence and __syncthreads
    mbar_init(xfull, 128);
    mbar_init(xempty, 128);
  }
  init_barriers(bars, STAGES, 8, 1);

  const bool loader = threadIdx.x == (OWN_LOADS ? 0 : 256);
  if (loader) {
    mbar_expect_tx(kbar, 2 * TILE);
    tma_tile<D>(ks, &tk, kbar, w.k0, kvh, b);
    tma_tile<D>(vs, &tv, kbar, w.k0, kvh, b);
    if (OWN_LOADS) {
      for (int i = 0; i < STAGES && i < w.n_steps; ++i)
        kv_load<D, STAGES>(w, i, &tq, &tdo, lse2, delta, qs, dos, ls, dls, full, b, H, kvh * G,
                           S_pad);
    } else {
      kv_produce<D, STAGES>(w, &tq, &tdo, lse2, delta, qs, dos, ls, dls, full, empty, b, H,
                            kvh * G, S_pad);
    }
  }
  if (warp >= 8) return;   // the producer warp
  const int wg = warpgroup();   // 0: S^T, P^T, dV; 1: dP^T, dS^T, dK

  const int c = lane % 4;
  const int key0 = w.k0 + 16 * (warp % 4) + lane / 4;   // this thread's keys: key0, key0 + 8
  float4* slot = xs + threadIdx.x % 128;
  // the product's A operand: K (S^T = K Q^T) or V (dP^T = V dO^T)
  const uint32_t a_addr = smem_u32(wg == 0 ? ks : vs);
  const float sl2 = scale * kLog2e;

  float acc[D / 2];   // dV (first warpgroup) or dK (second)
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float x[32];        // S^T then P^T, or dP^T then dS^T
  uint32_t xa[4][4];  // the same in bf16: the A operand of dV += P^T dO or dK += dS^T Q

  mbar_wait(kbar, 0);
  for (int i = 0; i < w.n_steps; ++i) {
    const int st = i % STAGES;
    const int qq = (w.qt_lo + (w.s0 + i) % w.n_qt) * kTileRows;
    const uint32_t q_addr = smem_u32(qs + st * TILE), do_addr = smem_u32(dos + st * TILE);
    mbar_wait(&full[st], (i / STAGES) & 1);
    __syncwarp();
    group_ss<D>(x, a_addr, wg == 0 ? q_addr : do_addr);
    if (OWN_LOADS && loader && i >= 1 && i - 1 + STAGES < w.n_steps) {
      // step i - 1's stage, once every warp has released it, takes step
      // i - 1 + STAGES
      mbar_wait(&empty[(i - 1) % STAGES], ((i - 1) / STAGES) & 1);
      kv_load<D, STAGES>(w, i - 1 + STAGES, &tq, &tdo, lse2, delta, qs, dos, ls, dls, full, b,
                         H, kvh * G, S_pad);
    }
    __syncwarp();
    wg_wait_all();
    pin(x);
    if (wg == 0) {
      if (i > 0) mbar_wait(xempty, (i - 1) & 1);   // the last hand-over has been read
      pair_p(x, slot, ls + st * kTileRows, qq, key0, w.k0, c, causal, window, sl2, scale,
             softcap);
      mbar_arrive(xfull);
    } else {
      mbar_wait(xfull, i & 1);
      pair_ds(x, slot, dls + st * kTileRows, c);
      mbar_arrive(xempty);
    }
    frags(xa, x);
    group_rs(acc, xa, wg == 0 ? do_addr : q_addr);
    wg_wait_all();
    pin(acc);
    pin(xa);
    release(&empty[st], lane);
  }

  const long long plane = (long long)B * KV * S * dh;
  float* pk = partial + ((long long)w.part * B + b) * KV * S * dh + (long long)kvh * S * dh;
  if (wg == 0)
    kv_store(acc, dv, sdv, pk + max_parts * plane, w.parts == 1, b, kvh, key0, c, S, dh, 1.f);
  else
    kv_store(acc, dk, sdk, pk, w.parts == 1, b, kvh, key0, c, S, dh, scale);
}

// dK (times scale) and dV in bf16 from the fp32 partials of the key blocks
// cut into more than one part (the others were written whole), summed in
// part order: one thread per pair of columns.
__global__ void flash_bwd_dkv_sum_kernel(const float* __restrict__ partial, bf16* __restrict__ dk,
                                         bf16* __restrict__ dv, Strides sdk, Strides sdv,
                                         int chunk, int max_parts, int bn, int B, int H, int KV,
                                         int S, int dh, int causal, int window, float scale) {
  const long long n = (long long)B * KV * S * dh;
  const long long e = 2 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  if (e >= n) return;
  const int col = (int)(e % dh);
  const long long row = e / dh;
  const int s = (int)(row % S);
  int qt_lo, n_qt;
  const int parts =
      kv_parts(kv_steps(s / bn * bn, bn, S, H / KV, causal, window, &qt_lo, &n_qt), chunk);
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
// A thread gets at most 16K registers / (32 x the block's warps on one of
// the SM's four partitions): 168 for 9-12 warps, 255 for up to 8.  At
// D = 256 a tile is 32 KB and O, dQ, dK, dV 128 registers a thread: the
// forward with two consumer warpgroups (168) spilled 1 KB a thread and
// ptxas serialized its wgmmas, so it runs one (255; PaliGemma's forward
// 0.0665 -> 0.0533 ms); dQ runs one too (Q, dO and a two-stage K/V ring for
// two would need 256 KB).  dK/dV runs the pair kernel from D = 128 (PAIR:
// one key tile a block, dV and dK in two warpgroups): at 128 the kernel
// that holds both in one warpgroup spills 1.2 KB a thread and took 0.2365
// ms of the trainer's backward against the pair's 0.1656; at 256 the pair
// drops its producer warp (OWN_LOADS: 0.27 -> 0.17 ms for PaliGemma's
// backward).
template <int D>
struct Fwd {
  static constexpr int NWG = D <= 64 ? 3 : D <= 128 ? 2 : 1;
  static constexpr int STAGES = D <= 64 ? 4 : D <= 128 ? 3 : 2;
};
template <int D>
struct Dq {
  static constexpr int NWG = D <= 128 ? 2 : 1, STAGES = D <= 64 ? 3 : 2;
};
template <int D>
struct Dkv {
  static constexpr bool PAIR = D >= 128;
  static constexpr bool OWN_LOADS = D >= 256;   // the pair without a producer warp
  static constexpr int NWG = 2, STAGES = D <= 64 ? 4 : 2;
  static constexpr int KEYS = PAIR ? kTileRows : kTileRows * NWG;   // keys a block
};

inline int pad_rows(int S) { return (S + kTileRows - 1) / kTileRows * kTileRows; }

// How the dK/dV grid cuts its work: `chunk`, the most steps a block takes
// (an even share of all steps over the SMs, one block each, or a whole key
// block's where that is more: a part's fixed cost, K and V loaded and fp32
// partials written and summed, asks for parts of several steps); `blocks`,
// every key block's parts together (the grid's work dimension); `max_parts`, the most parts of one key block
// (1: no partials).  Under causality the first key block has the most
// steps and the most parts.
struct KvPlan {
  int chunk, blocks, max_parts;
};

template <int D>
KvPlan kv_plan(int B, int H, int KV, int S, int causal, int window) {
  constexpr int BN = Dkv<D>::KEYS;
  const int G = H / KV;
  long long total = 0;
  int most = 1, lo, n;
  for (int k0 = 0; k0 < S; k0 += BN) {
    const int steps = kv_steps(k0, BN, S, G, causal, window, &lo, &n);
    total += steps;
    most = steps > most ? steps : most;
  }
  const long long want = sm_count();
  long long chunk = (total * KV * B + want - 1) / want;
  chunk = chunk < 1 ? 1 : (chunk > most ? most : chunk);
  KvPlan plan{(int)chunk, 0, kv_parts(most, (int)chunk)};
  for (int k0 = 0; k0 < S; k0 += BN)
    plan.blocks += kv_parts(kv_steps(k0, BN, S, G, causal, window, &lo, &n), plan.chunk);
  return plan;
}

inline KvPlan kv_plan_of(int B, int H, int KV, int S, int dh, int causal, int window) {
  return dh <= 64    ? kv_plan<64>(B, H, KV, S, causal, window)
         : dh <= 128 ? kv_plan<128>(B, H, KV, S, causal, window)
                     : kv_plan<256>(B, H, KV, S, causal, window);
}

// floats of the backward's workspace: lse2 and delta, (B, H, S_pad) each,
// then the dK and dV partials when a key block is cut into parts.
inline long long workspace_floats(int B, int H, int KV, int S, int dh, int causal, int window) {
  const long long rows = 2LL * B * H * pad_rows(S);
  const int parts = kv_plan_of(B, H, KV, S, dh, causal, window).max_parts;
  return rows + (parts > 1 ? 2LL * parts * B * KV * S * dh : 0);
}

}  // namespace sm90
