// Hopper building blocks of the port's redesigned kernels (sm_90a only):
// asynchronous tile copies into shared memory laid out for wgmma, wgmma
// matrix descriptors, and the warpgroup matrix-multiply instructions the
// flash-attention forward and backward use (paged decode takes its
// cp.async copies from here too). The scalar kernels take their helpers
// from common.cuh.
//
// Shared-memory tiles. A bf16 tile of ROWS rows x DMAX columns (DMAX 64 or
// 128) is stored as DMAX / 64 panels of ROWS rows x 64 columns, 128 bytes a
// row, with the 128-byte swizzle that wgmma's descriptors name (layout type
// 1): 16-byte chunk c of row r of a panel sits at chunk c ^ (r % 8) of that
// row. Eight rows make one 1,024-byte swizzle atom, and every tile starts on
// a 1,024-byte boundary, so the swizzle the hardware applies to an address
// (its bits 4-6 XOR its bits 7-9) is the one the copy wrote.
//
// One tile serves as an operand in two ways:
// - K-major (the reduction runs along a row: A = K or Q in S = Q K^T, and
//   B = Q or K read as N rows): the 16 columns of k-step kk are 32 bytes
//   at (kk % 4) * 32 in panel kk / 4; 8-row groups are 1,024 bytes apart
//   (the descriptor's stride byte offset, SBO); the leading byte offset is
//   unused because a k-step never leaves its 128-byte row.
// - MN-major (B of dV += P^T dO, dK += dS^T Q, dQ += dS K: the reduction
//   runs down the tile's rows, N along them): k-step kk is rows 16kk ..
//   16kk + 15, at kk * 2,048 bytes; SBO = 1,024 bytes between 8-row groups
//   along K, and the leading byte offset (LBO) = one panel (ROWS * 128
//   bytes) between the 64-column halves along N.
//
// Register fragments. The accumulator of wgmma m64nNk16 (f32) gives the
// thread (warp w of its warpgroup, g = lane / 4, t = lane % 4) the floats
// d[4j + 2h + e] = D[16w + g + 8h][8j + 2t + e], j < N / 8: the mma.sync
// m16n8 layout repeated along N. The register A operand of wgmma is the
// mma.sync m16n8k16 A fragment of the warp's 16 rows, so the accumulators
// of columns 16kk .. 16kk + 15, packed to bf16 in pairs (d[8kk + 0..7]),
// are the A fragment of k-step kk: a score tile feeds the next product
// without a trip through shared memory.
#pragma once

#include "common.cuh"

namespace rtt {
namespace sm90 {

// The shared-window address of a pointer into shared memory.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 bytes (4 bytes) into shared memory; the bytes past
// `src_bytes` (0 or the full size) are written as zeros, so a ragged tile
// edge or a column past D reads as 0 and never as stale shared memory.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Makes this thread's writes to shared memory visible to wgmma's operand
// reads (the async proxy); then a barrier hands them to the other threads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- mbarriers and TMA ---------------------------------------------------
//
// An mbarrier (8 bytes of shared memory) completes a phase when its
// expected arrivals have arrived and the bytes a TMA copy announced
// (expect_tx) have landed; waiters name the phase by its parity.

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
// Makes initialised barriers visible to the async proxy (TMA) and the other
// threads; a barrier of the block follows.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// Arrives and announces `bytes` of TMA copies that complete on `bar`.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
// Waits for the phase of parity `parity` to complete. A wait of more than
// about two seconds traps (a launch error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (4ll << 30)) __trap();
}

// TMA: the box at coordinates (c0, c1, c2, c3), innermost first, of the
// tensor map at generic address `map` into shared memory at `dst`,
// completing on barrier `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

template <int ROWS, int DMAX>
struct SwTile {
  static_assert(DMAX == 64 || DMAX == 128, "64-column panels");
  static_assert(ROWS % 8 == 0, "whole swizzle atoms");
  static constexpr int kPanelBytes = ROWS * 128;
  static constexpr int kBytes = kPanelBytes * (DMAX / 64);
};

// Starts the copy of rows [0, rows) and columns [0, D) of a bf16 tile
// (row stride `stride` elements, rows 16-byte aligned, D a multiple of 8)
// into the swizzled tile at shared address `dst`; the rest of the tile is
// zero-filled. Thread `tid` of THREADS starts ROWS * DMAX / 8 / THREADS
// 16-byte copies, neighbouring threads on neighbouring chunks of a row.
template <int ROWS, int DMAX, int THREADS>
__device__ __forceinline__ void cp_async_tile(
    const __nv_bfloat16* __restrict__ src, int64_t stride, int rows, int D,
    uint32_t dst, int tid) {
  constexpr int CPR = DMAX / 8;  // 16-byte chunks per row
  static_assert(ROWS * CPR % THREADS == 0, "whole copies per thread");
#pragma unroll
  for (int u = 0; u < ROWS * CPR / THREADS; ++u) {
    const int i = u * THREADS + tid;
    const int r = i / CPR;
    const int c = i % CPR;
    const bool in = r < rows && c * 8 < D;
    const uint32_t off = (c >> 3) * SwTile<ROWS, DMAX>::kPanelBytes +
                         r * 128 + (((c & 7) ^ (r & 7)) << 4);
    cp_async16(dst + off, in ? src + r * stride + c * 8 : src, in ? 16 : 0);
  }
}

// A wgmma matrix descriptor: start address, leading and stride byte
// offsets (all in 16-byte units), 128-byte swizzle.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32) | (uint64_t(1) << 62);
}

// K-major operand: rows row0 .. row0 + 63 (A) or the N rows from row0 (B)
// of a ROWS-row tile at `tile`, columns 16kk .. 16kk + 15.
template <int ROWS>
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int row0,
                                                int kk) {
  return make_desc(tile + (kk >> 2) * (ROWS * 128) + row0 * 128 +
                       (kk & 3) * 32,
                   16, 1024);
}

// MN-major B operand: K = rows 16kk .. 16kk + 15 of a ROWS-row tile at
// `tile`, N = its columns.
template <int ROWS>
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int kk) {
  return make_desc(tile + kk * 2048, ROWS * 128, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins accumulator registers in place around asynchronous wgmma: the
// compiler may not move their reads or writes across this point.
template <int N>
__device__ __forceinline__ void fence_operand(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// 2^x by the SFU's approximation (flushing denormals to 0), as flash
// attention kernels take the softmax exponent: one instruction, where
// exp2f spends several on denormal inputs.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Two floats rounded to bf16 (to nearest even) in one register, the lower
// index in the low half: one cvt.rn.bf16x2.f32.
__device__ __forceinline__ uint32_t pack_bf16x2_rn(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The register A fragment of k-step kk from a 64 x N accumulator (see the
// note at the top): columns 16kk .. 16kk + 15 packed to bf16.
template <int N>
__device__ __forceinline__ void a_fragment(const float (&d)[N], int kk,
                                           uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    a[i] = pack_bf16x2_rn(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
}

// D (64 x 64, float) = A B (+ D if acc): A and B both read from shared memory
// through descriptors, both K-major (trans 0).
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(acc));
}

// D (64 x 64, float) = A B (+ D if acc): A from registers (the mma.sync m16n8k16 A
// fragment of each warp's 16 rows), B from shared memory, MN-major (trans 1).
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t desc_b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(acc));
}

// D (64 x 128, float) = A B (+ D if acc): A from registers (the mma.sync m16n8k16 A
// fragment of each warp's 16 rows), B from shared memory, MN-major (trans 1).
__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[64],
                                                   const uint32_t (&a)[4],
                                                   uint64_t desc_b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(acc));
}

// D (64 x N) = A B (+ D if acc), A from registers, B MN-major, N = DMAX.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b, int acc) {
  if constexpr (N == 64)
    wgmma_rs_m64n64k16(d, a, desc_b, acc);
  else
    wgmma_rs_m64n128k16(d, a, desc_b, acc);
}

}  // namespace sm90
}  // namespace rtt
