// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ray_tpu/ops/flash_attention.py
// `_flash_fwd_kernel` (:40, launched by `_flash_fwd` at :117). Same
// function: the flash-attention-2 forward with GQA (query head h reads KV
// head h / (H / Hkv)), causal masking in global coordinates (query i sits
// at q_offset + i, key j at kv_offset + j), and the per-row logsumexp (the
// natural log, [B*H, Sq] float32) the backward and ring attention need. A
// fully masked row gives O = 0 and lse = -1e30 (the Pallas kernel's
// l == 0 guard).
//
// Layout: q [B, Sq, H, D], k/v [B, Skv, Hkv, D], read through their batch,
// sequence and head strides (the last dimension is contiguous), so the
// wrapper never copies into the TPU kernel's [B*H, S, D] head-major form.
// o has q's layout; lse is [B*H, Sq] float32.
//
// What bounds it on the H100: causal attention over S keys does about
// S/2 flops per byte of Q/K/V/O it must move (bf16, D = 128, GQA 4:1):
// about 205 at S = 512, under the card's ~295 flops/byte, so up to S ~ 750
// (the 8B prefill buckets, 128..512) the least time is set by bytes, and
// above it (the training length, 2048) by operations. Either way the score
// matrix must never reach device memory, which would multiply the bytes by
// ~S/D: every intermediate stays on chip (online softmax), and causal key
// tiles past a block's last query are never loaded.
//
// Two kernels compute this, chosen from the inputs at each launch:
// - bf16 with D a multiple of 16 up to 128, 16-byte-aligned rows and
//   output strides a multiple of 8 (the 8B model's prefill and training
//   forward): `flash_fwd_wgmma_kernel` below, designed for Hopper. What
//   holds a tensor-core forward back, and what it does about each:
//   1. Nothing in flight while the tensor cores work. One producer warp
//      copies K and V tiles (64 keys) with TMA into a ring of kStages = 4
//      stages, each with a `full` and an `empty` mbarrier, up to 4 tiles
//      ahead of the consumers; TMA zero-fills ragged rows and columns past
//      D and computes the swizzled addresses itself, so the consumer
//      warpgroups issue no copies and pass no block-wide barrier after the
//      start. (A first version had the consumers copy with cp.async behind
//      one __syncthreads a tile; the copies' issue and the barrier cost it
//      more than the loads' latency did: deeper rings gained nothing.)
//   2. Products fed 32 bits at a time, V read with 16-bit loads, every warp
//      rereading whole tiles. Both products are wgmma on two consumer
//      warpgroups (64 query rows each): S = Q K^T is SS m64n64k16 with both
//      operands K-major in 128-byte-swizzled shared memory (Q resident, K
//      streamed); O += P V is RS m64nDk16 with P handed from S's
//      accumulators to the register A operand (wgmma.cuh: a_fragment) and V
//      read MN-major, the form the backward's dQ += dS K uses. The softmax
//      of tile j runs while the tensor cores add tile j-1's P V
//      (flash-attention-3's intra-warpgroup overlap): S_j and P_{j-1} V_{j-1}
//      are two commit groups, waited for one after the other. Measured
//      slower on the card and left out: 128-key tiles (3 stages fit),
//      issuing S_{j+1} before tile j's softmax (a second S tile of
//      registers; it spilled), and warpgroups taking turns at the tensor
//      cores through named barriers (flash-attention-3's ping-pong).
//   3. A mask and a branch on every entry. The softmax runs in the log2
//      domain: one FMA per entry (s * scale * log2(e) - max) and ex2.approx.
//      The mask writes -inf into the score, in a loop that only tiles
//      crossing the causal diagonal or the ragged key edge run; a row whose
//      running max is still -inf takes 0 as its max, so exp2(-inf - 0) = 0
//      and no NaN reaches a live row of the same tile.
//   4. The longest blocks started last. The grid is (B*H, query tiles) with
//      the last query tile, the longest causal chain (32 key tiles of 64
//      keys at S = 2048 against 2 for the first), dispatched first.
//   Tiles by the register budget (288 threads: at most 224 registers a
//   thread): a consumer thread holds 64 O floats (D = 128), 32 S floats and
//   two P fragments of 16 registers (the one in flight and the next); one
//   block an SM. Shared memory: the 128-row Q tile (32 KB), 4 stages of
//   64-row K and V tiles (128 KB) and 9 barriers, 164,936 bytes at D = 128.
//   At S = 512 (B = 1, H = 32) the grid is 128 blocks, under one wave of
//   132 SMs, and needs no smaller query tile: 64-row blocks would make 256
//   blocks of 145 KB that cannot share an SM, two waves whose last block
//   walks the same 8 key tiles as the longest 128-row block does now.
// - everything else, float32 included (its parity checks must not see
//   bf16 or TF32 rounding): `flash_fwd_kernel`, scalar float FMAs on the
//   CUDA cores, each thread owning a 4 x 8 tile of scores and a 4 x Dmax/8
//   tile of the output. Shared memory: float Q and K tiles [64][Dmax+1],
//   a V tile [64][Dmax] and a [64][65] probability tile, 115,456 bytes at
//   Dmax = 128 and 213,760 at Dmax = 256. It takes tiles in as 16-byte
//   loads, a batch per thread issued before any is stored, when strides and
//   D allow it (else one element at a time).
// Above 48 KB of shared memory a launch needs the dynamic-shared-memory
// attribute, which the entry point sets before every launch.

#include <cuda.h>
#include <cudaTypedefs.h>

#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

using rtt::from_float;
using rtt::kNegInf;
using rtt::to_float;

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kTile = 64;      // rows of a Q or K/V tile
constexpr int kThreads = 128;  // 16 row groups of 4 rows x 8 column lanes
static_assert(kBlockQ == kTile && kBlockK == kTile, "one tile loader");

constexpr size_t flash_smem_bytes(int dmax) {
  return sizeof(float) * (size_t(kBlockQ) * (dmax + 1) +     // q_s
                          size_t(kBlockK) * (dmax + 1) +     // k_s
                          size_t(kBlockK) * dmax +           // v_s
                          size_t(kBlockQ) * (kBlockK + 1));  // p_s
}

template <typename T, int DMAX, bool VEC>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int Hkv, int Sq, int Skv,
                 int D, int64_t q_sb, int64_t q_ss, int64_t q_sh,
                 int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
                 int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_ss,
                 int64_t o_sh, float scale, int causal, int q_offset,
                 int kv_offset) {
  constexpr int QS = DMAX + 1;  // padded row pitch: no bank conflicts
  constexpr int PS = kBlockK + 1;
  constexpr int NC = DMAX / 8;  // output columns per thread

  extern __shared__ float4 rtt_smem[];
  float* q_s = reinterpret_cast<float*>(rtt_smem);
  float* k_s = q_s + kBlockQ * QS;
  float* v_s = k_s + kBlockK * QS;
  float* p_s = v_s + kBlockK * DMAX;

  const int tid = threadIdx.x;
  const int ty = tid >> 3;  // rows ty*4 .. ty*4+3 of the tile
  const int tx = tid & 7;   // columns tx, tx+8, tx+16, ...
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * kBlockQ;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;

  // Q tile, pre-scaled as the Pallas kernel does; zero past Sq and D.
  rtt::load_tile<T, kTile, DMAX, kThreads, VEC>(
      qb + q0 * q_ss, q_ss, min(kBlockQ, Sq - q0), D, scale, q_s, QS);

  // Causal loop bound: key tiles starting after this tile's last query
  // position are fully masked and never loaded.
  const int nk = (Skv + kBlockK - 1) / kBlockK;
  int hi = nk;
  if (causal) {
    const int last_q = q_offset + min(q0 + kBlockQ, Sq) - 1;
    const int reach = last_q - kv_offset;  // last key index it can see
    hi = reach < 0 ? 0 : min(nk, reach / kBlockK + 1);
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int j = 0; j < hi; ++j) {
    const int k0 = j * kBlockK;
    __syncthreads();  // the previous tile's readers are done
    const int rows = min(kBlockK, Skv - k0);
    rtt::load_tile<T, kTile, DMAX, kThreads, VEC>(kb + k0 * k_ss, k_ss, rows,
                                                   D, 1.f, k_s, QS);
    rtt::load_tile<T, kTile, DMAX, kThreads, VEC>(vb + k0 * v_ss, v_ss, rows,
                                                   D, 1.f, v_s, DMAX);
    __syncthreads();

    // S = (Q * scale) K^T for this thread's 4 x 8 scores.
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) s[i][c] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty * 4 + i) * QS + d];
#pragma unroll
      for (int c = 0; c < 8; ++c) kv[c] = k_s[(tx + 8 * c) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }

    // Online softmax. The 8 lanes sharing a row are consecutive lanes of
    // one warp, so the row max and sum are shuffles among them. Masked
    // entries contribute nothing (p = 0).
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_offset + q0 + ty * 4 + i;
      bool ok[8];
      float mx = m[i];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = k0 + tx + 8 * c;
        ok[c] = col < Skv && (!causal || kv_offset + col <= qpos);
        if (ok[c]) mx = fmaxf(mx, s[i][c]);
      }
      mx = rtt::group_max(mx, 8);
      const float alpha = expf(m[i] - mx);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float p = ok[c] ? expf(s[i][c] - mx) : 0.f;
        p_s[(ty * 4 + i) * PS + tx + 8 * c] = p;
        rs += p;
      }
      rs = rtt::group_sum(rs, 8);
      l[i] = l[i] * alpha + rs;
      m[i] = mx;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += P V for this thread's 4 x (Dmax / 8) outputs.
    for (int kk = 0; kk < rows; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty * 4 + i) * PS + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = v_s[kk * DMAX + tx + 8 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

  T* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    const float inv = 1.f / l_safe;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 8 * c;
      if (d < D) ob[row * o_ss + d] = from_float<T>(acc[i][c] * inv);
    }
    if (tx == 0) lse[int64_t(bh) * Sq + row] = m[i] + logf(l_safe);
  }
}

// ---- bf16 on Hopper's tensor cores: wgmma ------------------------------
//
// A block owns 128 query rows of one (batch, head), 64 a consumer
// warpgroup, and has one producer warp. The producer's first lane copies
// the Q tile and then K/V tile after K/V tile with TMA into a ring of
// kStages stages; each stage has a `full` barrier (the tile has landed)
// and an `empty` barrier (both consumer warpgroups are done with it), so
// the producer runs up to kStages tiles ahead and the two consumer
// warpgroups drift apart freely: no barrier of the whole block after the
// start. Step j of a consumer warpgroup (j = 0 .. steps, one past the
// block's last key tile):
//   wait for tile j (full); S_j = Q K_j^T (commit), O += P_{j-1} V_{j-1}
//   (commit); wait for S_j, softmax it into P_j (registers) while
//   P_{j-1} V_{j-1} runs; wait for that, rescale O by exp2(m_{j-1} - m_j);
//   release tile j - 1 (empty).
// A warpgroup whose rows see fewer key tiles than the block (the first one
// on the causal diagonal) stops computing after its own last tile, adding
// that tile's P V in its next step, and releases the tiles it skips.
// TMA zero-fills rows past the tensor and columns past D.

namespace sm90 = rtt::sm90;

constexpr int kWarpgroups = 2;
constexpr int kConsumers = 128 * kWarpgroups;
constexpr int kFwdThreads = kConsumers + 32;  // and the producer warp
constexpr int kBlockRows = 64 * kWarpgroups;  // query rows a block owns
constexpr int kKeyRows = 64;                  // keys a K/V tile (S m64n64)
constexpr int kStages = 4;                    // K/V tiles in the ring
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared memory: 1,024 bytes of alignment slack, the Q tile, per stage a K
// and a V tile, and the barriers (Q, then full and empty per stage).
// 164,936 bytes at D = 128.
template <int DMAX>
constexpr size_t wgmma_smem_bytes() {
  return 1024 + size_t(sm90::SwTile<kBlockRows, DMAX>::kBytes) +
         kStages * 2 * size_t(sm90::SwTile<kKeyRows, DMAX>::kBytes) +
         8 * (1 + 2 * kStages);
}

// Key tiles [0, n) that the query rows before `q_end` see.
__device__ __forceinline__ int key_tiles_before(int q_end, int Skv,
                                                int causal, int q_offset,
                                                int kv_offset) {
  const int nk = (Skv + kKeyRows - 1) / kKeyRows;
  if (!causal) return nk;
  const int reach = q_offset + q_end - 1 - kv_offset;  // last key it sees
  return reach < 0 ? 0 : min(nk, reach / kKeyRows + 1);
}

// Registers the compiler may not move across this point (the P fragment in
// flight as wgmma's A operand until its wait).
template <int N>
__device__ __forceinline__ void fence_fragments(uint32_t (&p)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(p[i][e])::"memory");
}

// The tensor maps of q [B, Sq, H, D], k and v [B, Skv, Hkv, D]: 4-d,
// innermost first (d, head, row, batch), boxes of 64 columns (128 bytes,
// one swizzle span) by the tile's rows of one head, 128-byte swizzle.
struct FwdMaps {
  CUtensorMap q, k, v;
};

template <int DMAX>
__global__ void __launch_bounds__(kFwdThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ FwdMaps maps,
                       __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                       int H, int Hkv, int Sq, int Skv, int D, int64_t o_sb,
                       int64_t o_ss, int64_t o_sh, float scale, int causal,
                       int q_offset, int kv_offset) {
  constexpr int QT = sm90::SwTile<kBlockRows, DMAX>::kBytes;
  constexpr int KT = sm90::SwTile<kKeyRows, DMAX>::kBytes;
  constexpr int NK = DMAX / 16;      // k-steps of S over d
  constexpr int NS = kKeyRows / 16;  // k-steps of P V over a tile's keys
  constexpr int NO = DMAX / 2;       // O accumulator floats a thread
  constexpr int NSC = kKeyRows / 2;  // S accumulator floats a thread

  extern __shared__ float4 rtt_smem[];
  const uint32_t q_s = (sm90::smem_addr(rtt_smem) + 1023) & ~1023u;
  const uint32_t ring = q_s + QT;  // stage s: K at ring + 2 KT s, V next
  const uint32_t q_full = ring + kStages * 2 * KT;
  const uint32_t full = q_full + 8;            // [kStages]
  const uint32_t empty = full + 8 * kStages;   // [kStages]

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / (H / Hkv);
  // blockIdx.y counts query tiles from the last: longest chains first.
  const int q0 =
      ((Sq + kBlockRows - 1) / kBlockRows - 1 - int(blockIdx.y)) * kBlockRows;
  const int steps = key_tiles_before(min(q0 + kBlockRows, Sq), Skv, causal,
                                     q_offset, kv_offset);

  if (tid == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(full + 8 * s, 1);
      sm90::mbar_init(empty + 8 * s, kWarpgroups);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warp
    if (tid == kConsumers) {
      sm90::mbar_arrive_expect_tx(q_full, QT);
#pragma unroll
      for (int p = 0; p < DMAX / 64; ++p)
        sm90::tma_load_4d(q_s + p * (QT / (DMAX / 64)), &maps.q, q_full,
                          64 * p, h, q0, b);
      for (int i = 0; i < steps; ++i) {
        const int s = i % kStages;
        if (i >= kStages)
          sm90::mbar_wait(empty + 8 * s, ((i / kStages) - 1) & 1);
        const uint32_t k_st = ring + s * 2 * KT;
        sm90::mbar_arrive_expect_tx(full + 8 * s, 2 * KT);
#pragma unroll
        for (int p = 0; p < DMAX / 64; ++p) {
          sm90::tma_load_4d(k_st + p * (KT / (DMAX / 64)), &maps.k,
                            full + 8 * s, 64 * p, hk, i * kKeyRows, b);
          sm90::tma_load_4d(k_st + KT + p * (KT / (DMAX / 64)), &maps.v,
                            full + 8 * s, 64 * p, hk, i * kKeyRows, b);
        }
      }
    }
    return;
  }

  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  const int qw = q0 + 64 * wg;         // this warpgroup's first row
  const int row = qw + 16 * warp + g;  // this thread's rows: row, row + 8
  const int wg_steps =
      qw < Sq ? key_tiles_before(min(qw + 64, Sq), Skv, causal, q_offset,
                                 kv_offset)
              : 0;

  const float neg_inf = __int_as_float(0xff800000);
  const float scale_log2 = scale * kLog2e;
  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  // Per row (row, row + 8): the running max of the scaled scores in log2
  // units (-inf until a key is seen), and this thread's part of the running
  // sum (its 16 of each tile's 64 columns; the 4 lanes of a row add theirs
  // at the end).
  float m[2] = {neg_inf, neg_inf}, l[2] = {0.f, 0.f};
  uint32_t p_prev[NS][4], p_cur[NS][4];

  sm90::mbar_wait(q_full, 0);
  for (int j = 0; j <= steps; ++j) {
    if (j < steps) sm90::mbar_wait(full + 8 * (j % kStages), (j / kStages) & 1);
    const bool has_s = j < wg_steps;
    // Every step of both warpgroups takes its turn, with products or not,
    // so the turns pair up; the last turn of warpgroup 1 hands nothing on.
    if (has_s || (j > 0 && j <= wg_steps)) {  // warpgroup-uniform
      float s[NSC];
      sm90::fence_operand(acc);
      sm90::wgmma_fence();
      if (has_s) {  // S_j = Q K_j^T
        const uint32_t k_st = ring + (j % kStages) * 2 * KT;
#pragma unroll
        for (int kk = 0; kk < NK; ++kk)
          sm90::wgmma_ss_m64n64k16(
              s, sm90::desc_kmajor<kBlockRows>(q_s, 64 * wg, kk),
              sm90::desc_kmajor<kKeyRows>(k_st, 0, kk), kk > 0);
      }
      sm90::wgmma_commit();
      if (j > 0) {  // O += P_{j-1} V_{j-1}
        const uint32_t v_st =
            ring + ((j + kStages - 1) % kStages) * 2 * KT + KT;
#pragma unroll
        for (int kk = 0; kk < NS; ++kk)
          sm90::wgmma_rs<DMAX>(acc, p_prev[kk],
                               sm90::desc_mnmajor<kKeyRows>(v_st, kk), 1);
      }
      sm90::wgmma_commit();

      float alpha[2];
      if (has_s) {
        sm90::wgmma_wait<1>();  // S_j is in; P V may still run
        sm90::fence_operand(s);
        // Entry 4jj + 2hh + e: row `row + 8hh`, key k0 + 8jj + 2t + e.
        const int k0 = j * kKeyRows;
        if (!(k0 + kKeyRows <= Skv &&
              (!causal || kv_offset + k0 + kKeyRows - 1 <= q_offset + qw))) {
#pragma unroll
          for (int n = 0; n < NSC; ++n) {
            const int col = k0 + 8 * (n >> 2) + 2 * t + (n & 1);
            if (col >= Skv || (causal && kv_offset + col >
                                             q_offset + row + 8 * ((n >> 1) & 1)))
              s[n] = neg_inf;
          }
        }
        float mx[2] = {neg_inf, neg_inf}, mu[2];
#pragma unroll
        for (int n = 0; n < NSC; ++n)
          mx[(n >> 1) & 1] = fmaxf(mx[(n >> 1) & 1], s[n]);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float mnew =
              fmaxf(m[hh], rtt::group_max(mx[hh], 4) * scale_log2);
          mu[hh] = mnew == neg_inf ? 0.f : mnew;  // no -inf - -inf
          alpha[hh] = sm90::exp2_approx(m[hh] - mu[hh]);
          m[hh] = mnew;
        }
        float rs[2] = {0.f, 0.f};
#pragma unroll
        for (int n = 0; n < NSC; ++n) {
          const int hh = (n >> 1) & 1;
          s[n] = sm90::exp2_approx(fmaf(s[n], scale_log2, -mu[hh]));
          rs[hh] += s[n];
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * alpha[hh] + rs[hh];
#pragma unroll
        for (int kk = 0; kk < NS; ++kk) sm90::a_fragment(s, kk, p_cur[kk]);
      }
      sm90::wgmma_wait<0>();
      sm90::fence_operand(acc);
      fence_fragments(p_prev);
      if (has_s) {
#pragma unroll
        for (int n = 0; n < NO; ++n) acc[n] *= alpha[(n >> 1) & 1];
#pragma unroll
        for (int kk = 0; kk < NS; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) p_prev[kk][e] = p_cur[kk][e];
      }
    }
    // Tile j - 1 is done with: its P V ran in this step, or this
    // warpgroup's rows never reach it.
    if (j > 0 && (tid & 127) == 0)
      sm90::mbar_arrive(empty + 8 * ((j - 1) % kStages));
  }

  // Entry 4jj + 2hh + e of O: row `row + 8hh`, column 8jj + 2t + e; stored
  // as bf16 pairs.
  __nv_bfloat16* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float sum = rtt::group_sum(l[hh], 4);
    const int r = row + 8 * hh;
    if (r >= Sq) continue;
    const float inv = sum == 0.f ? 0.f : 1.f / sum;  // fully masked: O = 0
#pragma unroll
    for (int jj = 0; jj < DMAX / 8; ++jj) {
      const int d = 8 * jj + 2 * t;
      if (d < D)
        *reinterpret_cast<unsigned*>(ob + r * o_ss + d) = rtt::pack_bf16x2(
            acc[4 * jj + 2 * hh] * inv, acc[4 * jj + 2 * hh + 1] * inv);
    }
    if (t == 0)
      lse[int64_t(bh) * Sq + r] =
          sum == 0.f ? kNegInf : m[hh] * kLn2 + logf(sum);
  }
}

// cuTensorMapEncodeTiled from the driver, through the runtime (no link to
// libcuda); null if the driver has none.
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }();
  return fn;
}

// The map of a bf16 [B, S, heads, D] tensor with (batch, seq, head) strides
// in elements (multiples of 8) and boxes of 64 columns x `rows` rows.
bool encode_map(CUtensorMap* map, const void* base, int B, int S, int heads,
                int D, int64_t sb, int64_t ss, int64_t sh, int rows) {
  auto encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(heads), cuuint64_t(S),
                              cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(sh) * 2, cuuint64_t(ss) * 2,
                                 cuuint64_t(sb) * 2};
  const cuuint32_t box[4] = {64, 1, cuuint32_t(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DMAX>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* o, void* lse, int B, int H, int Hkv, int Sq,
                         int Skv, int D, const int64_t* st, float scale,
                         int causal, int q_offset, int kv_offset,
                         cudaStream_t stream) {
  FwdMaps maps;
  if (!encode_map(&maps.q, q, B, Sq, H, D, st[0], st[1], st[2], kBlockRows) ||
      !encode_map(&maps.k, k, B, Skv, Hkv, D, st[3], st[4], st[5],
                  kKeyRows) ||
      !encode_map(&maps.v, v, B, Skv, Hkv, D, st[6], st[7], st[8], kKeyRows))
    return cudaErrorInvalidValue;
  auto kernel = flash_fwd_wgmma_kernel<DMAX>;
  const size_t smem = wgmma_smem_bytes<DMAX>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  // The head on x and the query tile on y: blocks are dispatched tile by
  // tile, the longest causal chains first.
  dim3 grid(B * H, (Sq + kBlockRows - 1) / kBlockRows);
  kernel<<<grid, kFwdThreads, smem, stream>>>(
      maps, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), H, Hkv,
      Sq, Skv, D, st[9], st[10], st[11], scale, causal, q_offset, kv_offset);
  return cudaGetLastError();
}

template <typename T, int DMAX, bool VEC>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int H, int Hkv, int Sq, int Skv, int D,
                   const int64_t* st, float scale, int causal, int q_offset,
                   int kv_offset, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, DMAX, VEC>;
  const size_t smem = flash_smem_bytes(DMAX);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + kBlockQ - 1) / kBlockQ, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      H, Hkv, Sq, Skv, D, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], scale, causal, q_offset,
      kv_offset);
  return cudaGetLastError();
}

template <typename T, bool VEC>
cudaError_t launch_for_dim(const void* q, const void* k, const void* v,
                           void* o, void* lse, int B, int H, int Hkv, int Sq,
                           int Skv, int D, const int64_t* st, float scale,
                           int causal, int q_offset, int kv_offset,
                           cudaStream_t stream) {
  if (D <= 64)
    return launch<T, 64, VEC>(q, k, v, o, lse, B, H, Hkv, Sq, Skv, D, st,
                              scale, causal, q_offset, kv_offset, stream);
  if (D <= 128)
    return launch<T, 128, VEC>(q, k, v, o, lse, B, H, Hkv, Sq, Skv, D, st,
                               scale, causal, q_offset, kv_offset, stream);
  return launch<T, 256, VEC>(q, k, v, o, lse, B, H, Hkv, Sq, Skv, D, st,
                             scale, causal, q_offset, kv_offset, stream);
}

// Whether every row the kernel reads starts on a 16-byte boundary.
template <typename T>
bool vector_rows(const void* q, const void* k, const void* v, int D,
                 const int64_t* st) {
  constexpr int E = rtt::kVec<T>;
  bool ok = D % E == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(v) % 16 == 0;
  for (int i = 0; i < 9; ++i) ok = ok && st[i] % E == 0;
  return ok;
}

template <typename T>
cudaError_t launch_for_type(const void* q, const void* k, const void* v,
                            void* o, void* lse, int B, int H, int Hkv, int Sq,
                            int Skv, int D, const int64_t* st, float scale,
                            int causal, int q_offset, int kv_offset,
                            cudaStream_t stream) {
  // bf16 with aligned rows and D a multiple of 16 up to 128 (the 8B model's
  // shape) runs on the tensor cores (wgmma); everything else on the CUDA
  // cores.
  if (std::is_same<T, __nv_bfloat16>::value && D % 16 == 0 && D <= 128 &&
      vector_rows<T>(q, k, v, D, st) &&
      reinterpret_cast<uintptr_t>(o) % 16 == 0 && st[9] % 8 == 0 &&
      st[10] % 8 == 0 && st[11] % 8 == 0) {
    if (D <= 64)
      return launch_wgmma<64>(q, k, v, o, lse, B, H, Hkv, Sq, Skv, D, st,
                              scale, causal, q_offset, kv_offset, stream);
    return launch_wgmma<128>(q, k, v, o, lse, B, H, Hkv, Sq, Skv, D, st,
                             scale, causal, q_offset, kv_offset, stream);
  }
  if (vector_rows<T>(q, k, v, D, st))
    return launch_for_dim<T, true>(q, k, v, o, lse, B, H, Hkv, Sq, Skv, D, st,
                                   scale, causal, q_offset, kv_offset, stream);
  return launch_for_dim<T, false>(q, k, v, o, lse, B, H, Hkv, Sq, Skv, D, st,
                                  scale, causal, q_offset, kv_offset, stream);
}

}  // namespace

// strides: 12 int64 values, (batch, seq, head) strides in elements of
// q, k, v and o in that order. Returns a cudaError_t (0 on success).
extern "C" int rtt_flash_fwd(int dtype, const void* q, const void* k,
                             const void* v, void* o, void* lse, int B, int H,
                             int Hkv, int Sq, int Skv, int D,
                             const void* strides, float scale, int causal,
                             int q_offset, int kv_offset, void* stream) {
  if (D < 1 || D > 256 || Hkv < 1 || H % Hkv != 0 || B * H > 65535)
    return int(cudaErrorInvalidValue);
  const int64_t* st = static_cast<const int64_t*>(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rtt::kFloat32)
    return int(launch_for_type<float>(q, k, v, o, lse, B, H, Hkv, Sq, Skv,
                                      D, st, scale, causal, q_offset,
                                      kv_offset, s));
  if (dtype == rtt::kBFloat16)
    return int(launch_for_type<__nv_bfloat16>(q, k, v, o, lse, B, H, Hkv,
                                              Sq, Skv, D, st, scale, causal,
                                              q_offset, kv_offset, s));
  return int(cudaErrorInvalidValue);
}
