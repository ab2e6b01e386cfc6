// Flash-attention backward for Hopper (sm_90a): dQ, and dK/dV.
//
// Replaces the Pallas TPU kernels of ray_tpu/ops/flash_attention.py:
// `_flash_bwd_dq_kernel` (:144, launched by `_flash_bwd` at :272, dQ) and
// `_flash_bwd_dkv_kernel` (:187), which `_flash_bwd` launches on two grids:
// the KV-head grid (:305), where a block sums the GQA group's `rep` query
// heads in its float accumulator, and the per-query-head grid (:344), whose
// group sum runs outside the kernel. Same function: with P = exp(S - lse) recomputed from
// the forward's per-row logsumexp (S = Q K^T * scale, masked entries 0),
// dP = dO V^T and dS = P * (dP - delta) where delta = rowsum(dO * O),
//   dQ = dS K * scale,  dK = dS^T Q * scale,  dV = P^T dO,
// with GQA (query head h reads KV head h / (H / Hkv)) and causal masking in
// global coordinates (query i at q_offset + i, key j at kv_offset + j).
//
// Layout: q/do/dq [B, Sq, H, D], k/v/dk/dv [B, Skv, Hkv, D], all read and
// written through their batch, sequence and head strides (the last
// dimension contiguous); lse and delta [B*H, Sq] float32. The per-head
// dK/dV mode writes float32 [B, Skv, H, D], which the wrapper sums over
// each group.
//
// What bounds it on the H100: dQ does three products per causal
// (query, key) pair and dK/dV four, 2 * D flops each, on inputs of
// (Sq + 2 Skv) * H * D elements, so at the 8B training shape (B = 1,
// S = 2048, H = 32, D = 128, bf16) both are bound by operations (~1,000
// flops per byte moved): 0.052 ms (dQ) and 0.070 ms (dK/dV) at 989 TFLOP/s.
// The score and probability tiles must never reach device memory (S^2 per
// head); every block recomputes its tiles on chip, and the two kernels
// never write the same output, so there are no atomics and the sums are
// deterministic. (Fusing dQ into dK/dV with float atomics, as
// flash-attention-2/3 do, would trade that away.)
//
// Two versions of each, chosen from the inputs at each launch:
// - bf16 with D a multiple of 16 up to 128, 16-byte-aligned rows and even
//   output strides (the 8B model's shape): the wgmma kernels below, for
//   Hopper. What holds a tensor-core kernel back here, and what they do:
//   1. The longest block chain. A causal dK/dV block of key tile 0 walks
//      every query tile of every head it sums (rep x Sq/64 steps on the
//      KV-head grid); the grid ends with its longest block. The kernel
//      dispatches key tile 0 first (the tile is blockIdx.y, the head x),
//      and the wrapper picks the KV-head or per-query-head grid by the
//      larger of the longest chain and the total steps over the resident
//      blocks (flash_attention.py: dkv_grid_estimates).
//   2. Nothing in flight while the tensor cores work. Streamed tiles (Q,
//      dO, lse, delta for dK/dV; K, V for dQ) go through a ring of
//      kStages = 2 stages filled by cp.async, the next tile's copy running
//      under this tile's products (a third stage measured no faster and
//      costs registers to its addressing). cp.async and not TMA: it zero-fills ragged rows, columns
//      past D and lse/delta rows one thread at a time, needs no tensor map
//      (no cuTensorMapEncodeTiled from libcuda, and lse/delta rows of Sq
//      floats need not sit on the 16 bytes TMA wants), and costs 8 copy
//      instructions a thread a step.
//   3. Fragment loads 32 bits at a time from shared memory, and two 16-bit
//      loads for a transposed operand. wgmma reads both shared operands
//      itself through descriptors, the transposed ones (dO, Q, K as B of
//      the accumulating products) as MN-major tiles of the same swizzled
//      layout: no fragment loads at all.
//   4. mma.sync m16n8k16 only. Every product is wgmma (m64n64k16 for the
//      scores, m64nDk16 for the accumulations), two consumer warpgroups a
//      block, P and dS handed from the accumulators to the next product
//      as its register A operand (flash-attention-3's layout).
//   Tiles by the register budget (255 a thread, 64K an SM): a block owns
//   128 rows (64 a warpgroup: 128 accumulator floats a thread for dK and
//   dV at D = 128) and streams 64 a step (64 score floats a thread).
//   Shared memory 133,120 bytes at D = 128 (of 227 KB), one block an SM.
// - everything else, float32 included (its parity checks must not see bf16
//   or TF32 rounding): scalar float FMAs on the CUDA cores with float tiles
//   [R][Dmax+1] in shared memory, R = 64 rows up to Dmax = 128 and 32 at
//   Dmax = 256, where four 64-row float tiles alone would exceed the 227 KB
//   a block may use. Shared memory: 148,736 bytes (dQ) and 165,888 (dK/dV)
//   at Dmax = 128.
// Above 48 KB of shared memory a launch needs the dynamic-shared-memory
// attribute, which the entry points set before every launch.

#include <initializer_list>
#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

using rtt::from_float;
using rtt::to_float;

constexpr int kThreads = 128;  // 16 row groups x 8 column lanes; 4 warps

struct Strides {
  int64_t b, s, h;  // batch, sequence and head strides, in elements
};

// Everything a backward launch reads. dk/dv are float32 [B, Skv, H, D] in
// the per-head mode and of the input dtype [B, Skv, Hkv, D] otherwise.
struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  Strides sq, sk, sv, sdo, sdq, sdk, sdv;
  int B, H, Hkv, Sq, Skv, D;
  float scale;
  int causal, q_offset, kv_offset, per_head;
};

// Tile rows of the scalar kernels (the wgmma kernels': kBlockRows,
// kStepRows). The wrapper's grid rule keeps a copy (flash_attention.py:
// bwd_tiles); a card test holds the two together through
// rtt_flash_bwd_tile_rows.
__host__ __device__ constexpr int tile_rows(int dmax) {
  return dmax <= 128 ? 64 : 32;
}

// Key tiles [0, hi) can be seen by a query tile starting at q0 (the
// forward's causal loop bound).
__device__ __forceinline__ int key_tiles_seen(const BwdArgs& a, int q0,
                                              int tile) {
  const int nk = (a.Skv + tile - 1) / tile;
  if (!a.causal) return nk;
  const int last_q = a.q_offset + min(q0 + tile, a.Sq) - 1;
  const int reach = last_q - a.kv_offset;  // last key index it can see
  return reach < 0 ? 0 : min(nk, reach / tile + 1);
}

// First query tile whose last row can see the key tile starting at k0.
__device__ __forceinline__ int first_query_tile(const BwdArgs& a, int k0,
                                                int tile) {
  const int nq = (a.Sq + tile - 1) / tile;
  if (!a.causal) return 0;
  const int d = a.kv_offset + k0 - a.q_offset;
  return d <= 0 ? 0 : min(nq, d / tile);
}

__device__ __forceinline__ bool visible(const BwdArgs& a, int row, int col) {
  return row < a.Sq && col < a.Skv &&
         (!a.causal || a.kv_offset + col <= a.q_offset + row);
}

// Query head h of batch b -> its KV head, and the query heads a dK/dV
// block covers: all `rep` of KV head `hk`, or just one in the per-head
// mode (blockIdx.y = b * H + h there, b * Hkv + hk otherwise).
struct HeadRange {
  int b, hk, h0, n;
};
__device__ __forceinline__ HeadRange heads_of(const BwdArgs& a, int y) {
  const int rep = a.H / a.Hkv;
  if (a.per_head) return {y / a.H, (y % a.H) / rep, y % a.H, 1};
  return {y / a.Hkv, y % a.Hkv, (y % a.Hkv) * rep, rep};
}
__device__ __forceinline__ HeadRange dkv_heads(const BwdArgs& a) {
  return heads_of(a, blockIdx.y);
}

// Writes one dK or dV value: float32 at query head h in the per-head mode,
// else the input dtype at KV head hk.
template <typename T>
__device__ __forceinline__ void store_dkv(const BwdArgs& a, void* out,
                                          const Strides& st, int b, int hk,
                                          int h, int row, int d, float x) {
  if (a.per_head)
    static_cast<float*>(out)[b * st.b + row * st.s + h * st.h + d] = x;
  else
    static_cast<T*>(out)[b * st.b + row * st.s + hk * st.h + d] =
        from_float<T>(x);
}

// ---- scalar float FMAs: every dtype and shape ---------------------------
//
// A thread owns RPT = R/16 rows x CPT = R/8 columns of the block's R x R
// score tile (rows ty*RPT + i, columns tx + 8c) and RPT rows x Dmax/8
// columns of its output accumulators (columns tx + 8c). Row pitch Dmax + 1
// keeps the 8 lanes that read 8 rows at one column on 8 banks.

template <int DMAX>
constexpr size_t dq_smem_bytes() {
  constexpr int R = tile_rows(DMAX);
  return sizeof(float) * (4 * size_t(R) * (DMAX + 1) + size_t(R) * (R + 1));
}

template <int DMAX>
constexpr size_t dkv_smem_bytes() {
  constexpr int R = tile_rows(DMAX);
  return sizeof(float) *
         (4 * size_t(R) * (DMAX + 1) + 2 * size_t(R) * (R + 1) + 2 * R);
}

template <typename T, int DMAX, bool VEC>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(BwdArgs a) {
  constexpr int R = tile_rows(DMAX);
  constexpr int P = DMAX + 1;  // float tile pitch
  constexpr int SP = R + 1;    // score tile pitch
  constexpr int RPT = R / 16, CPT = R / 8, NC = DMAX / 8;

  extern __shared__ float4 rtt_smem[];
  float* q_s = reinterpret_cast<float*>(rtt_smem);
  float* do_s = q_s + R * P;
  float* k_s = do_s + R * P;
  float* v_s = k_s + R * P;
  float* ds_s = v_s + R * P;  // [R query rows][R keys]

  const int tid = threadIdx.x;
  const int ty = tid >> 3;
  const int tx = tid & 7;
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int hk = h / (a.H / a.Hkv);
  const int q0 = blockIdx.x * R;
  const int D = a.D;

  const T* qb = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
  const T* dob = static_cast<const T*>(a.dout) + b * a.sdo.b + h * a.sdo.h;
  const T* kb = static_cast<const T*>(a.k) + b * a.sk.b + hk * a.sk.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.sv.b + hk * a.sv.h;
  const int rows_q = min(R, a.Sq - q0);
  rtt::load_tile<T, R, DMAX, kThreads, VEC>(qb + q0 * a.sq.s, a.sq.s, rows_q,
                                            D, 1.f, q_s, P);
  rtt::load_tile<T, R, DMAX, kThreads, VEC>(dob + q0 * a.sdo.s, a.sdo.s,
                                            rows_q, D, 1.f, do_s, P);
  float lse_r[RPT], dl_r[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty * RPT + i;
    const bool in = row < a.Sq;
    lse_r[i] = in ? a.lse[int64_t(bh) * a.Sq + row] : 0.f;
    dl_r[i] = in ? a.delta[int64_t(bh) * a.Sq + row] : 0.f;
  }

  float acc[RPT][NC];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  const int hi = key_tiles_seen(a, q0, R);
  for (int j = 0; j < hi; ++j) {
    const int k0 = j * R;
    const int rows_k = min(R, a.Skv - k0);
    __syncthreads();  // the previous tile's readers are done
    rtt::load_tile<T, R, DMAX, kThreads, VEC>(kb + k0 * a.sk.s, a.sk.s,
                                              rows_k, D, 1.f, k_s, P);
    rtt::load_tile<T, R, DMAX, kThreads, VEC>(vb + k0 * a.sv.s, a.sv.s,
                                              rows_k, D, 1.f, v_s, P);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this thread's RPT x CPT entries.
    float s[RPT][CPT], dp[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) s[i][c] = dp[i][c] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[RPT], dov[RPT], kv[CPT], vv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        qv[i] = q_s[(ty * RPT + i) * P + d];
        dov[i] = do_s[(ty * RPT + i) * P + d];
      }
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        kv[c] = k_s[(tx + 8 * c) * P + d];
        vv[c] = v_s[(tx + 8 * c) * P + d];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
          dp[i][c] = fmaf(dov[i], vv[c], dp[i][c]);
        }
    }

    // dS = P (dP - delta), P = exp(S scale - lse); masked entries are 0
    // before the exp is taken (a fully masked row's lse is -1e30).
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const bool ok = visible(a, q0 + ty * RPT + i, k0 + tx + 8 * c);
        const float p = ok ? expf(s[i][c] * a.scale - lse_r[i]) : 0.f;
        ds_s[(ty * RPT + i) * SP + tx + 8 * c] = p * (dp[i][c] - dl_r[i]);
      }
    __syncthreads();

    // dQ += dS K for this thread's RPT x Dmax/8 outputs.
    for (int kk = 0; kk < rows_k; ++kk) {
      float dsv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) dsv[i] = ds_s[(ty * RPT + i) * SP + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float kv = k_s[kk * P + tx + 8 * c];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][c] = fmaf(dsv[i], kv, acc[i][c]);
      }
    }
  }

  T* dqb = static_cast<T*>(a.dq) + b * a.sdq.b + h * a.sdq.h;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty * RPT + i;
    if (row >= a.Sq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 8 * c;
      if (d < D) dqb[row * a.sdq.s + d] = from_float<T>(acc[i][c] * a.scale);
    }
  }
}

template <typename T, int DMAX, bool VEC>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(BwdArgs a) {
  constexpr int R = tile_rows(DMAX);
  constexpr int P = DMAX + 1;
  constexpr int SP = R + 1;
  constexpr int RPT = R / 16, CPT = R / 8, NC = DMAX / 8;

  extern __shared__ float4 rtt_smem[];
  float* k_s = reinterpret_cast<float*>(rtt_smem);
  float* v_s = k_s + R * P;
  float* q_s = v_s + R * P;
  float* do_s = q_s + R * P;
  float* p_s = do_s + R * P;   // [R keys][R queries]
  float* ds_s = p_s + R * SP;  // [R keys][R queries]
  float* lse_s = ds_s + R * SP;
  float* dl_s = lse_s + R;

  const int tid = threadIdx.x;
  const int ty = tid >> 3;  // key rows ty*RPT .. ty*RPT+RPT-1
  const int tx = tid & 7;   // query columns tx, tx+8, ...
  const HeadRange hr = dkv_heads(a);
  const int k0 = blockIdx.x * R;
  const int rows_k = min(R, a.Skv - k0);
  const int D = a.D;

  const T* kb = static_cast<const T*>(a.k) + hr.b * a.sk.b + hr.hk * a.sk.h;
  const T* vb = static_cast<const T*>(a.v) + hr.b * a.sv.b + hr.hk * a.sv.h;
  rtt::load_tile<T, R, DMAX, kThreads, VEC>(kb + k0 * a.sk.s, a.sk.s, rows_k,
                                            D, 1.f, k_s, P);
  rtt::load_tile<T, R, DMAX, kThreads, VEC>(vb + k0 * a.sv.s, a.sv.s, rows_k,
                                            D, 1.f, v_s, P);

  float dk[RPT][NC], dv[RPT][NC];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[i][c] = dv[i][c] = 0.f;

  const int lo = first_query_tile(a, k0, R);
  const int nq = (a.Sq + R - 1) / R;
  for (int hh = 0; hh < hr.n; ++hh) {
    const int h = hr.h0 + hh;
    const int64_t bh = int64_t(hr.b) * a.H + h;
    const T* qb = static_cast<const T*>(a.q) + hr.b * a.sq.b + h * a.sq.h;
    const T* dob =
        static_cast<const T*>(a.dout) + hr.b * a.sdo.b + h * a.sdo.h;
    for (int j = lo; j < nq; ++j) {
      const int q0 = j * R;
      const int rows_q = min(R, a.Sq - q0);
      __syncthreads();  // the previous tile's readers are done
      rtt::load_tile<T, R, DMAX, kThreads, VEC>(qb + q0 * a.sq.s, a.sq.s,
                                                rows_q, D, 1.f, q_s, P);
      rtt::load_tile<T, R, DMAX, kThreads, VEC>(dob + q0 * a.sdo.s, a.sdo.s,
                                                rows_q, D, 1.f, do_s, P);
      if (tid < R) {
        const bool in = tid < rows_q;
        lse_s[tid] = in ? a.lse[bh * a.Sq + q0 + tid] : 0.f;
        dl_s[tid] = in ? a.delta[bh * a.Sq + q0 + tid] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: rows are keys, columns queries.
      float s[RPT][CPT], dp[RPT][CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) s[i][c] = dp[i][c] = 0.f;
      for (int d = 0; d < D; ++d) {
        float kv[RPT], vv[RPT], qv[CPT], dov[CPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          kv[i] = k_s[(ty * RPT + i) * P + d];
          vv[i] = v_s[(ty * RPT + i) * P + d];
        }
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          qv[c] = q_s[(tx + 8 * c) * P + d];
          dov[c] = do_s[(tx + 8 * c) * P + d];
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            s[i][c] = fmaf(kv[i], qv[c], s[i][c]);
            dp[i][c] = fmaf(vv[i], dov[c], dp[i][c]);
          }
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int qc = tx + 8 * c;
          const bool ok = visible(a, q0 + qc, k0 + ty * RPT + i);
          const float p = ok ? expf(s[i][c] * a.scale - lse_s[qc]) : 0.f;
          p_s[(ty * RPT + i) * SP + qc] = p;
          ds_s[(ty * RPT + i) * SP + qc] = p * (dp[i][c] - dl_s[qc]);
        }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q for this thread's key rows.
      for (int qq = 0; qq < rows_q; ++qq) {
        float pv[RPT], dsv[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          pv[i] = p_s[(ty * RPT + i) * SP + qq];
          dsv[i] = ds_s[(ty * RPT + i) * SP + qq];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float dov = do_s[qq * P + tx + 8 * c];
          const float qv = q_s[qq * P + tx + 8 * c];
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            dv[i][c] = fmaf(pv[i], dov, dv[i][c]);
            dk[i][c] = fmaf(dsv[i], qv, dk[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = k0 + ty * RPT + i;
    if (row >= a.Skv) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 8 * c;
      if (d >= D) continue;
      store_dkv<T>(a, a.dk, a.sdk, hr.b, hr.hk, hr.h0, row, d,
                   dk[i][c] * a.scale);
      store_dkv<T>(a, a.dv, a.sdv, hr.b, hr.hk, hr.h0, row, d, dv[i][c]);
    }
  }
}

// ---- bf16 on Hopper's tensor cores: wgmma ------------------------------
//
// Both kernels run two consumer warpgroups (256 threads) on one block and
// copy their streamed tiles themselves (no producer warp): each warpgroup
// owns 64 of the block's 128 rows, and all 256 threads start the
// asynchronous copies of a ring of kStages stages. Step i of a block:
//   wait for step i's copies (cp.async.wait_group), fence them to the async
//   proxy, __syncthreads (step i's tiles are in; every thread is done with
//   step i - 1's stage), start the copies of step i + kStages - 1 into the
//   stage step i - 1 used, then compute step i.
// So the copies of the next kStages - 1 tiles run while the products of
// this one do, with one barrier a step. Tiles are laid out for wgmma
// (wgmma.cuh: 128-byte swizzle, 1,024-byte aligned); rows past the tensor
// and columns past D are zero-filled by the copies.

namespace sm90 = rtt::sm90;

constexpr int kWarpgroups = 2;
constexpr int kWgThreads = 128 * kWarpgroups;
constexpr int kBlockRows = 64 * kWarpgroups;  // keys (dK/dV), queries (dQ)
constexpr int kStepRows = 64;                 // queries (dK/dV), keys (dQ)
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory: 1,024 bytes of alignment slack, the block's two resident
// tiles (K and V, or Q and dO), and per stage the two streamed tiles plus
// 64 lse and 64 delta values (used by dK/dV). 133,120 bytes at D = 128.
template <int DMAX>
constexpr size_t wgmma_smem_bytes() {
  return 1024 + 2 * size_t(sm90::SwTile<kBlockRows, DMAX>::kBytes) +
         kStages * (2 * size_t(sm90::SwTile<kStepRows, DMAX>::kBytes) +
                    2 * kStepRows * sizeof(float));
}

// Key tiles of `tile` rows [0, n) that the query rows before `q_end` see.
__device__ __forceinline__ int key_tiles_before(const BwdArgs& a, int q_end,
                                                int tile) {
  const int nk = (a.Skv + tile - 1) / tile;
  if (!a.causal) return nk;
  const int reach = a.q_offset + q_end - 1 - a.kv_offset;
  return reach < 0 ? 0 : min(nk, reach / tile + 1);
}

// dK/dV. A block owns 128 keys of one (batch, KV head), or of one (batch,
// query head) in the per-head mode: blockIdx.x is the head, blockIdx.y the
// key tile, so blocks are dispatched key tile 0 first, the longest chains
// under causal masking (the wrapper's grid rule bounds that chain). The
// block streams the 64-row Q and dO tiles of every query head it covers
// from the causal lower bound on, as one chain of steps across heads; each
// warpgroup keeps its 64 keys' dK and dV in float registers to the end.
// A step, per warpgroup (64 keys x 64 queries):
//   S^T = K Q^T, dP^T = V dO^T   (wgmma SS, K-major, D/16 k-steps each)
//   P^T = exp(S^T scale - lse), dS^T = P^T (dP^T - delta), 0 where masked
//   dV += P^T dO, dK += dS^T Q   (wgmma RS: P^T, dS^T from the
//                                 accumulators as bf16; dO, Q MN-major)
// Registers at D = 128: dK and dV 64 floats each a thread, S^T and dP^T 32
// each, P^T and dS^T as 16 bf16 pairs each, ~230 live at the peak: ptxas
// takes all 255 a thread may have (256 threads x 255 fit the SM's 64K
// once: one block an SM). Check -Xptxas -v for spills after an edit.
template <int DMAX>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dkv_wgmma_kernel(BwdArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int KT = sm90::SwTile<kBlockRows, DMAX>::kBytes;
  constexpr int QT = sm90::SwTile<kStepRows, DMAX>::kBytes;
  constexpr int NK = DMAX / 16;       // k-steps over d
  constexpr int NS = kStepRows / 16;  // k-steps over a step's queries

  extern __shared__ float4 rtt_smem[];
  const uint32_t raw = sm90::smem_addr(rtt_smem);
  const uint32_t k_s = (raw + 1023) & ~1023u;
  const uint32_t v_s = k_s + KT;
  const uint32_t ring = v_s + KT;  // stage s: Q at ring + 2 QT s, dO next
  float* lse_s = reinterpret_cast<float*>(
      reinterpret_cast<char*>(rtt_smem) + (ring + kStages * 2 * QT - raw));
  float* dl_s = lse_s + kStages * kStepRows;  // both [kStages][kStepRows]

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  const HeadRange hr = heads_of(a, blockIdx.x);
  const int k0 = blockIdx.y * kBlockRows;
  const int kw = k0 + 64 * wg;         // this warpgroup's first key
  const int key = kw + 16 * warp + g;  // this thread's keys: key, key + 8
  const int D = a.D;

  const bf16* kb =
      static_cast<const bf16*>(a.k) + hr.b * a.sk.b + hr.hk * a.sk.h;
  const bf16* vb =
      static_cast<const bf16*>(a.v) + hr.b * a.sv.b + hr.hk * a.sv.h;
  const int lo = first_query_tile(a, k0, kStepRows);
  const int per = (a.Sq + kStepRows - 1) / kStepRows - lo;  // steps a head
  const int steps = hr.n * per;

  // Step i streams query tile lo + i % per of head h0 + i / per into stage
  // i % kStages: Q, dO, and the tile's lse and delta.
  auto fetch = [&](int i) {
    const int s = i % kStages;
    const int h = hr.h0 + i / per;
    const int q0 = (lo + i % per) * kStepRows;
    const int rows = min(kStepRows, a.Sq - q0);
    const uint32_t q_st = ring + s * 2 * QT;
    sm90::cp_async_tile<kStepRows, DMAX, kWgThreads>(
        static_cast<const bf16*>(a.q) + hr.b * a.sq.b + h * a.sq.h +
            q0 * a.sq.s,
        a.sq.s, rows, D, q_st, tid);
    sm90::cp_async_tile<kStepRows, DMAX, kWgThreads>(
        static_cast<const bf16*>(a.dout) + hr.b * a.sdo.b + h * a.sdo.h +
            q0 * a.sdo.s,
        a.sdo.s, rows, D, q_st + QT, tid);
    if (tid < 2 * kStepRows) {
      const int r = tid % kStepRows;
      const bool lse = tid < kStepRows;
      const float* src = (lse ? a.lse : a.delta) +
                         (int64_t(hr.b) * a.H + h) * a.Sq + q0 + r;
      float* dst = (lse ? lse_s : dl_s) + s * kStepRows + r;
      sm90::cp_async4(sm90::smem_addr(dst), r < rows ? src : a.lse,
                      r < rows ? 4 : 0);
    }
  };

  const int rows_k = min(kBlockRows, a.Skv - k0);
  sm90::cp_async_tile<kBlockRows, DMAX, kWgThreads>(
      kb + k0 * a.sk.s, a.sk.s, rows_k, D, k_s, tid);
  sm90::cp_async_tile<kBlockRows, DMAX, kWgThreads>(
      vb + k0 * a.sv.s, a.sv.s, rows_k, D, v_s, tid);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < steps) fetch(i);
    sm90::cp_async_commit();
  }

  float dk[DMAX / 2], dv[DMAX / 2];
#pragma unroll
  for (int i = 0; i < DMAX / 2; ++i) dk[i] = dv[i] = 0.f;
  const float scale_log2 = a.scale * kLog2e;

  for (int i = 0; i < steps; ++i) {
    sm90::cp_async_wait<kStages - 2>();
    sm90::fence_async_smem();
    __syncthreads();
    if (i + kStages - 1 < steps) fetch(i + kStages - 1);
    sm90::cp_async_commit();

    const int q0 = (lo + i % per) * kStepRows;
    const int q_last = min(q0 + kStepRows, a.Sq) - 1;
    // Nothing to add when this warpgroup's keys are past the tensor or all
    // after the tile's last query (a warpgroup-uniform branch).
    if (kw >= a.Skv || (a.causal && a.kv_offset + kw > a.q_offset + q_last))
      continue;
    const int s = i % kStages;
    const uint32_t q_st = ring + s * 2 * QT;
    const uint32_t do_st = q_st + QT;
    const float* lse_t = lse_s + s * kStepRows;
    const float* dl_t = dl_s + s * kStepRows;

    // S^T and dP^T in two commit groups, so the exponentials of S^T run
    // while the tensor cores compute dP^T, and dS^T while they add P^T dO.
    float st[32], dpt[32];
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
      sm90::wgmma_ss_m64n64k16(
          st, sm90::desc_kmajor<kBlockRows>(k_s, 64 * wg, kk),
          sm90::desc_kmajor<kStepRows>(q_st, 0, kk), kk > 0);
    sm90::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
      sm90::wgmma_ss_m64n64k16(
          dpt, sm90::desc_kmajor<kBlockRows>(v_s, 64 * wg, kk),
          sm90::desc_kmajor<kStepRows>(do_st, 0, kk), kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();
    sm90::fence_operand(st);

    // P^T = exp(S^T scale - lse), 0 where masked. Entry 4j + x: key
    // `key + 8 (x / 2)`, query q0 + 8j + 2t + x % 2. The mask is applied to
    // the exponent (-inf), in a separate loop that only tiles on a ragged
    // edge or the causal diagonal run: no branch per entry, so the SFU's
    // exponentials run back to back.
#pragma unroll
    for (int n = 0; n < 32; ++n)
      st[n] = st[n] * scale_log2 - lse_t[8 * (n >> 2) + 2 * t + (n & 1)] *
                                       kLog2e;
    if (!(q0 + kStepRows <= a.Sq && kw + 64 <= a.Skv &&
          (!a.causal || a.kv_offset + kw + 63 <= a.q_offset + q0))) {
#pragma unroll
      for (int n = 0; n < 32; ++n)
        if (!visible(a, q0 + 8 * (n >> 2) + 2 * t + (n & 1),
                     key + 8 * ((n >> 1) & 1)))
          st[n] = __int_as_float(0xff800000);  // -inf
    }
#pragma unroll
    for (int n = 0; n < 32; ++n) st[n] = sm90::exp2_approx(st[n]);
    uint32_t pa[NS][4];
#pragma unroll
    for (int kk = 0; kk < NS; ++kk) sm90::a_fragment(st, kk, pa[kk]);
    sm90::fence_operand(dv);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NS; ++kk)  // dV += P^T dO
      sm90::wgmma_rs<DMAX>(dv, pa[kk],
                           sm90::desc_mnmajor<kStepRows>(do_st, kk), 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();  // dP^T is in; dV may still run
    sm90::fence_operand(dpt);

    // dS^T = P^T (dP^T - delta).
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int n = 4 * j + x;
        dpt[n] = st[n] * (dpt[n] - dl_t[8 * j + 2 * t + (x & 1)]);
      }
    uint32_t da[NS][4];
#pragma unroll
    for (int kk = 0; kk < NS; ++kk) sm90::a_fragment(dpt, kk, da[kk]);
    sm90::fence_operand(dk);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NS; ++kk)  // dK += dS^T Q
      sm90::wgmma_rs<DMAX>(dk, da[kk],
                           sm90::desc_mnmajor<kStepRows>(q_st, kk), 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_operand(dv);
    sm90::fence_operand(dk);
  }
  sm90::cp_async_wait<0>();  // a block with no steps still has K and V

  // Entry 4j + 2hh + e: key `key + 8hh`, column 8j + 2t + e; stored two
  // columns at a time (float2 per head, else a bf16 pair).
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = key + 8 * hh;
    if (row >= a.Skv) continue;
#pragma unroll
    for (int j = 0; j < DMAX / 8; ++j) {
      const int d = 8 * j + 2 * t;
      if (d >= D) continue;
      const int n = 4 * j + 2 * hh;
      const float k_lo = dk[n] * a.scale, k_hi = dk[n + 1] * a.scale;
      if (a.per_head) {
        const int64_t off = hr.b * a.sdk.b + row * a.sdk.s + hr.h0 * a.sdk.h;
        const int64_t offv = hr.b * a.sdv.b + row * a.sdv.s + hr.h0 * a.sdv.h;
        *reinterpret_cast<float2*>(static_cast<float*>(a.dk) + off + d) =
            make_float2(k_lo, k_hi);
        *reinterpret_cast<float2*>(static_cast<float*>(a.dv) + offv + d) =
            make_float2(dv[n], dv[n + 1]);
      } else {
        const int64_t off = hr.b * a.sdk.b + row * a.sdk.s + hr.hk * a.sdk.h;
        const int64_t offv = hr.b * a.sdv.b + row * a.sdv.s + hr.hk * a.sdv.h;
        *reinterpret_cast<unsigned*>(static_cast<bf16*>(a.dk) + off + d) =
            rtt::pack_bf16x2(k_lo, k_hi);
        *reinterpret_cast<unsigned*>(static_cast<bf16*>(a.dv) + offv + d) =
            rtt::pack_bf16x2(dv[n], dv[n + 1]);
      }
    }
  }
}

// dQ. A block owns 128 query rows of one (batch, head): blockIdx.x is the
// head, blockIdx.y counts query tiles from the last, so the longest causal
// chains are dispatched first. It streams the 64-row K and V tiles up to
// the causal bound; each warpgroup keeps its 64 rows' dQ in float
// registers. A step, per warpgroup (64 queries x 64 keys):
//   S = Q K^T, dP = dO V^T       (wgmma SS, K-major)
//   dS = P (dP - delta), P = exp(S scale - lse), 0 where masked
//   dQ += dS K                   (wgmma RS: dS from the accumulators as
//                                 bf16; K MN-major)
// The first warpgroup's rows see one key tile fewer on the diagonal and
// skip it. Registers at D = 128: dQ 64 floats, S and dP 32 each, dS 16
// pairs. The grid's chains differ by at most ceil(Sq / 64) steps and
// B*H*ceil(Sq/128) blocks fill the SMs at the training shapes, so dQ needs
// no grid switch; the longest-first order trims its tail.
template <int DMAX>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dq_wgmma_kernel(BwdArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int QT = sm90::SwTile<kBlockRows, DMAX>::kBytes;
  constexpr int KT = sm90::SwTile<kStepRows, DMAX>::kBytes;
  constexpr int NK = DMAX / 16;
  constexpr int NS = kStepRows / 16;

  extern __shared__ float4 rtt_smem[];
  const uint32_t q_s = (sm90::smem_addr(rtt_smem) + 1023) & ~1023u;
  const uint32_t do_s = q_s + QT;
  const uint32_t ring = do_s + QT;  // stage s: K at ring + 2 KT s, V next

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int hk = h / (a.H / a.Hkv);
  const int q0 =
      ((a.Sq + kBlockRows - 1) / kBlockRows - 1 - int(blockIdx.y)) *
      kBlockRows;
  const int qw = q0 + 64 * wg;         // this warpgroup's first row
  const int row = qw + 16 * warp + g;  // this thread's rows: row, row + 8
  const int D = a.D;

  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.sk.b + hk * a.sk.h;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.sv.b + hk * a.sv.h;
  const int steps = key_tiles_before(a, min(q0 + kBlockRows, a.Sq), kStepRows);
  const int wg_steps =
      qw < a.Sq ? key_tiles_before(a, min(qw + 64, a.Sq), kStepRows) : 0;

  auto fetch = [&](int i) {  // K and V tile i into stage i % kStages
    const int s = i % kStages;
    const int kt0 = i * kStepRows;
    const int rows = min(kStepRows, a.Skv - kt0);
    sm90::cp_async_tile<kStepRows, DMAX, kWgThreads>(
        kb + kt0 * a.sk.s, a.sk.s, rows, D, ring + s * 2 * KT, tid);
    sm90::cp_async_tile<kStepRows, DMAX, kWgThreads>(
        vb + kt0 * a.sv.s, a.sv.s, rows, D, ring + s * 2 * KT + KT, tid);
  };

  const int rows_q = min(kBlockRows, a.Sq - q0);
  sm90::cp_async_tile<kBlockRows, DMAX, kWgThreads>(
      static_cast<const bf16*>(a.q) + b * a.sq.b + h * a.sq.h + q0 * a.sq.s,
      a.sq.s, rows_q, D, q_s, tid);
  sm90::cp_async_tile<kBlockRows, DMAX, kWgThreads>(
      static_cast<const bf16*>(a.dout) + b * a.sdo.b + h * a.sdo.h +
          q0 * a.sdo.s,
      a.sdo.s, rows_q, D, do_s, tid);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < steps) fetch(i);
    sm90::cp_async_commit();
  }

  float lse_r[2], dl_r[2];  // lse in log2 units
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row + 8 * hh;
    const bool in = r < a.Sq;
    lse_r[hh] = in ? a.lse[int64_t(bh) * a.Sq + r] * kLog2e : 0.f;
    dl_r[hh] = in ? a.delta[int64_t(bh) * a.Sq + r] : 0.f;
  }
  float dq[DMAX / 2];
#pragma unroll
  for (int i = 0; i < DMAX / 2; ++i) dq[i] = 0.f;
  const float scale_log2 = a.scale * kLog2e;

  for (int i = 0; i < steps; ++i) {
    sm90::cp_async_wait<kStages - 2>();
    sm90::fence_async_smem();
    __syncthreads();
    if (i + kStages - 1 < steps) fetch(i + kStages - 1);
    sm90::cp_async_commit();
    if (i >= wg_steps) continue;  // warpgroup-uniform

    const int kt0 = i * kStepRows;
    const uint32_t k_st = ring + (i % kStages) * 2 * KT;
    const uint32_t v_st = k_st + KT;
    // S and dP in two commit groups: the exponentials of S run while the
    // tensor cores compute dP.
    float sc[32], dp[32];
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
      sm90::wgmma_ss_m64n64k16(
          sc, sm90::desc_kmajor<kBlockRows>(q_s, 64 * wg, kk),
          sm90::desc_kmajor<kStepRows>(k_st, 0, kk), kk > 0);
    sm90::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
      sm90::wgmma_ss_m64n64k16(
          dp, sm90::desc_kmajor<kBlockRows>(do_s, 64 * wg, kk),
          sm90::desc_kmajor<kStepRows>(v_st, 0, kk), kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();
    sm90::fence_operand(sc);

    // P = exp(S scale - lse), 0 where masked (as in dK/dV: the mask goes
    // into the exponent, only on edge and diagonal tiles). Entry 4j + x:
    // row `row + 8 (x / 2)`, key kt0 + 8j + 2t + x % 2.
#pragma unroll
    for (int n = 0; n < 32; ++n)
      sc[n] = sc[n] * scale_log2 - lse_r[(n >> 1) & 1];
    if (!(qw + 64 <= a.Sq && kt0 + kStepRows <= a.Skv &&
          (!a.causal ||
           a.kv_offset + kt0 + kStepRows - 1 <= a.q_offset + qw))) {
#pragma unroll
      for (int n = 0; n < 32; ++n)
        if (!visible(a, row + 8 * ((n >> 1) & 1),
                     kt0 + 8 * (n >> 2) + 2 * t + (n & 1)))
          sc[n] = __int_as_float(0xff800000);  // -inf
    }
#pragma unroll
    for (int n = 0; n < 32; ++n) sc[n] = sm90::exp2_approx(sc[n]);
    sm90::wgmma_wait<0>();
    sm90::fence_operand(dp);
    // dS = P (dP - delta), then dQ += dS K.
#pragma unroll
    for (int n = 0; n < 32; ++n) dp[n] = sc[n] * (dp[n] - dl_r[(n >> 1) & 1]);
    uint32_t da[NS][4];
#pragma unroll
    for (int kk = 0; kk < NS; ++kk) sm90::a_fragment(dp, kk, da[kk]);
    sm90::fence_operand(dq);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NS; ++kk)
      sm90::wgmma_rs<DMAX>(dq, da[kk], sm90::desc_mnmajor<kStepRows>(k_st, kk),
                           1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_operand(dq);
  }
  sm90::cp_async_wait<0>();  // a block with no steps still has Q and dO

  bf16* dqb = static_cast<bf16*>(a.dq) + b * a.sdq.b + h * a.sdq.h;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row + 8 * hh;
    if (r >= a.Sq) continue;
#pragma unroll
    for (int j = 0; j < DMAX / 8; ++j) {
      const int d = 8 * j + 2 * t;
      if (d < D)
        *reinterpret_cast<unsigned*>(dqb + r * a.sdq.s + d) =
            rtt::pack_bf16x2(dq[4 * j + 2 * hh] * a.scale,
                             dq[4 * j + 2 * hh + 1] * a.scale);
    }
  }
}

// ---- launch -------------------------------------------------------------

template <typename Kernel>
cudaError_t launch_kernel(Kernel kernel, size_t smem, dim3 grid,
                          const BwdArgs& a, cudaStream_t stream,
                          int threads = kThreads) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The grid of a kernel with `rows`-row tiles: dQ over (query tiles, B*H),
// dK/dV over (key tiles, B*Hkv or B*H in the per-head mode).
dim3 grid_for(const BwdArgs& a, bool dq, int rows) {
  if (dq) return dim3((a.Sq + rows - 1) / rows, a.B * a.H);
  return dim3((a.Skv + rows - 1) / rows, a.B * (a.per_head ? a.H : a.Hkv));
}

template <typename T, int DMAX, bool VEC>
cudaError_t launch_scalar(const BwdArgs& a, bool dq, cudaStream_t stream) {
  const dim3 grid = grid_for(a, dq, tile_rows(DMAX));
  if (dq)
    return launch_kernel(flash_bwd_dq_kernel<T, DMAX, VEC>,
                         dq_smem_bytes<DMAX>(), grid, a, stream);
  return launch_kernel(flash_bwd_dkv_kernel<T, DMAX, VEC>,
                       dkv_smem_bytes<DMAX>(), grid, a, stream);
}

template <typename T, bool VEC>
cudaError_t launch_for_dim(const BwdArgs& a, bool dq, cudaStream_t stream) {
  if (a.D <= 64) return launch_scalar<T, 64, VEC>(a, dq, stream);
  if (a.D <= 128) return launch_scalar<T, 128, VEC>(a, dq, stream);
  return launch_scalar<T, 256, VEC>(a, dq, stream);
}

// The wgmma kernels' grids put the head on x and the tile on y, so blocks
// are dispatched tile by tile, the longest chains first.
template <int DMAX>
cudaError_t launch_wgmma(const BwdArgs& a, bool dq, cudaStream_t stream) {
  const size_t smem = wgmma_smem_bytes<DMAX>();
  if (dq)
    return launch_kernel(
        flash_bwd_dq_wgmma_kernel<DMAX>, smem,
        dim3(a.B * a.H, (a.Sq + kBlockRows - 1) / kBlockRows), a, stream,
        kWgThreads);
  return launch_kernel(flash_bwd_dkv_wgmma_kernel<DMAX>, smem,
                       dim3(a.B * (a.per_head ? a.H : a.Hkv),
                            (a.Skv + kBlockRows - 1) / kBlockRows),
                       a, stream, kWgThreads);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Whether every row the kernel reads starts on a 16-byte boundary.
template <typename T>
bool vector_rows(const BwdArgs& a) {
  constexpr int E = rtt::kVec<T>;
  bool ok = a.D % E == 0 && aligned16(a.q) && aligned16(a.k) &&
            aligned16(a.v) && aligned16(a.dout);
  for (const Strides& s : {a.sq, a.sk, a.sv, a.sdo})
    ok = ok && s.b % E == 0 && s.s % E == 0 && s.h % E == 0;
  return ok;
}

// Whether the wgmma kernels can store the outputs two columns at a time:
// even strides and bases on 4 bytes (a bf16 pair) or 8 (a float2 per head).
bool paired_outputs(const BwdArgs& a, bool dq) {
  auto even = [](const Strides& s) {
    return s.b % 2 == 0 && s.s % 2 == 0 && s.h % 2 == 0;
  };
  auto on = [](const void* p, int n) {
    return reinterpret_cast<uintptr_t>(p) % n == 0;
  };
  if (dq) return even(a.sdq) && on(a.dq, 4);
  const int n = a.per_head ? 8 : 4;
  return even(a.sdk) && even(a.sdv) && on(a.dk, n) && on(a.dv, n);
}

template <typename T>
cudaError_t launch_for_type(const BwdArgs& a, bool dq, cudaStream_t stream) {
  // bf16 with aligned rows and D a multiple of 16 up to 128 (the 8B model's
  // shape) runs on the tensor cores (wgmma); everything else on the CUDA
  // cores.
  if (std::is_same<T, __nv_bfloat16>::value && a.D % 16 == 0 &&
      a.D <= 128 && vector_rows<T>(a) && paired_outputs(a, dq)) {
    if (a.D <= 64) return launch_wgmma<64>(a, dq, stream);
    return launch_wgmma<128>(a, dq, stream);
  }
  if (vector_rows<T>(a)) return launch_for_dim<T, true>(a, dq, stream);
  return launch_for_dim<T, false>(a, dq, stream);
}

cudaError_t launch(int dtype, const BwdArgs& a, bool dq, void* stream) {
  if (a.D < 1 || a.D > 256 || a.Hkv < 1 || a.H % a.Hkv != 0 ||
      a.B * a.H > 65535 || a.Sq < 1 || a.Skv < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rtt::kFloat32) return launch_for_type<float>(a, dq, s);
  if (dtype == rtt::kBFloat16)
    return launch_for_type<__nv_bfloat16>(a, dq, s);
  return cudaErrorInvalidValue;
}

BwdArgs make_args(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  int B, int H, int Hkv, int Sq, int Skv, int D,
                  const int64_t* st, float scale, int causal, int q_offset,
                  int kv_offset) {
  BwdArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  Strides* s[] = {&a.sq, &a.sk, &a.sv, &a.sdo};
  for (int i = 0; i < 4; ++i) *s[i] = {st[3 * i], st[3 * i + 1], st[3 * i + 2]};
  a.B = B;
  a.H = H;
  a.Hkv = Hkv;
  a.Sq = Sq;
  a.Skv = Skv;
  a.D = D;
  a.scale = scale;
  a.causal = causal;
  a.q_offset = q_offset;
  a.kv_offset = kv_offset;
  return a;
}

}  // namespace

// strides: (batch, seq, head) strides in elements of q, k, v, do and dq
// (15 int64 values). Returns a cudaError_t (0 on success).
extern "C" int rtt_flash_bwd_dq(int dtype, const void* q, const void* k,
                                const void* v, const void* dout,
                                const void* lse, const void* delta, void* dq,
                                int B, int H, int Hkv, int Sq, int Skv, int D,
                                const void* strides, float scale, int causal,
                                int q_offset, int kv_offset, void* stream) {
  const int64_t* st = static_cast<const int64_t*>(strides);
  BwdArgs a = make_args(q, k, v, dout, lse, delta, B, H, Hkv, Sq, Skv, D, st,
                        scale, causal, q_offset, kv_offset);
  a.dq = dq;
  a.sdq = {st[12], st[13], st[14]};
  return int(launch(dtype, a, true, stream));
}

// strides: (batch, seq, head) strides in elements of q, k, v, do, dk and dv
// (18 int64 values). per_head: dk/dv are float32 [B, Skv, H, D], one slice
// per query head; else [B, Skv, Hkv, D] in the input dtype, summed over
// each group. Returns a cudaError_t (0 on success).
extern "C" int rtt_flash_bwd_dkv(int dtype, const void* q, const void* k,
                                 const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dk,
                                 void* dv, int B, int H, int Hkv, int Sq,
                                 int Skv, int D, const void* strides,
                                 float scale, int causal, int q_offset,
                                 int kv_offset, int per_head, void* stream) {
  const int64_t* st = static_cast<const int64_t*>(strides);
  BwdArgs a = make_args(q, k, v, dout, lse, delta, B, H, Hkv, Sq, Skv, D, st,
                        scale, causal, q_offset, kv_offset);
  a.dk = dk;
  a.dv = dv;
  a.sdk = {st[12], st[13], st[14]};
  a.sdv = {st[15], st[16], st[17]};
  a.per_head = per_head;
  return int(launch(dtype, a, false, stream));
}

// Whether a bf16 launch at head dim D runs the wgmma kernels (given
// aligned rows and outputs, which the wrapper's contiguous tensors have).
static bool wgmma_path(int dtype, int D) {
  return dtype == rtt::kBFloat16 && D % 16 == 0 && D >= 16 && D <= 128;
}

// Rows of the backward kernels' tiles at dtype code `dtype` and head dim D
// (1..256): the rows a block owns (queries in dQ, keys in dK/dV) when
// `step` is 0, the rows each step streams (keys in dQ, queries in dK/dV)
// when it is 1. The wrapper's grid rule keeps a copy (flash_attention.py:
// bwd_tiles); a card test holds the two together.
extern "C" int rtt_flash_bwd_tile_rows(int dtype, int D, int step) {
  if (wgmma_path(dtype, D)) return step ? kStepRows : kBlockRows;
  return tile_rows(D <= 64 ? 64 : D <= 128 ? 128 : 256);
}

// Blocks of the dK/dV kernel resident on one SM of the current device, at
// dtype code `dtype` and head dim D, into *out. Returns a cudaError_t.
extern "C" int rtt_flash_bwd_dkv_blocks_per_sm(int dtype, int D, int* out) {
  auto query = [&](auto kernel, size_t smem, int threads) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
    return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel,
                                                             threads, smem));
  };
  if (wgmma_path(dtype, D)) {
    if (D <= 64)
      return query(flash_bwd_dkv_wgmma_kernel<64>, wgmma_smem_bytes<64>(),
                   kWgThreads);
    return query(flash_bwd_dkv_wgmma_kernel<128>, wgmma_smem_bytes<128>(),
                 kWgThreads);
  }
  if (dtype == rtt::kFloat32) {
    if (D <= 64)
      return query(flash_bwd_dkv_kernel<float, 64, true>,
                   dkv_smem_bytes<64>(), kThreads);
    if (D <= 128)
      return query(flash_bwd_dkv_kernel<float, 128, true>,
                   dkv_smem_bytes<128>(), kThreads);
    return query(flash_bwd_dkv_kernel<float, 256, true>,
                 dkv_smem_bytes<256>(), kThreads);
  }
  if (D <= 64)
    return query(flash_bwd_dkv_kernel<__nv_bfloat16, 64, true>,
                 dkv_smem_bytes<64>(), kThreads);
  if (D <= 128)
    return query(flash_bwd_dkv_kernel<__nv_bfloat16, 128, true>,
                 dkv_smem_bytes<128>(), kThreads);
  return query(flash_bwd_dkv_kernel<__nv_bfloat16, 256, true>,
               dkv_smem_bytes<256>(), kThreads);
}
