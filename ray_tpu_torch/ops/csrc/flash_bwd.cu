// Flash-attention backward for Hopper (sm_90a): dQ, and dK/dV.
//
// Replaces the Pallas TPU kernels of ray_tpu/ops/flash_attention.py:
// `_flash_bwd_dq_kernel` (launched by `_flash_bwd`, dQ) and
// `_flash_bwd_dkv_kernel`, which `_flash_bwd` launches on two grids: the
// KV-head grid, where a block sums the GQA group's `rep` query heads in its
// float accumulator, and the per-query-head grid, whose group sum runs
// outside the kernel. Same function: with P = exp(S - lse) recomputed from
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
// (Sq + 2 Skv) * H * D elements, so at the 8B training shape (S = 2048,
// D = 128, bf16) both are bound by operations (~1,000 flops per byte moved),
// not by bytes. The score and probability tiles must never reach device
// memory (S^2 per head); every block recomputes its tiles on chip, and the
// two kernels never write the same output, so there are no atomics and the
// sums are deterministic.
// - dQ: one block owns a 64-row Q tile of one (batch, head) with its dO
//   tile, and loops over the K/V tiles up to the causal bound.
// - dK/dV: one block owns a 64-row K/V tile of one (batch, KV head) and,
//   for each query head of the group, streams Q/dO tiles through shared
//   memory from the causal lower bound on; dK and dV stay in float
//   registers until the one write. The TPU kept the whole [rep, Sq, D]
//   group resident in VMEM and needed the per-head grid when it did not
//   fit; streamed tiles always fit here, so the per-head mode is kept for
//   what it still buys on this card: rep times more blocks when the KV-head
//   grid would leave SMs idle (the wrapper's switch).
// Two versions of each, chosen from the inputs at each launch:
// - bf16 with D a multiple of 16 up to 128 and 16-byte-aligned rows (the 8B
//   model's shape): every product on the tensor cores (mma.sync m16n8k16,
//   bf16 in, float accumulate), four warps each owning 16 rows of the
//   block's tile; P and dS are rounded to bf16 as product operands, as in
//   flash-attention-2, and stay in float for dS = P * (dP - delta).
//   Shared memory: four bf16 tiles [64][D+8] and the Q tile's lse and delta
//   (dK/dV), 70,144 bytes at D = 128.
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

namespace {

using rtt::from_float;
using rtt::kPad;
using rtt::ld32;
using rtt::ld_col_pair;
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

// Tile rows of the scalar kernels (the tensor-core kernels always use 64).
// The wrapper's grid switch keeps a copy of this rule
// (flash_attention.py: bwd_tile_rows); a card test holds the two together
// through rtt_flash_bwd_tile_rows.
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
__device__ __forceinline__ HeadRange dkv_heads(const BwdArgs& a) {
  const int rep = a.H / a.Hkv;
  const int y = blockIdx.y;
  if (a.per_head) return {y / a.H, (y % a.H) / rep, y % a.H, 1};
  return {y / a.Hkv, y % a.Hkv, (y % a.Hkv) * rep, rep};
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

// ---- bf16 on the tensor cores -------------------------------------------
//
// Each of the 4 warps owns 16 rows of the block's 64-row tile (queries in
// dQ, keys in dK/dV). A warp's 16 x 64 score tile stays in the mma
// accumulators: s[n][2*hh + e] is row r0 + 8*hh, column 8n + 2t + e of the
// tile, with g = lane / 4, t = lane % 4 and r0 = 16 * warp + g. The
// accumulators of column n-tiles 2kk and 2kk+1 are, repacked as bf16, the A
// fragment of columns 16kk .. 16kk+15, so P and dS feed the next product
// without a trip through shared memory (as the forward's P feeds PV).

constexpr int kTile = 64;
constexpr int NT = kTile / 8;  // column n-tiles of a score tile
// Both versions tile by the same rows at the D they share, so one rule
// (tile_rows, exported as rtt_flash_bwd_tile_rows) gives the grid.
static_assert(kTile == tile_rows(64) && kTile == tile_rows(128),
              "the tensor-core and scalar kernels share their tile rows");

template <int DMAX>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * 4 * size_t(kTile) * (DMAX + kPad) +
         sizeof(float) * 2 * kTile;
}

// acc = A B^T over d for a warp's 16 x 64 tile: rows r0 and r0 + 8 of the
// bf16 tile `a_s` against the 64 rows of `b_s`, both of pitch DMAX + kPad;
// D a multiple of 16.
template <int DMAX>
__device__ __forceinline__ void tile_product_nt(const __nv_bfloat16* a_s,
                                                const __nv_bfloat16* b_s,
                                                int r0, int g, int t, int D,
                                                float (&acc)[NT][4]) {
  constexpr int PITCH = DMAX + kPad;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int d0 = 0; d0 < D; d0 += 16) {
    const unsigned fa[4] = {ld32(a_s + r0 * PITCH + d0 + 2 * t),
                            ld32(a_s + (r0 + 8) * PITCH + d0 + 2 * t),
                            ld32(a_s + r0 * PITCH + d0 + 8 + 2 * t),
                            ld32(a_s + (r0 + 8) * PITCH + d0 + 8 + 2 * t)};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const __nv_bfloat16* br = b_s + (n * 8 + g) * PITCH + d0 + 2 * t;
      const unsigned fb[2] = {ld32(br), ld32(br + 8)};
      rtt::mma_16816_bf16(acc[n], fa, fb);
    }
  }
}

// out[n] += X M, X the warp's 16 x 64 tile held as accumulators `x` (see
// above), M the 64 x DMAX bf16 tile `m_s` (rows = the tile's columns).
template <int DMAX>
__device__ __forceinline__ void accumulate_tn(const float (&x)[NT][4],
                                              const __nv_bfloat16* m_s,
                                              int g, int t,
                                              float (&out)[DMAX / 8][4]) {
  constexpr int PITCH = DMAX + kPad;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    const unsigned fa[4] = {rtt::pack_bf16x2(x[2 * kk][0], x[2 * kk][1]),
                            rtt::pack_bf16x2(x[2 * kk][2], x[2 * kk][3]),
                            rtt::pack_bf16x2(x[2 * kk + 1][0],
                                             x[2 * kk + 1][1]),
                            rtt::pack_bf16x2(x[2 * kk + 1][2],
                                             x[2 * kk + 1][3])};
    const int row = kk * 16 + 2 * t;
#pragma unroll
    for (int n = 0; n < DMAX / 8; ++n) {
      const int col = n * 8 + g;
      const unsigned fb[2] = {ld_col_pair(m_s, row, col, PITCH),
                              ld_col_pair(m_s, row + 8, col, PITCH)};
      rtt::mma_16816_bf16(out[n], fa, fb);
    }
  }
}

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_mma_kernel(BwdArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int PITCH = DMAX + kPad;
  constexpr int ND = DMAX / 8;

  extern __shared__ float4 rtt_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(rtt_smem);
  bf16* do_s = q_s + kTile * PITCH;
  bf16* k_s = do_s + kTile * PITCH;
  bf16* v_s = k_s + kTile * PITCH;

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16 + g;
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int hk = h / (a.H / a.Hkv);
  const int q0 = blockIdx.x * kTile;
  const int D = a.D;

  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.sq.b + h * a.sq.h;
  const bf16* dob =
      static_cast<const bf16*>(a.dout) + b * a.sdo.b + h * a.sdo.h;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.sk.b + hk * a.sk.h;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.sv.b + hk * a.sv.h;
  const int rows_q = min(kTile, a.Sq - q0);
  rtt::copy_tile_bf16<kTile, DMAX, kThreads>(qb + q0 * a.sq.s, a.sq.s, rows_q,
                                             D, q_s);
  rtt::copy_tile_bf16<kTile, DMAX, kThreads>(dob + q0 * a.sdo.s, a.sdo.s,
                                             rows_q, D, do_s);
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + r0 + 8 * hh;
    const bool in = row < a.Sq;
    lse_r[hh] = in ? a.lse[int64_t(bh) * a.Sq + row] : 0.f;
    dl_r[hh] = in ? a.delta[int64_t(bh) * a.Sq + row] : 0.f;
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int hi = key_tiles_seen(a, q0, kTile);
  for (int j = 0; j < hi; ++j) {
    const int k0 = j * kTile;
    const int rows_k = min(kTile, a.Skv - k0);
    __syncthreads();  // the previous tile's readers are done
    rtt::copy_tile_bf16<kTile, DMAX, kThreads>(kb + k0 * a.sk.s, a.sk.s,
                                               rows_k, D, k_s);
    rtt::copy_tile_bf16<kTile, DMAX, kThreads>(vb + k0 * a.sv.s, a.sv.s,
                                               rows_k, D, v_s);
    __syncthreads();

    float s[NT][4], dp[NT][4];
    tile_product_nt<DMAX>(q_s, k_s, r0, g, t, D, s);    // S = Q K^T
    tile_product_nt<DMAX>(do_s, v_s, r0, g, t, D, dp);  // dP = dO V^T
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * hh + e;
          const bool ok =
              visible(a, q0 + r0 + 8 * hh, k0 + n * 8 + 2 * t + e);
          const float p = ok ? expf(s[n][i] * a.scale - lse_r[hh]) : 0.f;
          s[n][i] = p * (dp[n][i] - dl_r[hh]);  // dS
        }
    accumulate_tn<DMAX>(s, k_s, g, t, acc);  // dQ += dS K
  }

  bf16* dqb = static_cast<bf16*>(a.dq) + b * a.sdq.b + h * a.sdq.h;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + r0 + 8 * hh;
    if (row >= a.Sq) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int col = n * 8 + 2 * t;
      if (col < D)
        *reinterpret_cast<unsigned*>(dqb + row * a.sdq.s + col) =
            rtt::pack_bf16x2(acc[n][2 * hh] * a.scale,
                             acc[n][2 * hh + 1] * a.scale);
    }
  }
}

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_mma_kernel(BwdArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int PITCH = DMAX + kPad;
  constexpr int ND = DMAX / 8;

  extern __shared__ float4 rtt_smem[];
  bf16* k_s = reinterpret_cast<bf16*>(rtt_smem);
  bf16* v_s = k_s + kTile * PITCH;
  bf16* q_s = v_s + kTile * PITCH;
  bf16* do_s = q_s + kTile * PITCH;
  float* lse_s = reinterpret_cast<float*>(do_s + kTile * PITCH);
  float* dl_s = lse_s + kTile;

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16 + g;  // key rows r0, r0 + 8
  const HeadRange hr = dkv_heads(a);
  const int k0 = blockIdx.x * kTile;
  const int rows_k = min(kTile, a.Skv - k0);
  const int D = a.D;

  const bf16* kb =
      static_cast<const bf16*>(a.k) + hr.b * a.sk.b + hr.hk * a.sk.h;
  const bf16* vb =
      static_cast<const bf16*>(a.v) + hr.b * a.sv.b + hr.hk * a.sv.h;
  rtt::copy_tile_bf16<kTile, DMAX, kThreads>(kb + k0 * a.sk.s, a.sk.s, rows_k,
                                             D, k_s);
  rtt::copy_tile_bf16<kTile, DMAX, kThreads>(vb + k0 * a.sv.s, a.sv.s, rows_k,
                                             D, v_s);

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  const int lo = first_query_tile(a, k0, kTile);
  const int nq = (a.Sq + kTile - 1) / kTile;
  for (int hh = 0; hh < hr.n; ++hh) {
    const int h = hr.h0 + hh;
    const int64_t bh = int64_t(hr.b) * a.H + h;
    const bf16* qb =
        static_cast<const bf16*>(a.q) + hr.b * a.sq.b + h * a.sq.h;
    const bf16* dob =
        static_cast<const bf16*>(a.dout) + hr.b * a.sdo.b + h * a.sdo.h;
    for (int j = lo; j < nq; ++j) {
      const int q0 = j * kTile;
      const int rows_q = min(kTile, a.Sq - q0);
      __syncthreads();  // the previous tile's readers are done
      rtt::copy_tile_bf16<kTile, DMAX, kThreads>(qb + q0 * a.sq.s, a.sq.s,
                                                 rows_q, D, q_s);
      rtt::copy_tile_bf16<kTile, DMAX, kThreads>(dob + q0 * a.sdo.s,
                                                 a.sdo.s, rows_q, D, do_s);
      if (threadIdx.x < kTile) {
        const bool in = int(threadIdx.x) < rows_q;
        lse_s[threadIdx.x] = in ? a.lse[bh * a.Sq + q0 + threadIdx.x] : 0.f;
        dl_s[threadIdx.x] = in ? a.delta[bh * a.Sq + q0 + threadIdx.x] : 0.f;
      }
      __syncthreads();

      // P^T = exp(K Q^T scale - lse), then dV += P^T dO.
      float p[NT][4], ds[NT][4];
      tile_product_nt<DMAX>(k_s, q_s, r0, g, t, D, p);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int hh2 = 0; hh2 < 2; ++hh2)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qc = n * 8 + 2 * t + e;
            const int i = 2 * hh2 + e;
            const bool ok = visible(a, q0 + qc, k0 + r0 + 8 * hh2);
            p[n][i] = ok ? expf(p[n][i] * a.scale - lse_s[qc]) : 0.f;
          }
      accumulate_tn<DMAX>(p, do_s, g, t, dv);

      // dS^T = P^T (V dO^T - delta), then dK += dS^T Q.
      tile_product_nt<DMAX>(v_s, do_s, r0, g, t, D, ds);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          ds[n][i] = p[n][i] * (ds[n][i] - dl_s[n * 8 + 2 * t + (i & 1)]);
      accumulate_tn<DMAX>(ds, q_s, g, t, dk);
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = k0 + r0 + 8 * hh;
    if (row >= a.Skv) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = n * 8 + 2 * t + e;
        if (d >= D) continue;
        store_dkv<bf16>(a, a.dk, a.sdk, hr.b, hr.hk, hr.h0, row, d,
                        dk[n][2 * hh + e] * a.scale);
        store_dkv<bf16>(a, a.dv, a.sdv, hr.b, hr.hk, hr.h0, row, d,
                        dv[n][2 * hh + e]);
      }
  }
}

// ---- launch -------------------------------------------------------------

template <typename Kernel>
cudaError_t launch_kernel(Kernel kernel, size_t smem, dim3 grid,
                          const BwdArgs& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(a);
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

template <int DMAX>
cudaError_t launch_mma(const BwdArgs& a, bool dq, cudaStream_t stream) {
  const dim3 grid = grid_for(a, dq, kTile);
  if (dq)
    return launch_kernel(flash_bwd_dq_mma_kernel<DMAX>,
                         mma_smem_bytes<DMAX>(), grid, a, stream);
  return launch_kernel(flash_bwd_dkv_mma_kernel<DMAX>, mma_smem_bytes<DMAX>(),
                       grid, a, stream);
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

template <typename T>
cudaError_t launch_for_type(const BwdArgs& a, bool dq, cudaStream_t stream) {
  // bf16 with aligned rows and D a multiple of 16 up to 128 (the 8B model's
  // shape) runs on the tensor cores; everything else on the CUDA cores.
  // The tensor-core kernels store bf16 outputs two at a time.
  if (std::is_same<T, __nv_bfloat16>::value && a.D % 16 == 0 &&
      a.D <= 128 && vector_rows<T>(a) && a.sdq.s % 2 == 0 &&
      a.sdq.b % 2 == 0 && a.sdq.h % 2 == 0) {
    if (a.D <= 64) return launch_mma<64>(a, dq, stream);
    return launch_mma<128>(a, dq, stream);
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

// Rows of a tile of either backward kernel at head dim D (1..256): the
// grid is (ceil(S / rows), heads).
extern "C" int rtt_flash_bwd_tile_rows(int D) {
  return tile_rows(D <= 64 ? 64 : D <= 128 ? 128 : 256);
}
