// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ray_tpu/ops/flash_attention.py
// `_flash_fwd_kernel` (launched by `_flash_fwd`). Same function: the
// flash-attention-2 forward with GQA (query head h reads KV head
// h / (H / Hkv)), causal masking in global coordinates
// (query i sits at q_offset + i, key j at kv_offset + j), and the
// per-row logsumexp the backward and ring attention need. A fully masked
// row gives O = 0 and lse = -1e30 (the Pallas kernel's l == 0 guard).
//
// Layout: q [B, Sq, H, D], k/v [B, Skv, Hkv, D], read through their batch,
// sequence and head strides (the last dimension is contiguous), so the
// wrapper never copies into the TPU kernel's [B*H, S, D] head-major form.
// o has q's layout; lse is [B*H, Sq] float32.
//
// What bounds it on the H100: causal attention over S keys does about
// S/2 flops per byte of Q/K/V/O it must move (bf16, D = 128, GQA 4:1):
// about 205 at S = 512, under the card's ~295 flops/byte, so at the 8B
// prefill buckets (S 128..512) the least time is set by bytes, and from
// S ~ 750 on by operations. Either way the score matrix must never reach
// device memory, which would multiply the bytes by ~S/D. The design keeps
// every intermediate on chip: one block owns a
// 64-row Q tile of one (batch, head) in shared memory, streams 64-row K/V
// tiles of its KV head through shared memory, and keeps the running max,
// denominator and the [64, D] accumulator in float registers (online
// softmax). Causal tiles past the diagonal are never loaded: the loop's
// upper bound comes from the global-coordinate causal rule.
//
// Two kernels compute this, chosen from the inputs at each launch:
// - bf16 with D a multiple of 16 up to 128 and 16-byte-aligned rows (the
//   8B model's prefill): `flash_fwd_mma_kernel`, both products on the
//   tensor cores (mma.sync m16n8k16, bf16 in, float accumulate; the
//   probabilities are rounded to bf16 for PV, as flash-attention-2 does).
//   Shared memory: three bf16 tiles [64][D+8], 52,224 bytes at D = 128.
// - everything else, float32 included (its parity checks must not see
//   bf16 or TF32 rounding): `flash_fwd_kernel`, scalar float FMAs on the
//   CUDA cores, each thread owning a 4 x 8 tile of scores and a 4 x Dmax/8
//   tile of the output. Shared memory: float Q and K tiles [64][Dmax+1],
//   a V tile [64][Dmax] and a [64][65] probability tile, 115,456 bytes at
//   Dmax = 128 and 213,760 at Dmax = 256.
// Both take tiles in as 16-byte loads, a batch per thread issued before any
// is stored, when strides and D allow it (else one element at a time).
// Above 48 KB of shared memory a launch needs the dynamic-shared-memory
// attribute, which the entry point sets before every launch. wgmma with
// TMA-fed tiles and a producer warp is the next step for speed.

#include <type_traits>

#include "common.cuh"

namespace {

using rtt::from_float;
using rtt::kPad;
using rtt::ld32;
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

// ---- bf16 on the tensor cores ------------------------------------------
//
// The same function for bf16 inputs with D a multiple of 16 and at most
// 128: each of the 4 warps owns 16 query rows of the 64-row tile, and QK^T
// and PV run as mma.sync m16n8k16 (bf16 in, float accumulate). The scores
// stay in the accumulator registers: the online softmax runs on them in
// place (a row's values sit in 4 neighbouring lanes), and the
// probabilities are repacked as bf16 A-fragments for PV without a trip
// through shared memory. Tiles sit in shared memory as bf16 with 8
// elements of row padding, which makes every fragment load conflict-free.

constexpr size_t mma_smem_bytes(int dmax) {
  return sizeof(__nv_bfloat16) * size_t(3 * kTile) * (dmax + kPad);
}

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                     int H, int Hkv, int Sq, int Skv, int D, int64_t q_sb,
                     int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,
                     int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
                     int64_t o_sb, int64_t o_ss, int64_t o_sh, float scale,
                     int causal, int q_offset, int kv_offset) {
  constexpr int PITCH = DMAX + kPad;
  constexpr int NT = kTile / 8;  // key n-tiles of the score tile
  constexpr int ND = DMAX / 8;   // column n-tiles of the output

  extern __shared__ float4 rtt_smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(rtt_smem);
  __nv_bfloat16* k_s = q_s + kTile * PITCH;
  __nv_bfloat16* v_s = k_s + kTile * PITCH;

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16 + g;  // this lane's rows: r0, r0 + 8
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * kBlockQ;

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + hk * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + hk * v_sh;
  rtt::copy_tile_bf16<kTile, DMAX, kThreads>(
      qb + q0 * q_ss, q_ss, min(kBlockQ, Sq - q0), D, q_s);

  const int nk = (Skv + kBlockK - 1) / kBlockK;
  int hi = nk;
  if (causal) {
    const int last_q = q_offset + min(q0 + kBlockQ, Sq) - 1;
    const int reach = last_q - kv_offset;
    hi = reach < 0 ? 0 : min(nk, reach / kBlockK + 1);
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int j = 0; j < hi; ++j) {
    const int k0 = j * kBlockK;
    __syncthreads();  // the previous tile's readers are done
    const int rows = min(kBlockK, Skv - k0);
    rtt::copy_tile_bf16<kTile, DMAX, kThreads>(kb + k0 * k_ss, k_ss, rows, D,
                                               k_s);
    rtt::copy_tile_bf16<kTile, DMAX, kThreads>(vb + k0 * v_ss, v_ss, rows, D,
                                               v_s);
    __syncthreads();

    // S = Q K^T for the warp's 16 rows x 64 keys.
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    for (int d0 = 0; d0 < D; d0 += 16) {
      const unsigned a[4] = {ld32(q_s + r0 * PITCH + d0 + 2 * t),
                             ld32(q_s + (r0 + 8) * PITCH + d0 + 2 * t),
                             ld32(q_s + r0 * PITCH + d0 + 8 + 2 * t),
                             ld32(q_s + (r0 + 8) * PITCH + d0 + 8 + 2 * t)};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const __nv_bfloat16* kr = k_s + (n * 8 + g) * PITCH + d0 + 2 * t;
        const unsigned bb[2] = {ld32(kr), ld32(kr + 8)};
        rtt::mma_16816_bf16(s[n], a, bb);
      }
    }

    // Online softmax on the accumulators: s[n][2*hh + e] is row r0 + 8*hh,
    // key k0 + 8n + 2t + e; a row's 64 keys sit in the 4 lanes of group g.
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int qpos = q_offset + q0 + r0 + 8 * hh;
      float mx = m[hh];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + n * 8 + 2 * t + e;
          const bool ok = col < Skv && (!causal || kv_offset + col <= qpos);
          const float x = ok ? s[n][2 * hh + e] * scale : kNegInf;
          s[n][2 * hh + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = rtt::group_max(mx, 4);
      const float alpha = expf(m[hh] - mx);
      float rs = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = s[n][2 * hh + e];
          const float p = x == kNegInf ? 0.f : expf(x - mx);
          s[n][2 * hh + e] = p;
          rs += p;
        }
      rs = rtt::group_sum(rs, 4);
      l[hh] = l[hh] * alpha + rs;
      m[hh] = mx;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[n][2 * hh] *= alpha;
        acc[n][2 * hh + 1] *= alpha;
      }
    }

    // acc += P V: the score accumulators of key n-tiles 2kk, 2kk+1 are the
    // A-fragment of keys 16kk .. 16kk+15.
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      const unsigned a[4] = {
          rtt::pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
          rtt::pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
          rtt::pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          rtt::pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const int key = kk * 16 + 2 * t;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const int col = n * 8 + g;
        const unsigned bb[2] = {rtt::ld_col_pair(v_s, key, col, PITCH),
                                rtt::ld_col_pair(v_s, key + 8, col, PITCH)};
        rtt::mma_16816_bf16(acc[n], a, bb);
      }
    }
  }

  __nv_bfloat16* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + r0 + 8 * hh;
    if (row >= Sq) continue;
    const float l_safe = l[hh] == 0.f ? 1.f : l[hh];
    const float inv = 1.f / l_safe;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int col = n * 8 + 2 * t;
      if (col < D)
        *reinterpret_cast<unsigned*>(ob + row * o_ss + col) = rtt::pack_bf16x2(
            acc[n][2 * hh] * inv, acc[n][2 * hh + 1] * inv);
    }
    if (t == 0) lse[int64_t(bh) * Sq + row] = m[hh] + logf(l_safe);
  }
}

template <int DMAX>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, int H, int Hkv, int Sq, int Skv,
                       int D, const int64_t* st, float scale, int causal,
                       int q_offset, int kv_offset, cudaStream_t stream) {
  auto kernel = flash_fwd_mma_kernel<DMAX>;
  const size_t smem = mma_smem_bytes(DMAX);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + kBlockQ - 1) / kBlockQ, B * H);
  using bf16 = __nv_bfloat16;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), H, Hkv, Sq, Skv, D, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], scale,
      causal, q_offset, kv_offset);
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
  // shape) runs on the tensor cores; everything else on the CUDA cores.
  if (std::is_same<T, __nv_bfloat16>::value && D % 16 == 0 && D <= 128 &&
      vector_rows<T>(q, k, v, D, st) &&
      reinterpret_cast<uintptr_t>(o) % 16 == 0 && st[9] % 8 == 0 &&
      st[10] % 8 == 0 && st[11] % 8 == 0) {
    if (D <= 64)
      return launch_mma<64>(q, k, v, o, lse, B, H, Hkv, Sq, Skv, D, st, scale,
                            causal, q_offset, kv_offset, stream);
    return launch_mma<128>(q, k, v, o, lse, B, H, Hkv, Sq, Skv, D, st, scale,
                           causal, q_offset, kv_offset, stream);
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
