// Helpers shared by the port's hand-written Hopper kernels.
//
// Every kernel takes its element type as a template parameter (float or
// __nv_bfloat16), converts to float on load, accumulates in float and
// converts back on store. Dynamic shared memory is declared once per
// kernel as `extern __shared__ float4 rtt_smem[];` (float4 gives 16-byte
// alignment) and carved into float arrays by the kernel.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rtt {

// dtype codes shared with the Python wrappers (ops/_build.py DTYPE_CODES).
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

constexpr float kNegInf = -1e30f;  // the Pallas kernels' _NEG_INF

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16-byte vector loads: kVec<T> elements per load. A kernel loads a batch
// of these per thread before it stores any, so several loads are in flight
// at once instead of one element at a time.
template <typename T>
constexpr int kVec = 16 / int(sizeof(T));

template <typename T>
__device__ __forceinline__ uint4 load16(const T* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// The kVec<T> elements of a 16-byte load, as floats (bf16 is the high half
// of a float, so the conversion is a shift).
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& r, float* out);
template <>
__device__ __forceinline__ void unpack16<float>(const uint4& r, float* out) {
  out[0] = __uint_as_float(r.x);
  out[1] = __uint_as_float(r.y);
  out[2] = __uint_as_float(r.z);
  out[3] = __uint_as_float(r.w);
}
template <>
__device__ __forceinline__ void unpack16<__nv_bfloat16>(const uint4& r,
                                                        float* out) {
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Copies rows [0, rows) of a ROWS x DMAX tile (source row stride `stride`
// elements) into shared memory as float times `mul`, with row pitch
// `pitch`; rows past `rows` and columns past D are zero. VEC: 16-byte
// loads, a batch per thread issued before any is stored, which needs
// 16-byte-aligned rows and D a multiple of kVec<T>; else one element at a
// time.
template <typename T, int ROWS, int DMAX, int THREADS, bool VEC>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          int64_t stride, int rows, int D,
                                          float mul, float* dst, int pitch) {
  const int tid = threadIdx.x;
  if constexpr (VEC) {
    constexpr int E = kVec<T>;
    constexpr int VPR = DMAX / E;  // vectors per row
    constexpr int PER = ROWS * VPR / THREADS;
    constexpr int BATCH = PER < 8 ? PER : 8;
    static_assert(PER % BATCH == 0, "whole batches");
    for (int b0 = 0; b0 < PER; b0 += BATCH) {
      uint4 raw[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int i = (b0 + u) * THREADS + tid;
        const int r = i / VPR;
        const int c = (i % VPR) * E;
        raw[u] = (r < rows && c < D) ? load16(src + r * stride + c)
                                     : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int i = (b0 + u) * THREADS + tid;
        const int r = i / VPR;
        const int c = (i % VPR) * E;
        float f[E];
        unpack16<T>(raw[u], f);
#pragma unroll
        for (int e = 0; e < E; ++e) dst[r * pitch + c + e] = f[e] * mul;
      }
    }
  } else {
    for (int idx = tid; idx < ROWS * DMAX; idx += THREADS) {
      const int r = idx / DMAX;
      const int d = idx % DMAX;
      float x = 0.f;
      if (r < rows && d < D) x = to_float(src[r * stride + d]) * mul;
      dst[r * pitch + d] = x;
    }
  }
}

// Two floats rounded to bf16 in one register, the lower index in the low
// half.
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  return unsigned(__bfloat16_as_ushort(__float2bfloat16(lo))) |
         (unsigned(__bfloat16_as_ushort(__float2bfloat16(hi))) << 16);
}

// Reductions over `width` consecutive lanes (width a power of two <= 32);
// every lane of the group gets the result.
__device__ __forceinline__ float group_max(float v, int width) {
  for (int o = width / 2; o > 0; o /= 2)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float group_sum(float v, int width) {
  for (int o = width / 2; o > 0; o /= 2)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace rtt
