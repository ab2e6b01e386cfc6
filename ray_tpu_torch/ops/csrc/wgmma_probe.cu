// A check of the wgmma building blocks (wgmma.cuh) in each operand form the
// flash-attention backward kernels use, for the card tests: two warpgroups,
// one 128 x D tile and two 64 x D tiles copied by cp.async into the
// swizzled layout, then
//   S = A B^T          wgmma SS m64n64k16, both K-major, warpgroup w taking
//                      rows 64w .. 64w + 63 of A (as the kernels' K and Q)
//   C = bf16(S) V      wgmma RS m64nDk16, S's accumulators as the register
//                      A operand, V MN-major (as dV += P^T dO, dQ += dS K)
// and writes S and C in float32. The test holds them against torch.matmul.
// Not on any training or serving path.

#include "wgmma.cuh"

namespace {

namespace sm90 = rtt::sm90;

constexpr int kThreads = 256;

template <int DMAX>
__global__ void __launch_bounds__(kThreads, 1)
    wgmma_probe_kernel(const __nv_bfloat16* a, const __nv_bfloat16* b,
                       const __nv_bfloat16* v, float* s_out, float* c_out,
                       int D) {
  constexpr int AT = sm90::SwTile<128, DMAX>::kBytes;
  constexpr int BT = sm90::SwTile<64, DMAX>::kBytes;
  extern __shared__ float4 rtt_smem[];
  const uint32_t a_s = (sm90::smem_addr(rtt_smem) + 1023) & ~1023u;
  const uint32_t b_s = a_s + AT;
  const uint32_t v_s = b_s + BT;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;

  sm90::cp_async_tile<128, DMAX, kThreads>(a, D, 128, D, a_s, tid);
  sm90::cp_async_tile<64, DMAX, kThreads>(b, D, 64, D, b_s, tid);
  sm90::cp_async_tile<64, DMAX, kThreads>(v, D, 64, D, v_s, tid);
  sm90::cp_async_commit();
  sm90::cp_async_wait<0>();
  sm90::fence_async_smem();
  __syncthreads();

  float s[32], c[DMAX / 2];
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DMAX / 16; ++kk)
    sm90::wgmma_ss_m64n64k16(s, sm90::desc_kmajor<128>(a_s, 64 * wg, kk),
                             sm90::desc_kmajor<64>(b_s, 0, kk), kk > 0);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_operand(s);

  uint32_t frag[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) sm90::a_fragment(s, kk, frag[kk]);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    sm90::wgmma_rs<DMAX>(c, frag[kk], sm90::desc_mnmajor<64>(v_s, kk),
                         kk > 0);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_operand(c);

  const int row = 64 * wg + 16 * warp + g;
#pragma unroll
  for (int n = 0; n < 32; ++n)
    s_out[(row + 8 * ((n >> 1) & 1)) * 64 + 8 * (n >> 2) + 2 * t + (n & 1)] =
        s[n];
#pragma unroll
  for (int n = 0; n < DMAX / 2; ++n) {
    const int col = 8 * (n >> 2) + 2 * t + (n & 1);
    if (col < D) c_out[(row + 8 * ((n >> 1) & 1)) * D + col] = c[n];
  }
}

template <int DMAX>
cudaError_t launch_probe(const void* a, const void* b, const void* v,
                         float* s, float* c, int D, cudaStream_t stream) {
  const size_t smem = 1024 + sm90::SwTile<128, DMAX>::kBytes +
                      2 * sm90::SwTile<64, DMAX>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      wgmma_probe_kernel<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  wgmma_probe_kernel<DMAX><<<1, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(b),
      static_cast<const __nv_bfloat16*>(v), s, c, D);
  return cudaGetLastError();
}

}  // namespace

// a [128, D], b [64, D], v [64, D] contiguous bf16; s [128, 64] and
// c [128, D] float32, D a multiple of 16 up to 128. Returns a cudaError_t.
extern "C" int rtt_wgmma_probe(const void* a, const void* b, const void* v,
                               void* s, void* c, int D, void* stream) {
  if (D < 16 || D > 128 || D % 16 != 0) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* sf = static_cast<float*>(s);
  float* cf = static_cast<float*>(c);
  if (D <= 64) return int(launch_probe<64>(a, b, v, sf, cf, D, st));
  return int(launch_probe<128>(a, b, v, sf, cf, D, st));
}
