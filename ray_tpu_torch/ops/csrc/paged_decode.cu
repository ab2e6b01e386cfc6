// Paged-attention decode for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ray_tpu/ops/paged_attention.py
// `_paged_decode_kernel` (:28, launched by `paged_decode_attention` at
// :135). Same function: one query token per slot attends, with GQA, over
// the keys at positions 0..lengths[b] of that slot, which live in a shared
// pool of fixed-size pages named by the slot's row of the page table. No
// gathered copy of the slot's keys is ever written to device memory.
//
// Layout: q [B, H, D]; pools [Hkv, P, page, D] (one layer; the wrapper
// passes a layer's view of an [L, Hkv, P, page, D] pool); page_table
// [B, Pmax] int32; lengths [B] int32; out [B, H, D]. Query head
// hk * rep + r belongs to KV head hk (rep = H / Hkv).
//
// What bounds it on the H100: decode reads every cached key and value of
// every active slot once and does 4 flops per element read, about 2
// flops per byte in bf16, far below the card's ~295. It is bound by
// bytes, and at the engine's sizes (a few MB a launch) by how many of them
// are in flight at once: every (slot, KV head) serves all `rep` query heads
// of its GQA group from one read of each K/V row, and the work has to be
// spread over enough blocks to keep every SM's loads in flight. Page ids
// are clamped into the pool, so an inactive slot (an all-zero table row)
// reads in bounds; pages past a slot's length are never read.
//
// Two kernels compute this, chosen from the inputs at each launch:
// - bf16 with D a multiple of 8 up to 256, rep 1, 2, 4 or 8 and pools, q
//   on 16-byte boundaries (the 8B engine's decode):
//   `paged_decode_split_kernel`, flash-decoding with the merge in the same
//   launch.
//   * The split. The grid is (B, Hkv, splits); the wrapper fixes `splits`
//     from B, Hkv, Pmax * page and the SM count (paged_attention.py:
//     paged_splits: two blocks an SM, at least 32 table tokens a split),
//     because the lengths live on the card and the host must not wait to
//     read them. Each block reads its slot's length and takes its share of
//     the slot's pages, pages [n s / splits, n (s + 1) / splits) of the
//     slot's n, so every slot's walk is spread over all of its blocks
//     whatever its length; a split with no page writes an empty partial
//     (max -inf, sum 0).
//   * The walk. A block reads its page ids once (one read a page, clamped)
//     into shared memory, then streams its tokens in chunks of 4 rows a
//     thread through a ring of kSplitStages = 3 stages of bf16 K and V rows
//     (16 KB a stage), copied 16 bytes at a time by cp.async, two chunks in
//     flight while one is used. A thread copies exactly the 16-byte columns
//     of the rows it later reads itself, so the ring needs no barrier: each
//     thread waits for its own copies. Scores are float FMAs on the bf16
//     pairs (a bf16 is the high half of a float) reduced over the D / 8
//     lanes of a row with shuffles: decode does ~2 flops a byte, so the
//     arithmetic only has to stay out of the way of the copies, and it needs
//     no padding of the 1-8 row query group to mma.sync's 16 rows. Each
//     thread keeps a running max and sum (log2 domain, the scale folded into
//     q) and a float accumulator for its rows and columns.
//   * The merge. The block merges its row groups in shared memory; with
//     splits > 1 it writes its float32 partial (max, sum, accumulator
//     [rep, D]) to the workspace, makes it visible (__threadfence), and
//     takes a ticket (atomicAdd on the counter of its (slot, KV head)). The
//     block that draws the last ticket merges every split's partial in
//     split order and writes the output, then resets the counter to 0 for
//     the next launch. The order never depends on which block arrives last,
//     so the result is bitwise the same from run to run, and a decode step
//     gains no launch. The wrapper keeps the workspace and the zeroed
//     counters across calls.
//   Shared memory: 3 stages of 16 KB (the merge reuses them) and the split's
//   page ids, 49,152 + 4 ceil(Pmax / splits) bytes.
// - everything else (float32, D not a multiple of 8, other group sizes,
//   pools off a 16-byte boundary): `paged_decode_kernel`, one block a
//   (slot, KV head) walking the whole slot in chunks of 64 tokens through
//   float shared memory with scalar float FMAs; it looks each token's page
//   id up on its own, so any page size works. K/V rows come in as 16-byte
//   loads, a batch of 8 per thread in flight, when the pool is aligned and
//   D is a multiple of the vector (else one element at a time).

#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

using rtt::from_float;
using rtt::kNegInf;
using rtt::to_float;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;  // tokens per shared-memory chunk
constexpr int kBatch = 4;   // 16-byte K and V loads per thread per batch

size_t paged_smem_bytes(int rep, int D) {
  return sizeof(int64_t) * kChunk +                  // row_s
         sizeof(float) * (size_t(rep) * D +          // q_s
                          size_t(kChunk) * (D + 1) +  // k_s
                          size_t(kChunk) * D +        // v_s
                          size_t(rep) * kChunk +      // p_s
                          size_t(rep) * D +           // acc_s
                          3 * size_t(rep));           // m_s, l_s, a_s
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool,
                    const int* __restrict__ page_table,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int H, int Hkv, int P, int page, int Pmax, int D,
                    float scale) {
  const int rep = H / Hkv;
  const int KS = D + 1;  // padded row pitch of k_s

  extern __shared__ float4 rtt_smem[];
  int64_t* row_s = reinterpret_cast<int64_t*>(rtt_smem);  // pool row offsets
  float* q_s = reinterpret_cast<float*>(row_s + kChunk);
  float* k_s = q_s + rep * D;
  float* v_s = k_s + kChunk * KS;
  float* p_s = v_s + kChunk * D;
  float* acc_s = p_s + rep * kChunk;
  float* m_s = acc_s + rep * D;
  float* l_s = m_s + rep;
  float* a_s = l_s + rep;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x;
  const int hk = blockIdx.y;

  // Keys at positions 0..length attend (the new token already sits at
  // position length); never more than the table can name.
  const int length = lengths[b];
  const int n_keys = length < 0 ? 0 : min(length + 1, Pmax * page);

  const T* qb = q + (int64_t(b) * H + int64_t(hk) * rep) * D;
  for (int idx = tid; idx < rep * D; idx += kThreads) {
    q_s[idx] = to_float(qb[idx]) * scale;
    acc_s[idx] = 0.f;
  }
  for (int r = tid; r < rep; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  const int64_t head_off = int64_t(hk) * P * page * D;
  const T* kh = k_pool + head_off;
  const T* vh = v_pool + head_off;
  const int* pt = page_table + int64_t(b) * Pmax;

  for (int c0 = 0; c0 < n_keys; c0 += kChunk) {
    const int n = min(kChunk, n_keys - c0);
    __syncthreads();  // the previous chunk's readers are done
    for (int t = tid; t < kChunk; t += kThreads) {
      int64_t off = -1;  // past the slot's length: zero-filled
      if (t < n) {
        const int tok = c0 + t;
        const int pid = min(max(pt[tok / page], 0), P - 1);
        off = (int64_t(pid) * page + tok % page) * D;
      }
      row_s[t] = off;
    }
    __syncthreads();
    if constexpr (VEC) {
      constexpr int E = rtt::kVec<T>;
      const int vpr = D / E;  // vectors per row
      const int nv = kChunk * vpr;
      for (int i0 = tid; i0 < nv; i0 += kThreads * kBatch) {
        uint4 kr[kBatch], vr[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int i = i0 + u * kThreads;
          kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
          const int64_t off = i < nv ? row_s[i / vpr] : -1;
          if (off >= 0) {
            const int c = (i % vpr) * E;
            kr[u] = rtt::load16(kh + off + c);
            vr[u] = rtt::load16(vh + off + c);
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int i = i0 + u * kThreads;
          if (i >= nv) continue;
          const int t = i / vpr;
          const int c = (i % vpr) * E;
          float f[E];
          rtt::unpack16<T>(kr[u], f);
#pragma unroll
          for (int e = 0; e < E; ++e) k_s[t * KS + c + e] = f[e];
          rtt::unpack16<T>(vr[u], f);
#pragma unroll
          for (int e = 0; e < E; ++e) v_s[t * D + c + e] = f[e];
        }
      }
    } else {
      for (int idx = tid; idx < kChunk * D; idx += kThreads) {
        const int t = idx / D;
        const int d = idx % D;
        const int64_t off = row_s[t];
        k_s[t * KS + d] = off >= 0 ? to_float(kh[off + d]) : 0.f;
        v_s[t * D + d] = off >= 0 ? to_float(vh[off + d]) : 0.f;
      }
    }
    __syncthreads();

    // Scores of every query row of the group against the chunk.
    for (int idx = tid; idx < rep * kChunk; idx += kThreads) {
      const int r = idx / kChunk;
      const int t = idx % kChunk;
      float s = kNegInf;
      if (t < n) {
        s = 0.f;
        const float* qr = q_s + r * D;
        const float* kr = k_s + t * KS;
        for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      }
      p_s[idx] = s;
    }
    __syncthreads();

    // Online softmax, one warp per query row.
    for (int r = warp; r < rep; r += kWarps) {
      const float m_old = m_s[r];
      float mx = m_old;
      for (int t = lane; t < n; t += 32) mx = fmaxf(mx, p_s[r * kChunk + t]);
      mx = rtt::group_max(mx, 32);
      float sum = 0.f;
      for (int t = lane; t < kChunk; t += 32) {
        const float p = t < n ? expf(p_s[r * kChunk + t] - mx) : 0.f;
        p_s[r * kChunk + t] = p;
        sum += p;
      }
      sum = rtt::group_sum(sum, 32);
      if (lane == 0) {
        const float alpha = expf(m_old - mx);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = mx;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V.
    for (int idx = tid; idx < rep * D; idx += kThreads) {
      const int r = idx / D;
      const int d = idx % D;
      float a = acc_s[idx] * a_s[r];
      const float* pr = p_s + r * kChunk;
      for (int t = 0; t < n; ++t) a = fmaf(pr[t], v_s[t * D + d], a);
      acc_s[idx] = a;
    }
  }
  __syncthreads();

  T* ob = out + (int64_t(b) * H + int64_t(hk) * rep) * D;
  for (int idx = tid; idx < rep * D; idx += kThreads) {
    const float l = l_s[idx / D];
    ob[idx] = from_float<T>(acc_s[idx] / (l == 0.f ? 1.f : l));
  }
}

template <typename T, bool VEC>
cudaError_t launch_kernel(const void* q, const void* k_pool,
                          const void* v_pool, const void* page_table,
                          const void* lengths, void* out, int B, int H,
                          int Hkv, int P, int page, int Pmax, int D,
                          float scale, cudaStream_t stream) {
  auto kernel = paged_decode_kernel<T, VEC>;
  const size_t smem = paged_smem_bytes(H / Hkv, D);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(B, Hkv);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(page_table),
      static_cast<const int*>(lengths), static_cast<T*>(out), H, Hkv, P,
      page, Pmax, D, scale);
  return cudaGetLastError();
}

// ---- bf16: the page walk split across blocks, merged in the launch ------

namespace sm90 = rtt::sm90;

constexpr int kSplitThreads = 128;
constexpr int kSplitStages = 3;
constexpr int kRowsPerThread = 4;  // rows of a chunk each thread copies
constexpr int kSplitMaxSmem = 232448;  // what a block may use on the H100

// A thread owns one 16-byte column chunk c (d = 8c .. 8c + 7) of the rows
// grp + kGroups u of every chunk (u < kRowsPerThread): kLanes threads, the
// consecutive lanes of one warp, share a row.
template <int DMAX>
struct SplitShape {
  static constexpr int kLanes = DMAX / 8;
  static constexpr int kGroups = kSplitThreads / kLanes;
  static constexpr int kChunk = kGroups * kRowsPerThread;  // tokens a stage
  static constexpr int kHalf = kChunk * DMAX * 2;          // K (or V) bytes
  static constexpr int kStageBytes = 2 * kHalf;
};

__host__ __device__ constexpr size_t split_ring_bytes() {
  return size_t(kSplitStages) * SplitShape<128>::kStageBytes;
}
static_assert(SplitShape<64>::kStageBytes == SplitShape<128>::kStageBytes &&
                  SplitShape<256>::kStageBytes ==
                      SplitShape<128>::kStageBytes,
              "16 KB a stage at every width");

// The merge over row groups reuses the ring: [kGroups][REP] maxima and sums
// and [kGroups][REP][DMAX] accumulators.
template <int DMAX, int REP>
__host__ __device__ constexpr size_t split_scratch_bytes() {
  return sizeof(float) * size_t(SplitShape<DMAX>::kGroups) * REP * (DMAX + 2);
}

size_t split_smem_bytes(int Pmax, int splits) {
  return split_ring_bytes() +
         sizeof(int) * size_t((Pmax + splits - 1) / splits);
}

// One workspace partial: per query row of the group, its max, its sum and
// its D accumulator floats.
__host__ __device__ constexpr int64_t partial_floats(int rep, int D) {
  return int64_t(rep) * (D + 2);
}

template <int DMAX, int REP>
__global__ void __launch_bounds__(kSplitThreads)
paged_decode_split_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k_pool,
                   const __nv_bfloat16* __restrict__ v_pool,
                   const int* __restrict__ page_table,
                   const int* __restrict__ lengths,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ ws,
                   int* __restrict__ counters, int H, int Hkv, int P,
                   int page, int Pmax, int D, float scale, int splits) {
  using bf16 = __nv_bfloat16;
  using S = SplitShape<DMAX>;
  static_assert(split_scratch_bytes<DMAX, REP>() <= split_ring_bytes(),
                "the merge fits in the ring");
  extern __shared__ float4 rtt_smem[];
  char* smem = reinterpret_cast<char*>(rtt_smem);
  int* ids_s = reinterpret_cast<int*>(smem + split_ring_bytes());
  __shared__ int last_s;

  const int tid = threadIdx.x;
  const int c = tid % S::kLanes;
  const int grp = tid / S::kLanes;
  const int b = blockIdx.x;
  const int hk = blockIdx.y;
  const int split = blockIdx.z;
  const float neg_inf = __int_as_float(0xff800000);

  // This split's pages of the slot's n: [n split / splits, n (split + 1) /
  // splits); keys at positions 0..length attend (the new token already
  // sits at position length), never more than the table can name.
  const int length = lengths[b];
  const int n_keys = length < 0 ? 0 : min(length + 1, Pmax * page);
  const int n_pages = (n_keys + page - 1) / page;
  const int p_lo = int(int64_t(n_pages) * split / splits);
  const int p_hi = int(int64_t(n_pages) * (split + 1) / splits);
  const int t_lo = p_lo * page;
  const int t_hi = min(p_hi * page, n_keys);
  const int n_chunks = max(0, t_hi - t_lo + S::kChunk - 1) / S::kChunk;
  const int* pt = page_table + int64_t(b) * Pmax;
  for (int i = tid; i < p_hi - p_lo; i += kSplitThreads)
    ids_s[i] = min(max(pt[p_lo + i], 0), P - 1);

  // The group's query rows at this thread's 8 columns, times scale log2(e):
  // the scores come out in log2 units.
  const bool col_in = 8 * c < D;
  float qf[REP][8];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (col_in)
      raw = rtt::load16(q + (int64_t(b) * H + int64_t(hk) * REP + r) * D +
                        8 * c);
    rtt::unpack16<bf16>(raw, qf[r]);
#pragma unroll
    for (int e = 0; e < 8; ++e) qf[r][e] *= scale * 1.4426950408889634f;
  }
  __syncthreads();  // the page ids are in

  const int64_t head = int64_t(hk) * P * page * D;
  const bf16* kh = k_pool + head;
  const bf16* vh = v_pool + head;
  const uint32_t ring = sm90::smem_addr(smem);
  // Chunk ch: this thread's rows into stage ch % kSplitStages, zero-filled
  // past the split's last token and past D.
  auto fetch = [&](int ch) {
    const uint32_t st = ring + (ch % kSplitStages) * S::kStageBytes;
#pragma unroll
    for (int u = 0; u < kRowsPerThread; ++u) {
      const int rw = grp + S::kGroups * u;
      const int tok = t_lo + ch * S::kChunk + rw;
      const bool in = tok < t_hi && col_in;
      const int64_t off =
          in ? (int64_t(ids_s[tok / page - p_lo]) * page + tok % page) * D +
                   8 * c
             : 0;
      const uint32_t dst = st + (rw * DMAX + 8 * c) * 2;
      sm90::cp_async16(dst, kh + off, in ? 16 : 0);
      sm90::cp_async16(dst + S::kHalf, vh + off, in ? 16 : 0);
    }
  };

  float m[REP], l[REP], acc[REP][8];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = neg_inf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < kSplitStages - 1; ++i) {
    if (i < n_chunks) fetch(i);
    sm90::cp_async_commit();
  }
  for (int ch = 0; ch < n_chunks; ++ch) {
    if (ch + kSplitStages - 1 < n_chunks) fetch(ch + kSplitStages - 1);
    sm90::cp_async_commit();
    sm90::cp_async_wait<kSplitStages - 1>();  // chunk ch: this thread's rows
    const char* st = smem + (ch % kSplitStages) * S::kStageBytes;

    float s[kRowsPerThread][REP];
#pragma unroll
    for (int u = 0; u < kRowsPerThread; ++u) {
      const int rw = grp + S::kGroups * u;
      float kf[8];
      rtt::unpack16<bf16>(
          *reinterpret_cast<const uint4*>(st + (rw * DMAX + 8 * c) * 2), kf);
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        float x = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) x = fmaf(qf[r][e], kf[e], x);
        s[u][r] = rtt::group_sum(x, S::kLanes);
      }
    }
    const int tok0 = t_lo + ch * S::kChunk;
    if (tok0 + S::kChunk > t_hi) {  // the split's ragged end
#pragma unroll
      for (int u = 0; u < kRowsPerThread; ++u)
        if (tok0 + grp + S::kGroups * u >= t_hi)
#pragma unroll
          for (int r = 0; r < REP; ++r) s[u][r] = neg_inf;
    }
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      float mx = m[r];
#pragma unroll
      for (int u = 0; u < kRowsPerThread; ++u) mx = fmaxf(mx, s[u][r]);
      const float mu = mx == neg_inf ? 0.f : mx;  // no -inf - -inf
      const float alpha = sm90::exp2_approx(m[r] - mu);
      m[r] = mx;
      float ps = 0.f;
#pragma unroll
      for (int u = 0; u < kRowsPerThread; ++u) {
        s[u][r] = sm90::exp2_approx(s[u][r] - mu);
        ps += s[u][r];
      }
      l[r] = l[r] * alpha + ps;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[r][e] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < kRowsPerThread; ++u) {
      const int rw = grp + S::kGroups * u;
      float vf[8];
      rtt::unpack16<bf16>(*reinterpret_cast<const uint4*>(
                              st + S::kHalf + (rw * DMAX + 8 * c) * 2),
                          vf);
#pragma unroll
      for (int r = 0; r < REP; ++r)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[r][e] = fmaf(s[u][r], vf[e], acc[r][e]);
    }
  }
  sm90::cp_async_wait<0>();
  __syncthreads();  // every thread is done with the ring: reuse it

  // Merge the row groups in group order: grp's max, sum, accumulator.
  float* gm = reinterpret_cast<float*>(smem);  // [kGroups][REP]
  float* gl = gm + S::kGroups * REP;           // [kGroups][REP]
  float* ga = gl + S::kGroups * REP;           // [kGroups][REP][DMAX]
  if (c == 0) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      gm[grp * REP + r] = m[r];
      gl[grp * REP + r] = l[r];
    }
  }
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    float4* dst =
        reinterpret_cast<float4*>(ga + (grp * REP + r) * DMAX + 8 * c);
    dst[0] = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    dst[1] = make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
  }
  __syncthreads();

  const int pair = b * Hkv + hk;
  bf16* ob = out + (int64_t(b) * H + int64_t(hk) * REP) * D;
  float* part = ws + (int64_t(pair) * splits + split) * partial_floats(REP, D);
  for (int i = tid; i < REP * D; i += kSplitThreads) {
    const int r = i / D;
    const int d = i % D;
    float mx = neg_inf;
    for (int gi = 0; gi < S::kGroups; ++gi) mx = fmaxf(mx, gm[gi * REP + r]);
    const float mu = mx == neg_inf ? 0.f : mx;
    float sum = 0.f, o = 0.f;
    for (int gi = 0; gi < S::kGroups; ++gi) {
      const float w = sm90::exp2_approx(gm[gi * REP + r] - mu);
      sum += w * gl[gi * REP + r];
      o += w * ga[(gi * REP + r) * DMAX + d];
    }
    if (splits == 1) {
      ob[r * D + d] = __float2bfloat16(sum == 0.f ? 0.f : o / sum);
    } else {
      if (d == 0) {
        part[r * (D + 2)] = mx;
        part[r * (D + 2) + 1] = sum;
      }
      part[r * (D + 2) + 2 + d] = o;
    }
  }
  if (splits == 1) return;

  // The ticket: the partial is visible before the counter moves; the block
  // that draws the last ticket merges.
  __threadfence();
  __syncthreads();
  if (tid == 0) last_s = atomicAdd(counters + pair, 1) == splits - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  const float* parts = ws + int64_t(pair) * splits * partial_floats(REP, D);
  for (int i = tid; i < REP * D; i += kSplitThreads) {
    const int r = i / D;
    const int d = i % D;
    float mx = neg_inf;
    for (int sp = 0; sp < splits; ++sp)
      mx = fmaxf(mx, __ldcg(parts + sp * partial_floats(REP, D) + r * (D + 2)));
    const float mu = mx == neg_inf ? 0.f : mx;
    float sum = 0.f, o = 0.f;
    for (int sp = 0; sp < splits; ++sp) {
      const float* pr = parts + sp * partial_floats(REP, D) + r * (D + 2);
      const float w = sm90::exp2_approx(__ldcg(pr) - mu);
      sum += w * __ldcg(pr + 1);
      o += w * __ldcg(pr + 2 + d);
    }
    ob[r * D + d] = __float2bfloat16(sum == 0.f ? 0.f : o / sum);
  }
  if (tid == 0) counters[pair] = 0;  // ready for the next launch
}

template <int DMAX, int REP>
cudaError_t launch_split(const void* q, const void* k_pool,
                         const void* v_pool, const void* page_table,
                         const void* lengths, void* out, int B, int H,
                         int Hkv, int P, int page, int Pmax, int D,
                         float scale, int splits, void* ws, void* counters,
                         cudaStream_t stream) {
  auto kernel = paged_decode_split_kernel<DMAX, REP>;
  const size_t smem = split_smem_bytes(Pmax, splits);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  using bf16 = __nv_bfloat16;
  kernel<<<dim3(B, Hkv, splits), kSplitThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_pool),
      static_cast<const bf16*>(v_pool), static_cast<const int*>(page_table),
      static_cast<const int*>(lengths), static_cast<bf16*>(out),
      static_cast<float*>(ws), static_cast<int*>(counters), H, Hkv, P, page,
      Pmax, D, scale, splits);
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t launch_split_rep(int rep, const void* q, const void* k_pool,
                             const void* v_pool, const void* page_table,
                             const void* lengths, void* out, int B, int H,
                             int Hkv, int P, int page, int Pmax, int D,
                             float scale, int splits, void* ws,
                             void* counters, cudaStream_t stream) {
  switch (rep) {
    case 1:
      return launch_split<DMAX, 1>(q, k_pool, v_pool, page_table, lengths,
                                   out, B, H, Hkv, P, page, Pmax, D, scale,
                                   splits, ws, counters, stream);
    case 2:
      return launch_split<DMAX, 2>(q, k_pool, v_pool, page_table, lengths,
                                   out, B, H, Hkv, P, page, Pmax, D, scale,
                                   splits, ws, counters, stream);
    case 4:
      return launch_split<DMAX, 4>(q, k_pool, v_pool, page_table, lengths,
                                   out, B, H, Hkv, P, page, Pmax, D, scale,
                                   splits, ws, counters, stream);
    default:
      return launch_split<DMAX, 8>(q, k_pool, v_pool, page_table, lengths,
                                   out, B, H, Hkv, P, page, Pmax, D, scale,
                                   splits, ws, counters, stream);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Whether a launch takes the split kernel (see the note at the top).
template <typename T>
bool split_path(const void* q, const void* k_pool, const void* v_pool,
                int H, int Hkv, int Pmax, int D, int splits) {
  const int rep = H / Hkv;
  return std::is_same<T, __nv_bfloat16>::value && D % 8 == 0 &&
         (rep == 1 || rep == 2 || rep == 4 || rep == 8) && aligned16(q) &&
         aligned16(k_pool) && aligned16(v_pool) &&
         split_smem_bytes(Pmax, splits) <= kSplitMaxSmem;
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* page_table, const void* lengths, void* out,
                   int B, int H, int Hkv, int P, int page, int Pmax, int D,
                   float scale, int splits, void* ws, void* counters,
                   cudaStream_t stream) {
  if (split_path<T>(q, k_pool, v_pool, H, Hkv, Pmax, D, splits)) {
    if (splits > 1 && (ws == nullptr || counters == nullptr))
      return cudaErrorInvalidValue;
    auto run = [&](auto launcher) {
      return launcher(H / Hkv, q, k_pool, v_pool, page_table, lengths, out,
                      B, H, Hkv, P, page, Pmax, D, scale, splits, ws,
                      counters, stream);
    };
    if (D <= 64) return run(launch_split_rep<64>);
    if (D <= 128) return run(launch_split_rep<128>);
    return run(launch_split_rep<256>);
  }
  // 16-byte loads need every pool row on a 16-byte boundary.
  if (D % rtt::kVec<T> == 0 && aligned16(k_pool) && aligned16(v_pool))
    return launch_kernel<T, true>(q, k_pool, v_pool, page_table, lengths, out,
                                  B, H, Hkv, P, page, Pmax, D, scale, stream);
  return launch_kernel<T, false>(q, k_pool, v_pool, page_table, lengths, out,
                                 B, H, Hkv, P, page, Pmax, D, scale, stream);
}

}  // namespace

// splits: blocks each (slot, KV head) walk is split across (>= 1); ws and
// counters: the split kernel's float32 workspace of B * Hkv * splits *
// (H / Hkv) * (D + 2) floats and B * Hkv int32 counters, all zero before
// the first launch (each launch leaves them zero). The other kernel ignores
// the three. Returns a cudaError_t (0 on success).
extern "C" int rtt_paged_decode(int dtype, const void* q, const void* k_pool,
                                const void* v_pool, const void* page_table,
                                const void* lengths, void* out, int B, int H,
                                int Hkv, int P, int page, int Pmax, int D,
                                float scale, void* stream, int splits,
                                void* ws, void* counters) {
  if (D < 1 || D > 256 || Hkv < 1 || H % Hkv != 0 || P < 1 || page < 1 ||
      Pmax < 1 || Hkv > 65535 || splits < 1 || splits > 65535)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rtt::kFloat32)
    return int(launch<float>(q, k_pool, v_pool, page_table, lengths, out, B,
                             H, Hkv, P, page, Pmax, D, scale, splits, ws,
                             counters, s));
  if (dtype == rtt::kBFloat16)
    return int(launch<__nv_bfloat16>(q, k_pool, v_pool, page_table, lengths,
                                     out, B, H, Hkv, P, page, Pmax, D, scale,
                                     splits, ws, counters, s));
  return int(cudaErrorInvalidValue);
}

