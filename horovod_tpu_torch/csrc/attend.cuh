// The parts shared by the two decode append+attend kernels
// (append_attend.cu, append_attend_int8.cu): the per-batch-row cover
// table of the one-hot merge, and the attention of one query row over
// the merged cache rows.
#pragma once

#include "common.cuh"

// Cover table of batch row b: for each cache row m < M, the first new
// row t with positions[b, t] == m (`first`) and how many new rows land
// on it (`count`). A position outside [0, M) lands nowhere, as the
// one-hot row of the plain version is all zero there. Every block of
// one batch row builds the same table, so all of them agree on which
// cache rows this call replaces.
__device__ __forceinline__ void build_cover(const int* __restrict__ pos_b,
                                            int T, int M, int* first,
                                            int* count) {
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    first[m] = INT_MAX;
    count[m] = 0;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    const int p = pos_b[t];
    if (p >= 0 && p < M) {
      atomicMin(&first[p], t);
      atomicAdd(&count[p], 1);
    }
  }
  __syncthreads();
}

// Threads per block. A decode step launches few blocks (B * H), so
// each gets 16 warps to keep enough rows in flight against memory
// latency; a prefill launches many (B * T * H), mostly short (causal),
// so each gets 4 warps and more of them stay resident on an SM.
constexpr int kMaxThreads = 512;
__host__ inline int attend_threads(int B, int T, int H) {
  return (long long)B * T * H >= 1024 ? 128 : kMaxThreads;
}

// Largest head_dim the kernels take: each lane of a warp handles
// kLanes = head_dim / 32 (rounded up to 2, 4 or 8) elements of a row,
// a compile-time count so its partial sums stay in registers.
constexpr int kMaxHeadDim = 256;

// Shared memory of one block, in floats: the cover table (2*M ints),
// q (D), logits/probabilities (M), one PV partial row per warp
// (warps*D) and reduction scratch (32).
__host__ __device__ __forceinline__ size_t attend_smem_floats(int M, int D,
                                                              int threads) {
  return 2 * (size_t)M + D + M + (size_t)(threads / 32) * D + 32;
}

// Attention of one query row (position p_t) over the merged cache rows:
//   logit[m] = round_T(q . k[m]) * scale    for m <= p_t, else -1e30
//   p        = round_T(softmax(logit))      (float32 softmax)
//   out      = round_T(sum_m p[m] * v[m])   (float32 accumulation)
// the rounding points of the plain version (models/transformer.py
// `cached_attention`). `krow(m, d)` / `vrow(m, d)` give element d of
// merged row m, already in the compute dtype. Rows above p_t have
// probability exactly 0, so the loops stop at p_t (all M rows stay in
// when p_t < 0 or p_t >= M, where the plain softmax covers them all).
//
// Both row loops give each warp one cache row at a time, its lanes
// across head_dim, so a warp's loads of a row are neighbouring
// addresses and every warp of the block has a row in flight.
template <int kLanes, typename TQ, typename KRows, typename VRows>
__device__ __forceinline__ void attend_row(const TQ* __restrict__ q_row,
                                           int D, int M, int p_t,
                                           float scale, const KRows& krow,
                                           const VRows& vrow, float* smem,
                                           TQ* __restrict__ out_row) {
  float* qs = smem + 2 * (size_t)M;
  float* lg = qs + D;
  float* part = lg + M;
  const int threads = blockDim.x;
  const int nwarps = threads >> 5;
  float* scratch = part + (size_t)nwarps * D;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int d = tid; d < D; d += threads) qs[d] = to_f32(q_row[d]);
  const int m_end = (p_t >= 0 && p_t < M) ? p_t + 1 : M;
  __syncthreads();

  // logits
  float mx = -INFINITY;
  for (int m = warp; m < m_end; m += nwarps) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      const int d = lane + 32 * j;
      if (d < D) acc = fmaf(qs[d], krow(m, d), acc);
    }
    acc = warp_sum(acc);
    const float l = (m <= p_t) ? __fmul_rn(round_to<TQ>(acc), scale)
                               : -1e30f;
    if (lane == 0) lg[m] = l;
    mx = fmaxf(mx, l);
  }
  mx = block_max(mx, scratch);

  float sum = 0.f;
  for (int m = tid; m < m_end; m += threads) {
    const float e = expf(__fsub_rn(lg[m], mx));
    lg[m] = e;
    sum += e;
  }
  sum = block_sum(sum, scratch);
  for (int m = tid; m < m_end; m += threads)
    lg[m] = round_to<TQ>(__fdiv_rn(lg[m], sum));
  __syncthreads();

  // PV: warp w sums rows w, w + warps, ...; the warps' partial rows
  // are then added in warp order
  float acc[kLanes];
#pragma unroll
  for (int j = 0; j < kLanes; ++j) acc[j] = 0.f;
  for (int m = warp; m < m_end; m += nwarps) {
    const float p = lg[m];
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      const int d = lane + 32 * j;
      if (d < D) acc[j] = fmaf(p, vrow(m, d), acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    const int d = lane + 32 * j;
    if (d < D) part[(size_t)warp * D + d] = acc[j];
  }
  __syncthreads();
  for (int d = tid; d < D; d += threads) {
    float s = 0.f;
    for (int w = 0; w < nwarps; ++w) s += part[(size_t)w * D + d];
    out_row[d] = from_f32<TQ>(s);
  }
}

// Opt in to more than 48 KB of dynamic shared memory where needed.
template <typename Kernel>
__host__ inline cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}
