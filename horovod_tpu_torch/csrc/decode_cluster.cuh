// The decode route shared by the two append+attend kernels
// (append_attend.cu B16, append_attend_int8.cu B17): one thread-block
// cluster per (batch row, kv head), for bf16 compute and fewer than
// kPrefillMinT new rows a batch row.
//
// A decode step has too few (batch row, head) pairs to fill the card
// with a block each, and each block's rows are a latency chain. One
// cluster of C CTAs per (batch row, kv head), C the least of 1, 2, 4, 8
// with B * KH * C >= the SM count (8 where none reaches it). Each CTA
// owns one contiguous span of the rows [0, R), R the batch row's last
// valid row + 1, and serves every query row and every query head of the
// kv group, so K and V are read once per group, 16 bytes a lane, at
// least 16 rows in flight a warp. Logits stay in shared memory; the CTAs
// exchange each query's maximum and then its sum through distributed
// shared memory, added in rank order, so every CTA rounds P where the
// plain version does; P.V partial rows are summed in rank order by rank
// 0, which writes the output. No atomics: the result does not vary from
// run to run. The CTA that owns a replaced row writes it.
//
// The kernel touches the cache only through its row policy `Rows`, a
// template parameter, which says how a lane's 16 bytes of a merged row
// are loaded and turned into compute-dtype values, what it stages in
// shared memory before the row loops, and how the replaced rows are
// written:
//
//   struct Rows {
//     struct Cache;               // kernel argument: the layer's buffers
//     struct Load;                // one lane's raw chunk of a row
//     static constexpr int kVec;  // elements of one lane's load
//     static size_t smem_words(int T, int D, const Cache&);  // host
//     Rows(const Cache&, const DecodeSlot&);
//     Side k, v;  // fetch(Load&, j, j_end, d0), values(v[kVec], Load, j, d0)
//     void stage(int s0, int s1) const;  // every thread; ends in a barrier
//     void write(int s0, int s1) const;  // the replaced rows of [s0, s1)
//   };
//
// `fetch` issues the load and `values` consumes it, so a warp has all
// its loads of a round in flight before it uses any.
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "attend.cuh"

// routes, as the entry points report them (ops/decode_attention.py ROUTES)
enum Route : int { kRouteCudaCores = 0, kRoutePrefill = 1, kRouteDecode = 2 };

constexpr int kPrefillMinT = 16;  // new rows from which B16 takes prefill
constexpr int kMaxCluster = 8;    // CTAs of a decode cluster, at most
constexpr int kDecodeThreads = 256;
constexpr int kDecodeWarps = kDecodeThreads / 32;
constexpr int kQueryGroup = 4;    // queries one P.V sweep accumulates
// dynamic shared memory a block may take, room left for static
constexpr size_t kMaxSmem = 232448 - 4096;

// One past the last merged row query position p reads.
__device__ __forceinline__ int row_end(int p, int M) {
  return (p >= 0 && p < M) ? p + 1 : M;
}

// Logit of a row j < row_end(p) from its float32 dot product.
__device__ __forceinline__ float logit(float dot, int j, int p,
                                       float scale) {
  return j <= p ? __fmul_rn(round_to<__nv_bfloat16>(dot), scale) : -1e30f;
}

// The (batch row, kv head) of a decode cluster, as its row policy sees
// it: the new rows (row t at kn + t * stride_t), the positions, the
// cover table and the policy's own shared memory.
struct DecodeSlot {
  const __nv_bfloat16* kn;
  const __nv_bfloat16* vn;
  int stride_t;
  const int* pos_b;  // [T]
  const int* first;  // [M]
  const int* count;  // [M]
  int T, M, D, b, kh;
  void* smem;        // Rows::smem_words words, 16-byte aligned
};

template <typename Rows, int D>
struct DecodeShape {
  static constexpr int kVec = Rows::kVec;              // a 16-byte load
  static constexpr int kLanesPerRow = D / kVec;        // 2 .. 32
  static constexpr int kRowsPerLoad = 32 / kLanesPerRow;
  // loads a lane keeps in flight: 16 rows a warp at least
  static constexpr int kUnroll = kRowsPerLoad >= 16 ? 1 : 16 / kRowsPerLoad;
  static constexpr int kRowsPerRound = kDecodeWarps * kUnroll * kRowsPerLoad;
  static_assert(kLanesPerRow >= 2 && kLanesPerRow <= 32, "head_dim");
};

// Shared memory of a decode CTA, in 4-byte words: queries and the CTA's
// P.V partial rows (G x D floats each), the warps' partial rows, logits
// of the CTA's span (G x span), per query the CTA's max and sum and the
// cluster's max or sum, and the cover table (2 M ints). The row
// policy's words follow, from the next 16-byte boundary.
__host__ __device__ inline size_t decode_smem_words(int G, int D, int span,
                                                    int M) {
  return 2 * (size_t)G * D + (size_t)kDecodeWarps * kQueryGroup * D +
         (size_t)G * span + 3 * (size_t)G + 2 * (size_t)M;
}

__host__ __device__ inline size_t align4(size_t words) {
  return (words + 3) & ~size_t(3);
}

// Least C of 1, 2, 4, 8 with B * KH * C CTAs filling `sms` SMs; 8 where
// none does (the entry point reports the C it launched).
__host__ inline int decode_cluster(int B, int KH, int sms) {
  int c = 1;
  while (c < kMaxCluster && (long long)B * KH * c < sms) c *= 2;
  return c;
}

// Span of the rows [0, R) each of C CTAs owns (the last may be short or
// empty): ceil(R / C) (ops/decode_attention.py decode_span).
__host__ __device__ inline int decode_span(int R, int C) {
  return (R + C - 1) / C;
}

template <typename Rows, int D>
__global__ void __launch_bounds__(kDecodeThreads)
    decode_cluster_kernel(const __nv_bfloat16* __restrict__ q,
                          const typename Rows::Cache cache,
                          const __nv_bfloat16* __restrict__ kn,
                          const __nv_bfloat16* __restrict__ vn,
                          const int* __restrict__ pos,
                          __nv_bfloat16* __restrict__ out, int T, int H,
                          int KH, int M, int span_cap, float scale) {
  namespace cg = cooperative_groups;
  using Sh = DecodeShape<Rows, D>;
  constexpr int kVec = Sh::kVec, kLPR = Sh::kLanesPerRow;
  constexpr int kRPL = Sh::kRowsPerLoad, kU = Sh::kUnroll;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int kh = blockIdx.y, b = blockIdx.z;
  const int rep = H / KH, G = T * rep;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane / kLPR, d0 = (lane % kLPR) * kVec;

  extern __shared__ __align__(16) float dsm[];
  float* qs = dsm;                                  // [G][D]
  float* part = qs + (size_t)G * D;                 // [G][D]
  float* wpart = part + (size_t)G * D;              // [warps][group][D]
  float* lg = wpart + kDecodeWarps * kQueryGroup * D;  // [G][span_cap]
  float* red_max = lg + (size_t)G * span_cap;       // [G]
  float* red_sum = red_max + G;                     // [G]
  float* gred = red_sum + G;                        // [G]
  int* first = reinterpret_cast<int*>(gred + G);
  int* count = first + M;
  float* own = dsm + align4(decode_smem_words(G, D, span_cap, M));
  __shared__ float scratch[32];

  const int* pos_b = pos + (size_t)b * T;
  for (int i = threadIdx.x; i < G * D; i += kDecodeThreads) {
    const int g = i / D, d = i % D;
    const int t = g / rep, h = kh * rep + g % rep;
    qs[i] = __bfloat162float(q[(((size_t)b * T + t) * H + h) * D + d]);
  }
  build_cover(pos_b, T, M, first, count);  // ends in __syncthreads
  int R = 0;
  for (int t = 0; t < T; ++t) R = max(R, row_end(pos_b[t], M));
  const int span = decode_span(R, C);
  const int s0 = min(R, rank * span), s1 = min(R, s0 + span);

  const size_t fresh = (size_t)b * T * KH * D + (size_t)kh * D;
  const Rows rows(cache, DecodeSlot{kn + fresh, vn + fresh, KH * D, pos_b,
                                    first, count, T, M, D, b, kh, own});
  rows.stage(s0, s1);

  // logits of the span: lane `sub` of a load reads row j, 16 bytes at d0
  for (int base = s0 + warp * kU * kRPL; base < s1;
       base += Sh::kRowsPerRound) {
    typename Rows::Load ld[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u)
      rows.k.fetch(ld[u], base + u * kRPL + sub, s1, d0);
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int j = base + u * kRPL + sub;
      float v[kVec];
      rows.k.values(v, ld[u], j, d0);
      for (int g = 0; g < G; ++g) {
        const float* qg = qs + (size_t)g * D + d0;
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < kVec; ++e) dot = fmaf(qg[e], v[e], dot);
#pragma unroll
        for (int off = kLPR / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        if (d0 == 0 && j < s1) {
          const int p = pos_b[g / rep];
          lg[(size_t)g * span_cap + (j - s0)] =
              j < row_end(p, M) ? logit(dot, j, p, scale) : -INFINITY;
        }
      }
    }
  }
  __syncthreads();

  const int len = s1 - s0;
  // the span's maximum per query; the cluster's (order-free); exp and
  // the span's sum; the cluster's sum, the ranks added in rank order by
  // every CTA, so all round P from the same bits
  for (int g = 0; g < G; ++g) {
    float m = -INFINITY;
    for (int i = threadIdx.x; i < len; i += kDecodeThreads)
      m = fmaxf(m, lg[(size_t)g * span_cap + i]);
    m = block_max(m, scratch);
    if (threadIdx.x == 0) red_max[g] = m;
  }
  cluster.sync();
  for (int g = threadIdx.x; g < G; g += kDecodeThreads) {
    float m = -INFINITY;
    for (int r = 0; r < C; ++r)
      m = fmaxf(m, *cluster.map_shared_rank(red_max + g, r));
    gred[g] = m;
  }
  __syncthreads();
  for (int g = 0; g < G; ++g) {
    float s = 0.f;
    for (int i = threadIdx.x; i < len; i += kDecodeThreads) {
      float* l = lg + (size_t)g * span_cap + i;
      const float e = expf(__fsub_rn(*l, gred[g]));
      *l = e;
      s += e;
    }
    s = block_sum(s, scratch);
    if (threadIdx.x == 0) red_sum[g] = s;
  }
  cluster.sync();
  for (int g = threadIdx.x; g < G; g += kDecodeThreads) {
    float s = 0.f;
    for (int r = 0; r < C; ++r) s += *cluster.map_shared_rank(red_sum + g, r);
    gred[g] = s;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * len; i += kDecodeThreads) {
    const int g = i / len;
    float* l = lg + (size_t)g * span_cap + i % len;
    *l = round_to<__nv_bfloat16>(__fdiv_rn(*l, gred[g]));
  }
  __syncthreads();

  // P . V over the span, kQueryGroup queries a sweep; partial rows meet
  // across a warp's loads by shuffles, across warps in warp order
  for (int g0 = 0; g0 < G; g0 += kQueryGroup) {
    float acc[kQueryGroup][kVec];
#pragma unroll
    for (int k = 0; k < kQueryGroup; ++k)
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[k][e] = 0.f;
    for (int base = s0 + warp * kU * kRPL; base < s1;
         base += Sh::kRowsPerRound) {
      typename Rows::Load ld[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u)
        rows.v.fetch(ld[u], base + u * kRPL + sub, s1, d0);
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int j = base + u * kRPL + sub;
        if (j >= s1) continue;
        float v[kVec];
        rows.v.values(v, ld[u], j, d0);
#pragma unroll
        for (int k = 0; k < kQueryGroup; ++k) {
          if (g0 + k >= G) break;
          const float pj = lg[(size_t)(g0 + k) * span_cap + (j - s0)];
#pragma unroll
          for (int e = 0; e < kVec; ++e) acc[k][e] = fmaf(pj, v[e], acc[k][e]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kQueryGroup; ++k)
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
#pragma unroll
        for (int off = kLPR; off < 32; off <<= 1)
          acc[k][e] += __shfl_xor_sync(0xffffffffu, acc[k][e], off);
        if (sub == 0)
          wpart[((size_t)warp * kQueryGroup + k) * D + d0 + e] = acc[k][e];
      }
    __syncthreads();
    for (int i = threadIdx.x; i < kQueryGroup * D; i += kDecodeThreads) {
      const int k = i / D, d = i % D;
      if (g0 + k >= G) break;
      float s = 0.f;
      for (int w = 0; w < kDecodeWarps; ++w)
        s += wpart[((size_t)w * kQueryGroup + k) * D + d];
      part[(size_t)(g0 + k) * D + d] = s;
    }
    __syncthreads();
  }

  // the CTA that owns a replaced row writes it
  rows.write(s0, s1);

  cluster.sync();
  if (rank == 0) {
    for (int i = threadIdx.x; i < G * D; i += kDecodeThreads) {
      const int g = i / D, d = i % D;
      float s = 0.f;
      for (int r = 0; r < C; ++r) s += *cluster.map_shared_rank(part + i, r);
      const int t = g / rep, h = kh * rep + g % rep;
      out[(((size_t)b * T + t) * H + h) * D + d] = __float2bfloat16_rn(s);
    }
  }
  cluster.sync();  // the other ranks' shared memory stays until read
}

// The SM count of `device` (cached).
__host__ inline cudaError_t sm_count(int device, int* n) {
  static int cached[64] = {0};
  if (device >= 0 && device < 64 && cached[device] > 0) {
    *n = cached[device];
    return cudaSuccess;
  }
  const cudaError_t err =
      cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess && device >= 0 && device < 64) cached[device] = *n;
  return err;
}

// Launch the decode route with clusters of *cluster CTAs (written before
// the launch); cudaErrorNotSupported when its shared memory does not fit
// a block (the caller takes the CUDA cores instead).
template <typename Rows, int D>
cudaError_t launch_decode(const void* q, const typename Rows::Cache& cache,
                          const void* kn, const void* vn, const int* pos,
                          void* out, int B, int T, int H, int KH, int M,
                          float scale, int device, cudaStream_t stream,
                          int* cluster) {
  int sms = 0;
  cudaError_t err = sm_count(device, &sms);
  if (err != cudaSuccess) return err;
  const int C = decode_cluster(B, KH, sms);
  *cluster = C;
  const int G = T * (H / KH);
  const int span_cap = decode_span(M, C);
  const size_t smem = (align4(decode_smem_words(G, D, span_cap, M)) +
                       Rows::smem_words(T, D, cache)) * 4;
  if (smem > kMaxSmem) return cudaErrorNotSupported;
  auto kernel = decode_cluster_kernel<Rows, D>;
  err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, KH, B);
  cfg.blockDim = dim3(kDecodeThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // residency: a cluster of C such CTAs must fit the card (checked once
  // per cluster size up to the largest shared memory seen to fit)
  static size_t fits[kMaxCluster + 1] = {0};
  if (smem > fits[C]) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    fits[C] = smem;
  }
  err = cudaLaunchKernelEx(&cfg, kernel,
                           static_cast<const __nv_bfloat16*>(q), cache,
                           static_cast<const __nv_bfloat16*>(kn),
                           static_cast<const __nv_bfloat16*>(vn), pos,
                           static_cast<__nv_bfloat16*>(out), T, H, KH, M,
                           span_cap, scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The head_dims the bf16 routes are built for (GPT-2's 64 and the
// common 128; any other runs on the CUDA cores): `body` takes a
// std::integral_constant<int, D>.
template <typename F>
cudaError_t routed_head_dim(int d, F&& body) {
  if (d == 64) return body(std::integral_constant<int, 64>{});
  if (d == 128) return body(std::integral_constant<int, 128>{});
  return cudaErrorInvalidValue;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}
