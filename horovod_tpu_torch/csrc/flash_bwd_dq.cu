// Flash-attention backward, dQ.
//
// Replaces: horovod_tpu/ops/pallas_attention.py `_flash_bwd_dq_kernel`
// (the first pallas_call of `_flash_bwd`).
//
// For one block of query rows, stream the K/V tiles the forward visited
// and rebuild each probability from the saved row logsumexp:
//   p  = visible ? exp(s - lse) : 0   (mask first: lse = -1e30 rows
//                                      would overflow the exp)
//   dS = p * (dO.V^T - delta),  dQ = scale * round(dS) . K
// with q scaled and rounded to the input dtype as in the forward, and
// float32 sums. Each dQ row is written by exactly one block, so the
// result is deterministic and needs no atomics.
//
// What bounds it on an H100: at GPT-2-medium shapes the least time is
// its 25.8 GFLOP (three products over the causal half) at the bf16
// tensor-core rate; this version runs them as float32 FMAs on the CUDA
// cores, one query row per one or two threads, with K/V tiles in shared
// memory.

#include "flash.cuh"

namespace {

using namespace flash;

template <typename T, int D>
__global__ void __launch_bounds__(Shape<D>::kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int tq, int tk, float scale, int causal, int q_off,
                        int k_off) {
  using S = Shape<D>;
  constexpr int kTile = S::kTile;
  __shared__ __align__(16) float sk[kTile * D];
  __shared__ __align__(16) float sv[kTile * D];

  const size_t bh = blockIdx.x;
  const int q_base = blockIdx.y * kRows;
  const int row = threadIdx.x / S::kParts, part = threadIdx.x % S::kParts;
  const int qi = q_base + row;
  const bool live = qi < tq;
  const T* kb = k + bh * tk * D;
  const T* vb = v + bh * tk * D;

  float qr[S::kDims], dor[S::kDims], acc[S::kDims];
  load_part<T, D>(qr, q + (bh * tq + qi) * D, part, live);
  load_part<T, D>(dor, dout + (bh * tq + qi) * D, part, live);
#pragma unroll
  for (int i = 0; i < S::kDims; ++i) {
    qr[i] = round_to<T>(__fmul_rn(qr[i], scale));
    acc[i] = 0.f;
  }
  const float row_lse = live ? lse[bh * tq + qi] : 0.f;
  const float row_delta = live ? delta[bh * tq + qi] : 0.f;

  const int n_tiles = (tk + kTile - 1) / kTile;
  const int limit =
      causal ? causal_kv_limit(min(q_base + kRows, tq) - 1, q_off, k_off,
                               kTile, n_tiles)
             : n_tiles;
  for (int t = 0; t < limit; ++t) {
    const int k0 = t * kTile;
    __syncthreads();
    load_tile<T, D>(sk, kb, k0, kTile, tk);
    load_tile<T, D>(sv, vb, k0, kTile, tk);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      const float s = sum_parts<D>(dot_part<D>(qr, sk + j * D, part));
      const float dp = sum_parts<D>(dot_part<D>(dor, sv + j * D, part));
      const bool vis = live && visible(qi, k0 + j, tk, causal, q_off, k_off);
      const float p = vis ? expf(s - row_lse) : 0.f;
      const float ds = __fmul_rn(p, __fsub_rn(dp, row_delta));
      axpy_part<D>(acc, round_to<T>(ds), sk + j * D, part);
    }
  }
  if (live) store_part<T, D>(dq + (bh * tq + qi) * D, acc, scale, part);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, int bh, int tq, int tk, int d, float scale,
                   int causal, int q_off, int k_off, cudaStream_t stream) {
  return with_head_dim(d, [&](auto dd) {
    constexpr int D = decltype(dd)::value;
    const dim3 grid(bh, (tq + kRows - 1) / kRows);
    flash_bwd_dq_kernel<T, D><<<grid, Shape<D>::kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
        static_cast<T*>(dq), tq, tk, scale, causal, q_off, k_off);
    return cudaGetLastError();
  });
}

}  // namespace

// q/dout/dq: [bh, tq, d], k/v: [bh, tk, d], contiguous, dtype `dtype`;
// lse/delta: [bh, tq] float32. Returns cudaGetLastError() after the
// launch on `stream` of device `device`.
extern "C" int hvd_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, int bh, int tq,
                                int tk, int d, float scale, int causal,
                                int q_off, int k_off, int dtype, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(q, k, v, dout, l, dl, dq, bh, tq, tk, d,
                                 scale, causal, q_off, k_off, s);
  if (dtype == kF32)
    return launch<float>(q, k, v, dout, l, dl, dq, bh, tq, tk, d, scale,
                         causal, q_off, k_off, s);
  return cudaErrorInvalidValue;
}
