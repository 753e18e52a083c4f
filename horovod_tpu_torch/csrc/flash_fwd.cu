// Flash-attention forward: O and the float32 row logsumexp.
//
// Replaces: horovod_tpu/ops/pallas_attention.py `_flash_fwd_kernel`
// (pallas_call in `_flash_core`), the forward of `flash_attention`.
//
// Semantics kept from the TPU kernel:
//   * q is scaled and rounded to the input dtype before Q.K^T;
//   * logits, the running max m and sum l are float32; p is rounded to
//     the input dtype before P.V, whose sum is float32;
//   * masked entries of p are set to 0 explicitly, so a row with no
//     visible key gives O = 0 and lse = -1e30 (NEG_INF);
//   * the causal mask is on global positions (query_offset/key_offset)
//     and kv tiles above the diagonal are never visited
//     (`_causal_kv_limit`); T need not be a tile multiple (bounds, not
//     padding).
//
// What bounds it on an H100: at GPT-2-medium shapes ([8, 16, 1024, 64]
// bf16, causal) the least time is the 67 MB of q/k/v/o at 3.35 TB/s,
// but this first version computes on the CUDA cores in float32 (no
// tensor cores), so the FMA rate is what it reaches. Its design keeps
// the attention matrix out of device memory: each block holds 64 query
// rows in registers and streams K/V tiles through shared memory.

#include "flash.cuh"

namespace {

using namespace flash;

template <typename T, int D>
__global__ void __launch_bounds__(Shape<D>::kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int tq, int tk, float scale,
                     int causal, int q_off, int k_off) {
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

  float qr[S::kDims], acc[S::kDims];
  load_part<T, D>(qr, q + (bh * tq + qi) * D, part, live);
#pragma unroll
  for (int i = 0; i < S::kDims; ++i) {
    qr[i] = round_to<T>(__fmul_rn(qr[i], scale));
    acc[i] = 0.f;
  }
  float m = kNegInf, l = 0.f;

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

    float s[kTile];
    float m_cur = kNegInf;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const float x = sum_parts<D>(dot_part<D>(qr, sk + j * D, part));
      s[j] = visible(qi, k0 + j, tk, causal, q_off, k_off) ? x : kNegInf;
      m_cur = fmaxf(m_cur, s[j]);
    }
    const float m_new = fmaxf(m, m_cur);
    const float alpha = expf(m - m_new);
#pragma unroll
    for (int i = 0; i < S::kDims; ++i) acc[i] *= alpha;
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const float p = visible(qi, k0 + j, tk, causal, q_off, k_off)
                          ? expf(s[j] - m_new)
                          : 0.f;
      psum += p;
      axpy_part<D>(acc, round_to<T>(p), sv + j * D, part);
    }
    l = l * alpha + psum;
    m = m_new;
  }

  if (!live) return;
  const float safe_l = l > 0.f ? l : 1.f;
#pragma unroll
  for (int i = 0; i < S::kDims; ++i) acc[i] = __fdiv_rn(acc[i], safe_l);
  store_part<T, D>(o + (bh * tq + qi) * D, acc, 1.f, part);
  if (part == 0) lse[bh * tq + qi] = l > 0.f ? m + logf(safe_l) : kNegInf;
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int bh, int tq, int tk, int d, float scale,
                   int causal, int q_off, int k_off, cudaStream_t stream) {
  return with_head_dim(d, [&](auto dd) {
    constexpr int D = decltype(dd)::value;
    const dim3 grid(bh, (tq + kRows - 1) / kRows);
    flash_fwd_kernel<T, D><<<grid, Shape<D>::kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), lse, tq, tk, scale,
        causal, q_off, k_off);
    return cudaGetLastError();
  });
}

}  // namespace

// q: [bh, tq, d], k/v: [bh, tk, d], o: [bh, tq, d], all contiguous of
// dtype `dtype` (kF32 / kBF16); lse: [bh, tq] float32. d is 16, 32, 64
// or 128. Launches on `stream` of CUDA device `device`; returns
// cudaGetLastError() after the launch.
extern "C" int hvd_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int bh, int tq, int tk,
                             int d, float scale, int causal, int q_off,
                             int k_off, int dtype, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(q, k, v, o, l, bh, tq, tk, d, scale, causal,
                                 q_off, k_off, s);
  if (dtype == kF32)
    return launch<float>(q, k, v, o, l, bh, tq, tk, d, scale, causal, q_off,
                         k_off, s);
  return cudaErrorInvalidValue;
}
