// Flash-attention backward, dK and dV.
//
// Replaces: horovod_tpu/ops/pallas_attention.py `_flash_bwd_dkv_kernel`
// (the second pallas_call of `_flash_bwd`).
//
// For one block of key rows, stream the Q / dO / lse / delta tiles and
// rebuild each probability from lse:
//   p  = visible ? exp(qs.k - lse) : 0,   dS = p * (dO.v - delta)
//   dV = round(p)^T . dO,                 dK = scale * round(dS)^T . Q
// where qs is q scaled and rounded to the input dtype (the forward's
// logits) and Q in dK is the unscaled input, as in the TPU kernel. Under
// the causal mask the q tiles wholly above the diagonal are skipped
// (the TPU kernel's `start`). Each dK/dV row is written by exactly one
// block: no float atomics, deterministic.
//
// What bounds it on an H100: at GPT-2-medium shapes the least time is
// its 34.4 GFLOP (four products over the causal half) at the bf16
// tensor-core rate; this version runs them as float32 FMAs on the CUDA
// cores. A row's four accumulators (k, v, dk, dv) are split over one to
// four threads so that they stay in registers.

#include "flash.cuh"

namespace {

using namespace flash;

template <typename T, int D>
__global__ void __launch_bounds__(Shape<D>::kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, int tq,
                         int tk, float scale, int causal, int q_off,
                         int k_off) {
  using S = Shape<D>;
  constexpr int kTile = S::kTile;
  __shared__ __align__(16) float sq[kTile * D];   // q as given
  __shared__ __align__(16) float sqs[kTile * D];  // q scaled and rounded
  __shared__ __align__(16) float sdo[kTile * D];
  __shared__ float slse[kTile];
  __shared__ float sdelta[kTile];

  const size_t bh = blockIdx.x;
  const int k_base = blockIdx.y * kRows;
  const int row = threadIdx.x / S::kParts, part = threadIdx.x % S::kParts;
  const int kj = k_base + row;
  const bool live = kj < tk;
  const T* qb = q + bh * tq * D;
  const T* dob = dout + bh * tq * D;

  float kr[S::kDims], vr[S::kDims], dk_acc[S::kDims], dv_acc[S::kDims];
  load_part<T, D>(kr, k + (bh * tk + kj) * D, part, live);
  load_part<T, D>(vr, v + (bh * tk + kj) * D, part, live);
#pragma unroll
  for (int i = 0; i < S::kDims; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  const int n_tiles = (tq + kTile - 1) / kTile;
  int start = 0;
  if (causal) {
    // q tiles whose last row sits above the block's first key see none
    // of its keys
    const int first = k_off + k_base - q_off;
    start = first <= 0 ? 0 : min(n_tiles, first / kTile);
  }
  for (int t = start; t < n_tiles; ++t) {
    const int q0 = t * kTile;
    __syncthreads();
    const int live_q = min(kTile, tq - q0) * D;
    for (int i = threadIdx.x; i < kTile * D; i += blockDim.x) {
      const float x = i < live_q ? to_f32(qb[static_cast<size_t>(q0) * D + i])
                                 : 0.f;
      sq[i] = x;
      sqs[i] = round_to<T>(__fmul_rn(x, scale));
    }
    load_tile<T, D>(sdo, dob, q0, kTile, tq);
    for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
      const bool in = q0 + i < tq;
      slse[i] = in ? lse[bh * tq + q0 + i] : 0.f;
      sdelta[i] = in ? delta[bh * tq + q0 + i] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < kTile; ++i) {
      const int qi = q0 + i;
      const float s = sum_parts<D>(dot_part<D>(kr, sqs + i * D, part));
      const float dp = sum_parts<D>(dot_part<D>(vr, sdo + i * D, part));
      const bool vis =
          qi < tq && visible(qi, kj, tk, causal, q_off, k_off);
      const float p = vis ? expf(s - slse[i]) : 0.f;
      const float ds = __fmul_rn(p, __fsub_rn(dp, sdelta[i]));
      axpy_part<D>(dv_acc, round_to<T>(p), sdo + i * D, part);
      axpy_part<D>(dk_acc, round_to<T>(ds), sq + i * D, part);
    }
  }
  if (!live) return;
  store_part<T, D>(dk + (bh * tk + kj) * D, dk_acc, scale, part);
  store_part<T, D>(dv + (bh * tk + kj) * D, dv_acc, 1.f, part);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dk, void* dv, int bh, int tq, int tk, int d,
                   float scale, int causal, int q_off, int k_off,
                   cudaStream_t stream) {
  return with_head_dim(d, [&](auto dd) {
    constexpr int D = decltype(dd)::value;
    const dim3 grid(bh, (tk + kRows - 1) / kRows);
    flash_bwd_dkv_kernel<T, D><<<grid, Shape<D>::kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
        static_cast<T*>(dk), static_cast<T*>(dv), tq, tk, scale, causal,
        q_off, k_off);
    return cudaGetLastError();
  });
}

}  // namespace

// q/dout: [bh, tq, d], k/v/dk/dv: [bh, tk, d], contiguous, dtype
// `dtype`; lse/delta: [bh, tq] float32. Returns cudaGetLastError()
// after the launch on `stream` of device `device`.
extern "C" int hvd_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv,
                                 int bh, int tq, int tk, int d, float scale,
                                 int causal, int q_off, int k_off, int dtype,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(q, k, v, dout, l, dl, dk, dv, bh, tq, tk, d,
                                 scale, causal, q_off, k_off, s);
  if (dtype == kF32)
    return launch<float>(q, k, v, dout, l, dl, dk, dv, bh, tq, tk, d, scale,
                         causal, q_off, k_off, s);
  return cudaErrorInvalidValue;
}
