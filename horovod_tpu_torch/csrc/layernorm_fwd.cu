// LayerNorm / RMSNorm forward over the last axis of an [N, C] tensor.
//
// Replaces: horovod_tpu/ops/pallas_layernorm.py `_fwd_kernel` (run by
// `_run_fwd`), the TPU kernel behind `fused_layer_norm` forward.
//
// Math (the TPU kernel's, not Welford): per row, in float32,
//   mean = sum(x) / C,  var = max(sum(x*x) / C - mean*mean, 0)
//   rstd = 1 / sqrt(var + eps)            (RMSNorm: mean = 0,
//   y    = (x - mean) * rstd * gamma (+ beta)   var = sum(x*x) / C)
// with y stored in x's dtype. The elementwise steps use the _rn
// intrinsics so the compiler cannot contract them into FMAs: only the
// order of the two row sums differs from the plain version.
//
// What bounds it on an H100: bytes. It reads x once and writes y once
// ([N, C] each) and does ~8 flops per element, far below the ~20
// flops/byte the card's float32 units need to be the limit.
//
// Design: one block of 256 threads per row, two block reductions
// (sum and sum of squares) through warp shuffles, then a second pass
// over the row, which hits L1/L2. The TPU kernel's row blocks and
// lane masks (`_row_block`, `_masks`) only serve the (8, 128) tiling
// and have no counterpart here.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    layernorm_fwd_kernel(const T* __restrict__ x,
                         const float* __restrict__ gamma,
                         const float* __restrict__ beta, T* __restrict__ y,
                         int c, float eps, int rms) {
  __shared__ float scratch[32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * c;
  T* yr = y + row * c;

  float s = 0.f, ss = 0.f;
  for (int i = threadIdx.x; i < c; i += kThreads) {
    const float v = to_f32(xr[i]);
    s += v;
    ss = fmaf(v, v, ss);
  }
  s = block_sum(s, scratch);
  ss = block_sum(ss, scratch);

  const float cf = static_cast<float>(c);
  float mean, var;
  if (rms) {
    mean = 0.f;
    var = __fdiv_rn(ss, cf);
  } else {
    mean = __fdiv_rn(s, cf);
    var = fmaxf(__fsub_rn(__fdiv_rn(ss, cf), __fmul_rn(mean, mean)), 0.f);
  }
  const float rstd = __frcp_rn(__fsqrt_rn(__fadd_rn(var, eps)));

  for (int i = threadIdx.x; i < c; i += kThreads) {
    const float v = to_f32(xr[i]);
    float o = __fmul_rn(__fmul_rn(__fsub_rn(v, mean), rstd), gamma[i]);
    if (beta != nullptr) o = __fadd_rn(o, beta[i]);
    yr[i] = from_f32<T>(o);
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* gamma, const float* beta,
                   void* y, int n, int c, float eps, int rms,
                   cudaStream_t stream) {
  layernorm_fwd_kernel<T><<<n, kThreads, 0, stream>>>(
      static_cast<const T*>(x), gamma, beta, static_cast<T*>(y), c, eps,
      rms);
  return cudaGetLastError();
}

}  // namespace

// x, y: [n, c] contiguous, dtype `dtype` (kF32 / kBF16); gamma, beta:
// [c] float32 (beta may be null). Launches on `stream` of CUDA device
// `device`; returns cudaGetLastError() after the launch.
extern "C" int hvd_layernorm_fwd(const void* x, const void* gamma,
                                 const void* beta, void* y, int n, int c,
                                 float eps, int rms, int dtype,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(x, g, b, y, n, c, eps, rms, s);
  if (dtype == kF32) return launch<float>(x, g, b, y, n, c, eps, rms, s);
  return cudaErrorInvalidValue;
}
