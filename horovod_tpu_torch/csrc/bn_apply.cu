// BatchNorm apply: y = act(x * s + t [+ res]) over an [n, c]
// channels-last tensor, s and t per-channel float32 constants (s =
// gamma * rstd, t = beta - mean * s, folded by the caller), act ReLU or
// none, y in x's dtype.
//
// Replaces: horovod_tpu/ops/pallas_batchnorm.py `_apply_kernel` and
// `_apply_res_kernel` (run by `_run_apply`), the second pass of
// `fused_batch_norm`'s forward.
//
// Rounding: float32, in the plain version's order, each step rounded on
// its own (`__fmul_rn`, `__fadd_rn`: nvcc would otherwise contract
// x * s + t into one FMA, which eager PyTorch never does): x * s, then
// + t, then + res, then ReLU, then the cast. So the output is bitwise the
// plain version's, and the ReLU mask that bn_bwd_reduce.cu and
// bn_bwd_dx.cu recompute from x (and res) has exactly the forward's bits.
//
// What bounds it on an H100: bytes. It reads x (and res) and writes y
// once, two or three flops an element. One 16-byte vector a thread, one
// thread per vector, with a grid-stride loop past 2^20 blocks.

#include "batchnorm.cuh"

namespace {

template <typename T, int VEC>
__global__ void __launch_bounds__(bn::kThreads)
    bn_apply_kernel(const T* __restrict__ x, const float* __restrict__ s,
                    const float* __restrict__ t, const T* __restrict__ res,
                    T* __restrict__ y, long long nvec, int cv, int relu) {
  for (long long v = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       v < nvec; v += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int col = static_cast<int>(v % cv) * VEC;
    float xv[VEC], rv[VEC], out[VEC];
    bn::load_vec<T, VEC>(x + v * VEC, xv);
    if (res != nullptr) bn::load_vec<T, VEC>(res + v * VEC, rv);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      float o = __fadd_rn(__fmul_rn(xv[i], s[col + i]), t[col + i]);
      if (res != nullptr) o = __fadd_rn(o, rv[i]);
      out[i] = relu ? bn::relu(o) : o;
    }
    bn::store_vec<T, VEC>(y + v * VEC, out);
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* x, const float* s, const float* t,
                   const void* res, void* y, long long n, int c, int relu,
                   cudaStream_t stream) {
  const long long nvec = n * c / VEC;
  bn_apply_kernel<T, VEC>
      <<<bn::elementwise_blocks(nvec), bn::kThreads, 0, stream>>>(
          static_cast<const T*>(x), s, t, static_cast<const T*>(res),
          static_cast<T*>(y), nvec, c / VEC, relu);
  return cudaGetLastError();
}

}  // namespace

// x, res, y: [n, c] contiguous, dtype `dtype` (kF32 / kBF16), res null
// for none; s, t: [c] float32; vec: elements a thread moves at once (16
// bytes' worth, c a multiple of it and x, res, y 16-byte aligned, or 1).
// Launches one kernel on `stream` of CUDA device `device`; returns
// cudaGetLastError() after it.
extern "C" int hvd_bn_apply(const void* x, const void* s, const void* t,
                            const void* res, void* y, long long n, int c,
                            int vec, int relu, int dtype, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const float* sf = static_cast<const float*>(s);
  const float* tf = static_cast<const float*>(t);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16 && vec == 8)
    return launch<__nv_bfloat16, 8>(x, sf, tf, res, y, n, c, relu, st);
  if (dtype == kBF16 && vec == 1)
    return launch<__nv_bfloat16, 1>(x, sf, tf, res, y, n, c, relu, st);
  if (dtype == kF32 && vec == 4)
    return launch<float, 4>(x, sf, tf, res, y, n, c, relu, st);
  if (dtype == kF32 && vec == 1)
    return launch<float, 1>(x, sf, tf, res, y, n, c, relu, st);
  return cudaErrorInvalidValue;
}
