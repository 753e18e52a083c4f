// BatchNorm backward dx: dx = dy_eff * A + x * B + C over an [n, c]
// channels-last tensor, with per-channel float32 constants A, B, C
// folded by the caller from gamma, mean, rstd, dgamma and dbeta, and
// dy_eff = dy, or with ReLU dy where x * s + t (+ res) > 0. With a
// residual it also writes dres = dy_eff. dx and dres in x's dtype.
//
// Replaces: horovod_tpu/ops/pallas_batchnorm.py `_bwd_dx_kernel` (run by
// `_run_bwd_dx`, with and without the residual output), the second pass
// of `fused_batch_norm`'s backward.
//
// Rounding: float32, each step rounded on its own in the plain version's
// order (`__fmul_rn`, `__fadd_rn`; no FMA contraction): dy_eff * A, then
// x * B, then their sum, then + C. The ReLU mask is recomputed exactly
// as bn_apply.cu rounds the forward. So dx and dres are bitwise the
// plain version's.
//
// What bounds it on an H100: bytes. It reads x, dy (and res) and writes
// dx (and dres) once, about eight flops an element; one 16-byte vector a
// thread, as bn_apply.cu.

#include "batchnorm.cuh"

namespace {

template <typename T, int VEC>
__global__ void __launch_bounds__(bn::kThreads)
    bn_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                     const T* __restrict__ res, const float* __restrict__ s,
                     const float* __restrict__ t,
                     const float* __restrict__ a,
                     const float* __restrict__ b,
                     const float* __restrict__ cc, T* __restrict__ dx,
                     T* __restrict__ dres, long long nvec, int cv,
                     int relu) {
  for (long long v = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       v < nvec; v += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int col = static_cast<int>(v % cv) * VEC;
    float xv[VEC], dv[VEC], rv[VEC], out[VEC];
    bn::load_vec<T, VEC>(x + v * VEC, xv);
    bn::load_vec<T, VEC>(dy + v * VEC, dv);
    if (relu && res != nullptr) bn::load_vec<T, VEC>(res + v * VEC, rv);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      if (relu) {
        float pre = __fadd_rn(__fmul_rn(xv[i], s[col + i]), t[col + i]);
        if (res != nullptr) pre = __fadd_rn(pre, rv[i]);
        dv[i] = pre > 0.f ? dv[i] : 0.f;
      }
      out[i] = __fadd_rn(__fadd_rn(__fmul_rn(dv[i], a[col + i]),
                                   __fmul_rn(xv[i], b[col + i])),
                         cc[col + i]);
    }
    bn::store_vec<T, VEC>(dx + v * VEC, out);
    if (dres != nullptr) bn::store_vec<T, VEC>(dres + v * VEC, dv);
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* x, const void* dy, const void* res,
                   const float* s, const float* t, const float* a,
                   const float* b, const float* cc, void* dx, void* dres,
                   long long n, int c, int relu, cudaStream_t stream) {
  const long long nvec = n * c / VEC;
  bn_bwd_dx_kernel<T, VEC>
      <<<bn::elementwise_blocks(nvec), bn::kThreads, 0, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(dy),
          static_cast<const T*>(res), s, t, a, b, cc, static_cast<T*>(dx),
          static_cast<T*>(dres), nvec, c / VEC, relu);
  return cudaGetLastError();
}

}  // namespace

// x, dy, res, dx, dres: [n, c] contiguous, dtype `dtype` (kF32 / kBF16);
// res and dres null without a residual (dres is written whenever it is
// given); s, t, a, b, cc: [c] float32; vec as in bn_apply.cu. Launches
// one kernel on `stream` of CUDA device `device`; returns
// cudaGetLastError() after it.
extern "C" int hvd_bn_bwd_dx(const void* x, const void* dy, const void* res,
                             const void* s, const void* t, const void* a,
                             const void* b, const void* cc, void* dx,
                             void* dres, long long n, int c, int vec,
                             int relu, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const float* sf = static_cast<const float*>(s);
  const float* tf = static_cast<const float*>(t);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  const float* cf = static_cast<const float*>(cc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16 && vec == 8)
    return launch<__nv_bfloat16, 8>(x, dy, res, sf, tf, af, bf, cf, dx, dres,
                                    n, c, relu, st);
  if (dtype == kBF16 && vec == 1)
    return launch<__nv_bfloat16, 1>(x, dy, res, sf, tf, af, bf, cf, dx, dres,
                                    n, c, relu, st);
  if (dtype == kF32 && vec == 4)
    return launch<float, 4>(x, dy, res, sf, tf, af, bf, cf, dx, dres, n, c,
                            relu, st);
  if (dtype == kF32 && vec == 1)
    return launch<float, 1>(x, dy, res, sf, tf, af, bf, cf, dx, dres, n, c,
                            relu, st);
  return cudaErrorInvalidValue;
}
