// BatchNorm backward dx: dx = dy_eff * A + x * B + C over an [n, c]
// channels-last tensor, dy_eff = dy, or with ReLU dy where x * s + t
// (+ res) > 0. With a residual it also writes dres = dy_eff. dx and
// dres in x's dtype. The per-channel float32 constants A, B and C are
// folded here from the statistics (gamma, mean, rstd) and the column
// sums of the first backward pass (dgamma, dbeta):
//   a = gamma * rstd
//   b = rstd * ((-a * dgamma) / n)
//   c = (-a * dbeta) / n - (((-mean * rstd) * a) * dgamma) / n
// (ops/batchnorm.py `bn_bwd_constants_ref`, where they were about 14
// [c]-sized PyTorch launches a layer).
//
// Replaces: horovod_tpu/ops/pallas_batchnorm.py `_bwd_dx_kernel` (run by
// `_run_bwd_dx`, with and without the residual output), the second pass
// of `fused_batch_norm`'s backward. The JAX package computes A, B and C
// outside its kernel.
//
// Rounding: float32, each step rounded on its own in the plain version's
// order (`__fmul_rn`, `__fadd_rn`, `__fsub_rn`; no FMA contraction):
// dy_eff * A, then x * B, then their sum, then + C. On the card PyTorch
// divides a float32 tensor by a Python float as a product with the
// float32 reciprocal 1 / float(n), so the fold does the same. The ReLU
// mask is recomputed exactly as bn_apply.cu rounds the forward. So dx
// and dres are bitwise the plain version's.
//
// What bounds it on an H100: bytes. It reads x, dy (and res) and writes
// dx (and dres) once, about eight flops an element.
//
// Layout: a 2-D grid, row blocks x column tiles (bn::reduce_slot: a
// block's threads lie across a tile of up to kThreads vectors of one
// row, and over kThreads / tile rows). A thread's VEC columns never
// change, so their constants (A, B, C, and s, t under ReLU) are computed
// once and stay in registers. Rows are strided over the grid, which the
// entry point sizes to the blocks the card holds at once; a thread
// issues the 16-byte loads of kRows rows before it uses any of them.

#include "batchnorm.cuh"

namespace {

using bn::kRows;  // rows a thread has in flight

template <typename T, int VEC>
__global__ void __launch_bounds__(bn::kThreads)
    bn_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                     const T* __restrict__ res, const float* __restrict__ s,
                     const float* __restrict__ t,
                     const float* __restrict__ gamma,
                     const float* __restrict__ mean,
                     const float* __restrict__ rstd,
                     const float* __restrict__ dgamma,
                     const float* __restrict__ dbeta, T* __restrict__ dx,
                     T* __restrict__ dres, long long n, int c, int relu) {
  using R = bn::Raw<T, VEC>;
  const bn::ReduceSlot slot = bn::reduce_slot(c / VEC);
  if (!slot.active) return;  // no barrier below
  const int col = slot.vcol * VEC;

  // the constants of this thread's columns
  const float inv_n = __fdiv_rn(1.f, static_cast<float>(n));
  float ka[VEC], kb[VEC], kc[VEC], ks[VEC], kt[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const float g = gamma[col + i], r = rstd[col + i];
    const float a = __fmul_rn(g, r);
    ka[i] = a;
    kb[i] = __fmul_rn(r, __fmul_rn(__fmul_rn(-a, dgamma[col + i]), inv_n));
    const float c1 = __fmul_rn(__fmul_rn(-a, dbeta[col + i]), inv_n);
    const float c2 = __fmul_rn(
        __fmul_rn(__fmul_rn(__fmul_rn(-mean[col + i], r), a),
                  dgamma[col + i]),
        inv_n);
    kc[i] = __fsub_rn(c1, c2);
    ks[i] = relu ? s[col + i] : 0.f;
    kt[i] = relu ? t[col + i] : 0.f;
  }

  const bool mask_res = relu && res != nullptr;
  const long long stride = static_cast<long long>(gridDim.x) * slot.groups;
  for (long long r0 =
           static_cast<long long>(blockIdx.x) * slot.groups + slot.group;
       r0 < n; r0 += kRows * stride) {
    R xr[kRows], dr[kRows], rr[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const long long r = r0 + k * stride;
      if (r >= n) continue;
      const size_t off = static_cast<size_t>(r) * c + col;
      xr[k] = *reinterpret_cast<const R*>(x + off);
      dr[k] = *reinterpret_cast<const R*>(dy + off);
      if (mask_res) rr[k] = *reinterpret_cast<const R*>(res + off);
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const long long r = r0 + k * stride;
      if (r >= n) break;
      const size_t off = static_cast<size_t>(r) * c + col;
      float xv[VEC], dv[VEC], rv[VEC], out[VEC];
      bn::unpack<T, VEC>(xr[k], xv);
      bn::unpack<T, VEC>(dr[k], dv);
      if (mask_res) bn::unpack<T, VEC>(rr[k], rv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        if (relu) {
          float pre = __fadd_rn(__fmul_rn(xv[i], ks[i]), kt[i]);
          if (mask_res) pre = __fadd_rn(pre, rv[i]);
          dv[i] = pre > 0.f ? dv[i] : 0.f;
        }
        out[i] = __fadd_rn(__fadd_rn(__fmul_rn(dv[i], ka[i]),
                                     __fmul_rn(xv[i], kb[i])),
                           kc[i]);
      }
      bn::store_vec<T, VEC>(dx + off, out);
      if (dres != nullptr) bn::store_vec<T, VEC>(dres + off, dv);
    }
  }
}

// Blocks of `kernel` (kThreads each) that `device` holds at once.
// `cached` (64 ints, zero at first) keeps them by device: one array per
// kernel, since the kernels of one signature share this function.
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int device, int* cached,
                            int* blocks) {
  if (device >= 0 && device < 64 && cached[device] > 0) {
    *blocks = cached[device];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      bn::kThreads, 0);
  if (err != cudaSuccess) return err;
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (device >= 0 && device < 64) cached[device] = *blocks;
  return cudaSuccess;
}

template <typename T, int VEC>
cudaError_t launch(const void* x, const void* dy, const void* res,
                   const float* s, const float* t, const float* gamma,
                   const float* mean, const float* rstd, const float* dgamma,
                   const float* dbeta, void* dx, void* dres, long long n,
                   int c, int relu, int device, cudaStream_t stream) {
  auto kernel = bn_bwd_dx_kernel<T, VEC>;
  static int cached[64] = {0};
  int resident = 0;
  const cudaError_t err = resident_blocks(kernel, device, cached, &resident);
  if (err != cudaSuccess) return err;
  const int cv = c / VEC;
  const int tile = cv < bn::kThreads ? cv : bn::kThreads;
  const int groups = bn::kThreads / tile;
  const int col_tiles = (cv + bn::kThreads - 1) / bn::kThreads;
  const long long want = (n + groups - 1) / groups;
  const long long fill = resident / col_tiles > 0 ? resident / col_tiles : 1;
  const dim3 grid(static_cast<unsigned>(want < fill ? want : fill),
                  col_tiles);
  kernel<<<grid, bn::kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const T*>(res), s, t, gamma, mean, rstd, dgamma, dbeta,
      static_cast<T*>(dx), static_cast<T*>(dres), n, c, relu);
  return cudaGetLastError();
}

}  // namespace

// x, dy, res, dx, dres: [n, c] contiguous, dtype `dtype` (kF32 / kBF16);
// res and dres null without a residual (dres is written whenever it is
// given); s, t, gamma, mean, rstd, dgamma, dbeta: [c] float32 (s and t
// are read only under ReLU); vec as in bn_apply.cu. Launches one kernel
// on `stream` of CUDA device `device`; returns cudaGetLastError() after
// it.
extern "C" int hvd_bn_bwd_dx(const void* x, const void* dy, const void* res,
                             const void* s, const void* t, const void* gamma,
                             const void* mean, const void* rstd,
                             const void* dgamma, const void* dbeta, void* dx,
                             void* dres, long long n, int c, int vec,
                             int relu, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const float* f[7] = {static_cast<const float*>(s),
                       static_cast<const float*>(t),
                       static_cast<const float*>(gamma),
                       static_cast<const float*>(mean),
                       static_cast<const float*>(rstd),
                       static_cast<const float*>(dgamma),
                       static_cast<const float*>(dbeta)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define HVD_BN_DX(T, V)                                                     \
  return launch<T, V>(x, dy, res, f[0], f[1], f[2], f[3], f[4], f[5], f[6], \
                      dx, dres, n, c, relu, device, st)
  if (dtype == kBF16 && vec == 8) HVD_BN_DX(__nv_bfloat16, 8);
  if (dtype == kBF16 && vec == 1) HVD_BN_DX(__nv_bfloat16, 1);
  if (dtype == kF32 && vec == 4) HVD_BN_DX(float, 4);
  if (dtype == kF32 && vec == 1) HVD_BN_DX(float, 1);
#undef HVD_BN_DX
  return cudaErrorInvalidValue;
}
