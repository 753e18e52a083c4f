// BatchNorm backward reduction: per-channel dgamma = sum(dy_eff * xhat)
// and dbeta = sum(dy_eff), in float32, over the n rows of an [n, c]
// channels-last tensor, where xhat = x * u + w (u = rstd, w = -mean *
// rstd) and dy_eff = dy, or with ReLU dy where x * s + t (+ res) > 0.
//
// Replaces: horovod_tpu/ops/pallas_batchnorm.py `_bwd_reduce_kernel`
// (run by `_run_bwd_reduce`), the first pass of `fused_batch_norm`'s
// backward.
//
// The ReLU mask is recomputed from x (and res) with the rounding of
// bn_apply.cu (`__fmul_rn` then `__fadd_rn`, then + res), so it has the
// forward's bits and the backward never reads y. The TPU kernel adds
// into one output block across its in-order grid and zeroes padded rows
// of x before the product (an out-of-bounds load times 0 could be NaN);
// here each block writes its rows' sums to a float32 [blocks, c]
// scratch, a second kernel adds them in block order (no atomics,
// deterministic), and rows past n are never loaded.
//
// What bounds it on an H100: bytes. It reads x, dy (and res) once, about
// ten flops an element; 16-byte vectors along c, rows split over about 8
// blocks per SM (batchnorm.cuh).

#include "batchnorm.cuh"

namespace {

template <typename T, int VEC>
__global__ void __launch_bounds__(bn::kThreads)
    bn_bwd_reduce_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                         const T* __restrict__ res,
                         const float* __restrict__ s,
                         const float* __restrict__ t,
                         const float* __restrict__ u,
                         const float* __restrict__ w,
                         float* __restrict__ dg_part,
                         float* __restrict__ db_part, int n, int c,
                         int rows_per_block, int relu) {
  __shared__ float red[bn::kThreads * VEC];
  const bn::ReduceSlot slot = bn::reduce_slot(c / VEC);
  float dg[VEC], db[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) dg[i] = db[i] = 0.f;
  if (slot.active) {
    const int col = slot.vcol * VEC;
    float sc[VEC], tc[VEC], uc[VEC], wc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      sc[i] = s[col + i];
      tc[i] = t[col + i];
      uc[i] = u[col + i];
      wc[i] = w[col + i];
    }
    const int r0 = blockIdx.x * rows_per_block;
    const int r1 = min(n, r0 + rows_per_block);
#pragma unroll 2
    for (int r = r0 + slot.group; r < r1; r += slot.groups) {
      const size_t off = static_cast<size_t>(r) * c + col;
      float xv[VEC], dv[VEC], rv[VEC];
      bn::load_vec<T, VEC>(x + off, xv);
      bn::load_vec<T, VEC>(dy + off, dv);
      if (relu && res != nullptr) bn::load_vec<T, VEC>(res + off, rv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        float d = dv[i];
        if (relu) {
          float pre = __fadd_rn(__fmul_rn(xv[i], sc[i]), tc[i]);
          if (res != nullptr) pre = __fadd_rn(pre, rv[i]);
          d = pre > 0.f ? d : 0.f;
        }
        const float xhat = __fadd_rn(__fmul_rn(xv[i], uc[i]), wc[i]);
        dg[i] = __fadd_rn(dg[i], __fmul_rn(d, xhat));
        db[i] = __fadd_rn(db[i], d);
      }
    }
  }
  bn::write_partial<VEC>(slot, dg, red, dg_part, c);
  bn::write_partial<VEC>(slot, db, red, db_part, c);
}

template <typename T, int VEC>
cudaError_t launch(const void* x, const void* dy, const void* res,
                   const float* s, const float* t, const float* u,
                   const float* w, float* dg, float* db, float* dg_part,
                   float* db_part, int n, int c, int rows_per_block,
                   int blocks, int relu, cudaStream_t stream) {
  const int cv = c / VEC;
  const dim3 grid(blocks, (cv + bn::kThreads - 1) / bn::kThreads);
  bn_bwd_reduce_kernel<T, VEC><<<grid, bn::kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const T*>(res), s, t, u, w, dg_part, db_part, n, c,
      rows_per_block, relu);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = bn::column_sum(dg_part, dg, blocks, c, stream);
  if (err != cudaSuccess) return err;
  return bn::column_sum(db_part, db, blocks, c, stream);
}

}  // namespace

// x, dy, res: [n, c] contiguous, dtype `dtype` (kF32 / kBF16), res null
// for none; s, t, u, w: [c] float32; dg, db: [c] float32 outputs;
// dg_part, db_part: [blocks, c] float32 scratch with rows_per_block *
// blocks >= n; vec as in bn_stats.cu. Launches three kernels on
// `stream` of CUDA device `device`; returns cudaGetLastError() after.
extern "C" int hvd_bn_bwd_reduce(const void* x, const void* dy,
                                 const void* res, const void* s,
                                 const void* t, const void* u, const void* w,
                                 void* dg, void* db, void* dg_part,
                                 void* db_part, int n, int c, int vec,
                                 int rows_per_block, int blocks, int relu,
                                 int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const float* sf = static_cast<const float*>(s);
  const float* tf = static_cast<const float*>(t);
  const float* uf = static_cast<const float*>(u);
  const float* wf = static_cast<const float*>(w);
  float* g = static_cast<float*>(dg);
  float* b = static_cast<float*>(db);
  float* gp = static_cast<float*>(dg_part);
  float* bp = static_cast<float*>(db_part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16 && vec == 8)
    return launch<__nv_bfloat16, 8>(x, dy, res, sf, tf, uf, wf, g, b, gp, bp,
                                    n, c, rows_per_block, blocks, relu, st);
  if (dtype == kBF16 && vec == 1)
    return launch<__nv_bfloat16, 1>(x, dy, res, sf, tf, uf, wf, g, b, gp, bp,
                                    n, c, rows_per_block, blocks, relu, st);
  if (dtype == kF32 && vec == 4)
    return launch<float, 4>(x, dy, res, sf, tf, uf, wf, g, b, gp, bp, n, c,
                            rows_per_block, blocks, relu, st);
  if (dtype == kF32 && vec == 1)
    return launch<float, 1>(x, dy, res, sf, tf, uf, wf, g, b, gp, bp, n, c,
                            rows_per_block, blocks, relu, st);
  return cudaErrorInvalidValue;
}
