// BatchNorm backward reduction: per-channel dgamma = sum(dy_eff * xhat)
// and dbeta = sum(dy_eff), in float32, over the n rows of an [n, c]
// channels-last tensor, where xhat = x * u + w and dy_eff = dy, or with
// ReLU dy where x * s + t (+ res) > 0.
//
// Replaces: horovod_tpu/ops/pallas_batchnorm.py `_bwd_reduce_kernel`
// (run by `_run_bwd_reduce`), the first pass of `fused_batch_norm`'s
// backward.
//
// u = rstd and w = -mean * rstd are formed from the statistics in the
// prologue, w rounded as the eager `-mean * rstd` it replaces
// (`__fmul_rn(-mean, rstd)`). The ReLU mask is recomputed from x (and
// res) with the rounding of bn_apply.cu (`__fmul_rn` then `__fadd_rn`,
// then + res), so it has the forward's bits and the backward never
// reads y. The TPU kernel adds into one output block across its
// in-order grid and zeroes padded rows of x before the product (an
// out-of-bounds load times 0 could be NaN); here one launch sums strided
// rows into float32 partial rows and the last block of each column tile,
// by a ticket, adds them in a fixed order (batchnorm.cuh, `bn::reduce`:
// no atomics, deterministic), and rows past n are never loaded.
//
// What bounds it on an H100: bytes. It reads x, dy (and res) once, about
// ten flops an element; 16-byte loads along c, four rows' loads in
// flight a thread, about two blocks per SM.

#include "batchnorm.cuh"

namespace {

template <typename T, int VEC>
struct BwdRows {
  struct Loaded {
    bn::Raw<T, VEC> x, dy, res;
  };
  const T* x;
  const T* dy;
  const T* res;  // read only under ReLU; null without a residual
  bool relu;
  float s[VEC], t[VEC], u[VEC], w[VEC];

  __device__ __forceinline__ void load(Loaded& raw, size_t off) const {
    using R = bn::Raw<T, VEC>;
    raw.x = *reinterpret_cast<const R*>(x + off);
    raw.dy = *reinterpret_cast<const R*>(dy + off);
    if (relu && res != nullptr)
      raw.res = *reinterpret_cast<const R*>(res + off);
  }
  __device__ __forceinline__ void add(const Loaded& raw, float (&dg)[VEC],
                                      float (&db)[VEC]) const {
    float xv[VEC], dv[VEC], rv[VEC];
    bn::unpack<T, VEC>(raw.x, xv);
    bn::unpack<T, VEC>(raw.dy, dv);
    if (relu && res != nullptr) bn::unpack<T, VEC>(raw.res, rv);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      float d = dv[i];
      if (relu) {
        float pre = __fadd_rn(__fmul_rn(xv[i], s[i]), t[i]);
        if (res != nullptr) pre = __fadd_rn(pre, rv[i]);
        d = pre > 0.f ? d : 0.f;
      }
      const float xhat = __fadd_rn(__fmul_rn(xv[i], u[i]), w[i]);
      dg[i] = __fadd_rn(dg[i], __fmul_rn(d, xhat));
      db[i] = __fadd_rn(db[i], d);
    }
  }
};

template <typename T, int VEC>
__global__ void __launch_bounds__(bn::kThreads, bn::kBlocksPerSm)
    bn_bwd_reduce_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                         const T* __restrict__ res,
                         const float* __restrict__ s,
                         const float* __restrict__ t,
                         const float* __restrict__ mean,
                         const float* __restrict__ rstd,
                         float* __restrict__ dg, float* __restrict__ db,
                         float* part, unsigned int* ticket, long long n,
                         int c, int relu) {
  __shared__ __align__(16) float smem[bn::reduce_smem_floats<VEC>()];
  BwdRows<T, VEC> rows{x, dy, res, relu != 0};
  const bn::ReduceSlot slot = bn::reduce_slot<bn::kTileVecs>(c / VEC);
  if (slot.active) {  // this thread's columns' constants
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const int col = slot.vcol * VEC + i;
      rows.s[i] = s[col];
      rows.t[i] = t[col];
      rows.u[i] = rstd[col];
      rows.w[i] = __fmul_rn(-mean[col], rstd[col]);
    }
  }
  bn::reduce<VEC>(rows, n, c, part, ticket, smem,
                  [&](int col, float sum_dg, float sum_db) {
                    dg[col] = sum_dg;
                    db[col] = sum_db;
                  });
}

template <typename T, int VEC>
cudaError_t launch(const void* x, const void* dy, const void* res,
                   const float* s, const float* t, const float* mean,
                   const float* rstd, float* dg, float* db, float* part,
                   unsigned int* ticket, long long n, int c, int row_blocks,
                   int relu, cudaStream_t stream) {
  const dim3 grid(row_blocks, bn::reduce_col_tiles(c, VEC));
  bn_bwd_reduce_kernel<T, VEC><<<grid, bn::kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const T*>(res), s, t, mean, rstd, dg, db, part, ticket, n,
      c, relu);
  return cudaGetLastError();
}

}  // namespace

// x, dy, res: [n, c] contiguous, dtype `dtype` (kF32 / kBF16), res null
// for none; s, t, mean, rstd: [c] float32; dg, db: [c] float32 outputs;
// part: [2, row_blocks, c] float32 scratch; ticket: one zeroed uint32
// per column tile (bn::reduce_col_tiles), left zeroed; vec as in
// bn_stats.cu. Launches one kernel on `stream` of CUDA device `device`;
// returns cudaGetLastError() after it.
extern "C" int hvd_bn_bwd_reduce(const void* x, const void* dy,
                                 const void* res, const void* s,
                                 const void* t, const void* mean,
                                 const void* rstd, void* dg, void* db,
                                 void* part, void* ticket, long long n, int c,
                                 int vec, int row_blocks, int relu, int dtype,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const float* f[4] = {static_cast<const float*>(s),
                       static_cast<const float*>(t),
                       static_cast<const float*>(mean),
                       static_cast<const float*>(rstd)};
  float* g = static_cast<float*>(dg);
  float* b = static_cast<float*>(db);
  float* p = static_cast<float*>(part);
  unsigned int* tk = static_cast<unsigned int*>(ticket);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define HVD_BN_REDUCE(T, V)                                                 \
  return launch<T, V>(x, dy, res, f[0], f[1], f[2], f[3], g, b, p, tk, n, c, \
                      row_blocks, relu, st)
  if (dtype == kBF16 && vec == 8) HVD_BN_REDUCE(__nv_bfloat16, 8);
  if (dtype == kBF16 && vec == 1) HVD_BN_REDUCE(__nv_bfloat16, 1);
  if (dtype == kF32 && vec == 4) HVD_BN_REDUCE(float, 4);
  if (dtype == kF32 && vec == 1) HVD_BN_REDUCE(float, 1);
#undef HVD_BN_REDUCE
  return cudaErrorInvalidValue;
}
