// LayerNorm / RMSNorm backward over the last axis of an [N, C] tensor.
//
// Replaces: horovod_tpu/ops/pallas_layernorm.py `_bwd_kernel` (run by
// `_run_bwd`), the TPU kernel behind `fused_layer_norm`'s VJP.
//
// Math (the TPU kernel's): per row, mean and rstd are recomputed
// exactly as layernorm_fwd.cu computes them (same thread-to-column
// mapping and reductions, so the same bits), then in float32
//   xhat = (x - mean) * rstd,           gdy = dy * gamma
//   s1 = sum(gdy) / C,                  s2 = sum(gdy * xhat) / C
//   dx = rstd * (gdy - s1 - xhat * s2)  (RMSNorm: no s1 term)
//   dgamma = sum_rows(dy * xhat),       dbeta = sum_rows(dy)
// with dx stored in x's dtype. Elementwise steps use the _rn
// intrinsics so nothing is contracted into an FMA.
//
// The TPU kernel adds dgamma/dbeta into one output block across its
// in-order grid. Blocks here run in parallel and in no order, so each
// block writes the column sums of its own rows to a float32 [blocks, C]
// scratch and a second kernel sums those in block order: no atomics,
// and the result does not change from run to run.
//
// What bounds it on an H100: bytes. It reads x and dy and writes dx
// ([N, C] each) and does ~20 flops per element, far below the card's
// flops per byte.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;   // as layernorm_fwd.cu: same reductions
constexpr int kMaxCols = 16;    // columns per thread, so C <= 4096

template <typename T>
__global__ void __launch_bounds__(kThreads)
    layernorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                         const float* __restrict__ gamma, T* __restrict__ dx,
                         float* __restrict__ dg_part,
                         float* __restrict__ db_part, int n, int c,
                         int rows_per_block, float eps, int rms) {
  __shared__ float scratch[32];
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(n, r0 + rows_per_block);
  const float cf = static_cast<float>(c);

  float g[kMaxCols], dg[kMaxCols], db[kMaxCols];
#pragma unroll
  for (int i = 0; i < kMaxCols; ++i) {
    const int col = threadIdx.x + i * kThreads;
    g[i] = col < c ? gamma[col] : 0.f;
    dg[i] = db[i] = 0.f;
  }

  for (int r = r0; r < r1; ++r) {
    const T* xr = x + static_cast<size_t>(r) * c;
    const T* dyr = dy + static_cast<size_t>(r) * c;
    float xv[kMaxCols], dyv[kMaxCols];
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxCols; ++i) {
      const int col = threadIdx.x + i * kThreads;
      xv[i] = col < c ? to_f32(xr[col]) : 0.f;
      dyv[i] = col < c ? to_f32(dyr[col]) : 0.f;
      if (col < c) {
        s += xv[i];
        ss = fmaf(xv[i], xv[i], ss);
      }
    }
    s = block_sum(s, scratch);
    ss = block_sum(ss, scratch);
    float mean, var;
    if (rms) {
      mean = 0.f;
      var = __fdiv_rn(ss, cf);
    } else {
      mean = __fdiv_rn(s, cf);
      var = fmaxf(__fsub_rn(__fdiv_rn(ss, cf), __fmul_rn(mean, mean)), 0.f);
    }
    const float rstd = __frcp_rn(__fsqrt_rn(__fadd_rn(var, eps)));

    float a1 = 0.f, a2 = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxCols; ++i) {
      if (threadIdx.x + i * kThreads < c) {
        const float xhat = __fmul_rn(__fsub_rn(xv[i], mean), rstd);
        const float gdy = __fmul_rn(dyv[i], g[i]);
        a1 += gdy;
        a2 = fmaf(gdy, xhat, a2);
        xv[i] = xhat;  // x is not needed past here
      }
    }
    const float s1 = rms ? 0.f : __fdiv_rn(block_sum(a1, scratch), cf);
    const float s2 = __fdiv_rn(block_sum(a2, scratch), cf);

    T* dxr = dx + static_cast<size_t>(r) * c;
#pragma unroll
    for (int i = 0; i < kMaxCols; ++i) {
      const int col = threadIdx.x + i * kThreads;
      if (col < c) {
        const float xhat = xv[i];
        const float gdy = __fmul_rn(dyv[i], g[i]);
        const float inner = rms ? gdy : __fsub_rn(gdy, s1);
        const float d = __fmul_rn(rstd, __fsub_rn(inner, __fmul_rn(xhat, s2)));
        dxr[col] = from_f32<T>(d);
        dg[i] = fmaf(dyv[i], xhat, dg[i]);
        db[i] += dyv[i];
      }
    }
  }

  float* dgp = dg_part + static_cast<size_t>(blockIdx.x) * c;
  float* dbp = db_part == nullptr
                   ? nullptr
                   : db_part + static_cast<size_t>(blockIdx.x) * c;
#pragma unroll
  for (int i = 0; i < kMaxCols; ++i) {
    const int col = threadIdx.x + i * kThreads;
    if (col < c) {
      dgp[col] = dg[i];
      if (dbp != nullptr) dbp[col] = db[i];
    }
  }
}

// out[col] = sum over blocks b = 0, 1, ... of part[b, col], in order.
__global__ void __launch_bounds__(kThreads)
    column_sum_kernel(const float* __restrict__ part, float* __restrict__ out,
                      int blocks, int c) {
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= c) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += part[static_cast<size_t>(b) * c + col];
  out[col] = s;
}

template <typename T>
cudaError_t launch(const void* x, const void* dy, const float* gamma,
                   void* dx, float* dg, float* db, float* dg_part,
                   float* db_part, int n, int c, int rows_per_block,
                   int blocks, float eps, int rms, cudaStream_t stream) {
  layernorm_bwd_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), gamma,
      static_cast<T*>(dx), dg_part, db_part, n, c, rows_per_block, eps, rms);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int col_blocks = (c + kThreads - 1) / kThreads;
  column_sum_kernel<<<col_blocks, kThreads, 0, stream>>>(dg_part, dg, blocks,
                                                         c);
  if (db != nullptr)
    column_sum_kernel<<<col_blocks, kThreads, 0, stream>>>(db_part, db,
                                                           blocks, c);
  return cudaGetLastError();
}

}  // namespace

// x, dy, dx: [n, c] contiguous, dtype `dtype` (kF32 / kBF16), c <= 4096;
// gamma, dg, db: [c] float32 (db and db_part null without a beta);
// dg_part, db_part: [blocks, c] float32 scratch, rows_per_block * blocks
// >= n. Launches both kernels on `stream` of CUDA device `device`;
// returns cudaGetLastError() after them.
extern "C" int hvd_layernorm_bwd(const void* x, const void* dy,
                                 const void* gamma, void* dx, void* dg,
                                 void* db, void* dg_part, void* db_part,
                                 int n, int c, int rows_per_block, int blocks,
                                 float eps, int rms, int dtype, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (c > kThreads * kMaxCols) return cudaErrorInvalidValue;
  const float* g = static_cast<const float*>(gamma);
  float* dgf = static_cast<float*>(dg);
  float* dbf = static_cast<float*>(db);
  float* dgp = static_cast<float*>(dg_part);
  float* dbp = static_cast<float*>(db_part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(x, dy, g, dx, dgf, dbf, dgp, dbp, n, c,
                                 rows_per_block, blocks, eps, rms, s);
  if (dtype == kF32)
    return launch<float>(x, dy, g, dx, dgf, dbf, dgp, dbp, n, c,
                         rows_per_block, blocks, eps, rms, s);
  return cudaErrorInvalidValue;
}
