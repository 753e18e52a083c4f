// BatchNorm statistics: per-channel sum and sum of squares, in float32,
// over the n rows of an [n, c] channels-last tensor (bf16 or float32).
//
// Replaces: horovod_tpu/ops/pallas_batchnorm.py `_stats_kernel` (run by
// `_run_stats`), the first pass of `fused_batch_norm`'s forward.
//
// The TPU kernel adds each row block into one output block across its
// in-order grid (`sum_ref[...] +=`) and masks the row tail with an iota
// guard. Blocks here run in parallel and in no order, so each block
// writes the sums of its own rows to a float32 [blocks, c] scratch and a
// second kernel adds those rows up in block order (batchnorm.cuh): no
// float atomics, the same bits on every run. Rows past n are never
// loaded, which is the tail mask. The TPU's fold of c < 128 channels
// into lanes is a layout device of the TPU and has no counterpart here.
//
// What bounds it on an H100: bytes. It reads x once (2 or 4 bytes an
// element) and does 3 flops an element. Each thread loads 16-byte
// vectors along c, and the wrapper splits the rows over about 8 blocks
// per SM, so even [6272, 2048] fills the 132 SMs.

#include "batchnorm.cuh"

namespace {

template <typename T, int VEC>
__global__ void __launch_bounds__(bn::kThreads)
    bn_stats_kernel(const T* __restrict__ x, float* __restrict__ sum_part,
                    float* __restrict__ sq_part, int n, int c,
                    int rows_per_block) {
  __shared__ float red[bn::kThreads * VEC];
  const bn::ReduceSlot slot = bn::reduce_slot(c / VEC);
  float s[VEC], q[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) s[i] = q[i] = 0.f;
  if (slot.active) {
    const int r0 = blockIdx.x * rows_per_block;
    const int r1 = min(n, r0 + rows_per_block);
    const T* col = x + static_cast<size_t>(slot.vcol) * VEC;
#pragma unroll 4
    for (int r = r0 + slot.group; r < r1; r += slot.groups) {
      float v[VEC];
      bn::load_vec<T, VEC>(col + static_cast<size_t>(r) * c, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        s[i] = __fadd_rn(s[i], v[i]);
        q[i] = __fadd_rn(q[i], __fmul_rn(v[i], v[i]));
      }
    }
  }
  bn::write_partial<VEC>(slot, s, red, sum_part, c);
  bn::write_partial<VEC>(slot, q, red, sq_part, c);
}

template <typename T, int VEC>
cudaError_t launch(const void* x, float* sum, float* sq, float* sum_part,
                   float* sq_part, int n, int c, int rows_per_block,
                   int blocks, cudaStream_t stream) {
  const int cv = c / VEC;
  const dim3 grid(blocks, (cv + bn::kThreads - 1) / bn::kThreads);
  bn_stats_kernel<T, VEC><<<grid, bn::kThreads, 0, stream>>>(
      static_cast<const T*>(x), sum_part, sq_part, n, c, rows_per_block);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = bn::column_sum(sum_part, sum, blocks, c, stream);
  if (err != cudaSuccess) return err;
  return bn::column_sum(sq_part, sq, blocks, c, stream);
}

}  // namespace

// x: [n, c] contiguous, dtype `dtype` (kF32 / kBF16); sum, sq: [c]
// float32 outputs; sum_part, sq_part: [blocks, c] float32 scratch with
// rows_per_block * blocks >= n; vec: elements a thread moves at once
// (16 bytes' worth, c a multiple of it and x 16-byte aligned, or 1).
// Launches three kernels on `stream` of CUDA device `device`; returns
// cudaGetLastError() after them.
extern "C" int hvd_bn_stats(const void* x, void* sum, void* sq,
                            void* sum_part, void* sq_part, int n, int c,
                            int vec, int rows_per_block, int blocks,
                            int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  float* s = static_cast<float*>(sum);
  float* q = static_cast<float*>(sq);
  float* sp = static_cast<float*>(sum_part);
  float* qp = static_cast<float*>(sq_part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16 && vec == 8)
    return launch<__nv_bfloat16, 8>(x, s, q, sp, qp, n, c, rows_per_block,
                                    blocks, st);
  if (dtype == kBF16 && vec == 1)
    return launch<__nv_bfloat16, 1>(x, s, q, sp, qp, n, c, rows_per_block,
                                    blocks, st);
  if (dtype == kF32 && vec == 4)
    return launch<float, 4>(x, s, q, sp, qp, n, c, rows_per_block, blocks,
                            st);
  if (dtype == kF32 && vec == 1)
    return launch<float, 1>(x, s, q, sp, qp, n, c, rows_per_block, blocks,
                            st);
  return cudaErrorInvalidValue;
}
