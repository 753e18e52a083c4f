// Shared pieces of the four BatchNorm kernels (bn_stats.cu, bn_apply.cu,
// bn_bwd_reduce.cu, bn_bwd_dx.cu), which work on the [n, c] view of a
// channels-last activation: c channels contiguous, n = N*H*W rows.
//
// Every kernel moves VEC elements per thread: 16 bytes (8 bf16 or 4
// float32) when c is a multiple of that and the tensors are 16-byte
// aligned, else 1 (the wrapper in ops/batchnorm.py picks VEC).
//
// The reductions (B7, B9) split rows over blocks: block (bx, by) sums
// rows [bx * rows_per_block, ...) of the column tile by, holding a tile
// of up to kThreads vectors across and kThreads / tile rows at a time,
// and writes one float32 row of partial sums to a [blocks, c] scratch.
// column_sum_kernel then adds the partial rows in block order: no
// atomics, so the sums do not change from run to run.
#pragma once

#include "common.cuh"

namespace bn {

constexpr int kThreads = 256;

// The elements of one vector of T at p, as float32.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         float (&out)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = to_f32<T>(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = to_f32<T>(p[i]);
  }
}

// Round VEC float32 values to T and store them at p.
template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* __restrict__ p,
                                          const float (&v)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) e[i] = from_f32<T>(v[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = from_f32<T>(v[i]);
  }
}

// ReLU as torch.relu computes it: NaN stays NaN, -0 becomes +0.
__device__ __forceinline__ float relu(float v) {
  return v != v ? v : (v > 0.f ? v : 0.f);
}

// Where a thread of a reduction block sits: column vector `vcol` of the
// row group `group` (0 .. groups-1); `active` if that column exists.
struct ReduceSlot {
  int vcol, group, groups, tile;
  bool active;
};

__device__ __forceinline__ ReduceSlot reduce_slot(int cv) {
  ReduceSlot s;
  s.tile = min(cv, kThreads);
  s.groups = kThreads / s.tile;
  s.group = threadIdx.x / s.tile;
  s.vcol = blockIdx.y * kThreads + threadIdx.x % s.tile;
  s.active = s.group < s.groups && s.vcol < cv;
  return s;
}

// Sum each thread's VEC accumulators over the row groups of its block,
// in group order, and write them to row blockIdx.x of `part` ([blocks,
// c] float32). `red` holds kThreads * VEC floats. Every thread calls it.
template <int VEC>
__device__ __forceinline__ void write_partial(const ReduceSlot& s,
                                              const float (&acc)[VEC],
                                              float* red, float* part,
                                              int c) {
  __syncthreads();
#pragma unroll
  for (int i = 0; i < VEC; ++i) red[threadIdx.x * VEC + i] = acc[i];
  __syncthreads();
  if (s.group != 0 || !s.active) return;
  const int lane = threadIdx.x % s.tile;
  float* out = part + static_cast<size_t>(blockIdx.x) * c + s.vcol * VEC;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    float v = 0.f;
    for (int g = 0; g < s.groups; ++g) v += red[(g * s.tile + lane) * VEC + i];
    out[i] = v;
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

inline cudaError_t column_sum(const float* part, float* out, int blocks,
                              int c, cudaStream_t stream) {
  column_sum_kernel<<<(c + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      part, out, blocks, c);
  return cudaGetLastError();
}

// Blocks of an elementwise pass over nvec vectors: one vector a thread,
// with a grid-stride loop past the cap.
inline int elementwise_blocks(long long nvec) {
  const long long want = (nvec + kThreads - 1) / kThreads;
  return static_cast<int>(want < (1LL << 20) ? want : (1LL << 20));
}

}  // namespace bn
