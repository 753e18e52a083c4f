// Shared layout of the CUDA-core flash-attention kernels (flash_fwd.cu,
// flash_bwd_dq.cu, flash_bwd_dkv.cu).
//
// Tensors are [B*H, T, D] contiguous (the [B, H, T, D] layout of the
// JAX package's kernels); lse and delta are [B*H, Tq] float32.
//
// A block keeps kRows rows resident (queries for the forward and dQ,
// keys for dK/dV), one row per group of kParts neighbouring threads of
// one warp: each thread holds kDims of the row's D values in registers
// (at most 32), so a row's dot products are partial sums that meet in
// one or two warp shuffles. The other operand streams through shared
// memory in tiles of kTile rows, converted to float32 once per tile.
// Thread `part` of a row owns the float4 chunks part, part + kParts,
// ..., so the lanes of a row read neighbouring 16-byte chunks of a
// shared row and never share a bank.
//
// Every product is a float32 FMA on the CUDA cores. Only the float32
// kernels (forward, dQ, dK/dV) run here; in bf16 all three run on the
// tensor cores (flash_mma.cuh).
#pragma once

#include "common.cuh"

namespace flash {

constexpr float kNegInf = -1e30f;  // the TPU kernels' NEG_INF
constexpr int kRows = 64;          // resident rows per block

template <int D>
struct Shape {
  static_assert(D % 16 == 0 && D >= 16 && D <= 128, "head_dim");
  static constexpr int kParts = D <= 32 ? 1 : D / 32;  // threads per row
  static constexpr int kDims = D / kParts;             // values per thread
  static constexpr int kChunks = kDims / 4;            // float4 per thread
  static constexpr int kThreads = kRows * kParts;
  static constexpr int kTile = D <= 64 ? 32 : 16;      // streamed rows
};

// Offset in a row of this thread's c-th float4 chunk.
template <int D>
__device__ __forceinline__ int chunk_at(int c, int part) {
  return (c * Shape<D>::kParts + part) * 4;
}

// Sum of a partial value over the kParts threads of a row. xor-shuffles
// give every lane of the row the same bits (float addition commutes).
template <int D>
__device__ __forceinline__ float sum_parts(float v) {
#pragma unroll
  for (int off = 1; off < Shape<D>::kParts; off <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// This thread's share of dot(a, row): `a` holds its kDims values, `row`
// is a float32 row of D values in shared memory.
template <int D>
__device__ __forceinline__ float dot_part(const float* a, const float* row,
                                          int part) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < Shape<D>::kChunks; ++c) {
    const float4 w =
        *reinterpret_cast<const float4*>(row + chunk_at<D>(c, part));
    s = fmaf(a[4 * c + 0], w.x, s);
    s = fmaf(a[4 * c + 1], w.y, s);
    s = fmaf(a[4 * c + 2], w.z, s);
    s = fmaf(a[4 * c + 3], w.w, s);
  }
  return s;
}

// acc += p * row over this thread's values.
template <int D>
__device__ __forceinline__ void axpy_part(float* acc, float p,
                                          const float* row, int part) {
#pragma unroll
  for (int c = 0; c < Shape<D>::kChunks; ++c) {
    const float4 w =
        *reinterpret_cast<const float4*>(row + chunk_at<D>(c, part));
    acc[4 * c + 0] = fmaf(p, w.x, acc[4 * c + 0]);
    acc[4 * c + 1] = fmaf(p, w.y, acc[4 * c + 1]);
    acc[4 * c + 2] = fmaf(p, w.z, acc[4 * c + 2]);
    acc[4 * c + 3] = fmaf(p, w.w, acc[4 * c + 3]);
  }
}

// This thread's values of a global row (zeros when !live).
template <typename T, int D>
__device__ __forceinline__ void load_part(float* r, const T* row, int part,
                                          bool live) {
#pragma unroll
  for (int c = 0; c < Shape<D>::kChunks; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      r[4 * c + e] = live ? to_f32(row[chunk_at<D>(c, part) + e]) : 0.f;
}

// Store round(r * mul) into this thread's values of a global row.
template <typename T, int D>
__device__ __forceinline__ void store_part(T* row, const float* r, float mul,
                                           int part) {
#pragma unroll
  for (int c = 0; c < Shape<D>::kChunks; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      row[chunk_at<D>(c, part) + e] = from_f32<T>(__fmul_rn(r[4 * c + e], mul));
}

// Rows [row0, row0 + rows) of a [n_rows, D] matrix into float32 shared
// memory, zeros past n_rows. Consecutive threads read consecutive
// elements. Every thread of the block must call it.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int rows, int n_rows) {
  const T* base = src + static_cast<size_t>(row0) * D;
  const int live = min(rows, n_rows - row0) * D;
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x)
    dst[i] = i < live ? to_f32(base[i]) : 0.f;
}

// Is key `kj` visible to query `qi`? K bounds, and the causal mask on
// global positions (the callers' sequence offsets added).
__device__ __forceinline__ bool visible(int qi, int kj, int tk, int causal,
                                        int q_off, int k_off) {
  return kj < tk && (!causal || q_off + qi >= k_off + kj);
}

// Number of leading kv tiles a query block [q_base, q_last] can see
// under the causal mask (the TPU kernels' `_causal_kv_limit`).
__device__ __forceinline__ int causal_kv_limit(int q_last, int q_off,
                                               int k_off, int tile,
                                               int n_tiles) {
  const int last_k = q_off + q_last - k_off;  // last visible key row
  if (last_k < 0) return 0;
  return min(n_tiles, last_k / tile + 1);
}

}  // namespace flash

// Dispatch a head_dim to a template instantiation; `body` is a lambda
// taking a std::integral_constant<int, D>.
#include <type_traits>
template <typename F>
cudaError_t with_head_dim(int d, F&& body) {
  switch (d) {
    case 16: return body(std::integral_constant<int, 16>{});
    case 32: return body(std::integral_constant<int, 32>{});
    case 64: return body(std::integral_constant<int, 64>{});
    case 128: return body(std::integral_constant<int, 128>{});
    default: return cudaErrorInvalidValue;
  }
}
