// BatchNorm statistics: per-channel sum and sum of squares, in float32,
// over the n rows of an [n, c] channels-last tensor (bf16 or float32),
// and the forward's per-channel constants folded from them.
//
// Replaces: horovod_tpu/ops/pallas_batchnorm.py `_stats_kernel` (run by
// `_run_stats`), the first pass of `fused_batch_norm`'s forward, and the
// [c]-sized arithmetic between it and the apply pass, which the JAX
// package leaves to XLA.
//
// The TPU kernel adds each row block into one output block across its
// in-order grid (`sum_ref[...] +=`) and masks the row tail with an iota
// guard. Here one launch does it all (batchnorm.cuh, `bn::reduce`):
// row blocks sum strided rows into float32 partial rows, and the last
// block of each column tile, by a ticket, adds the partial rows in a
// fixed order: no float atomics, the same bits on every run. Rows past n
// are never loaded, which is the tail mask. The TPU's fold of c < 128
// channels into lanes is a layout device of the TPU and has no
// counterpart here.
//
// The finishing block also folds the constants of each channel, with
// the rounding of the eager chain they replace (ops/batchnorm.py
// `bn_fwd_constants_ref`, as PyTorch runs it on the card):
//   mean = sum * (1 / n)        (PyTorch divides a float32 tensor by a
//   var  = clamp(sumsq * (1/n) - mean * mean, min=0)   Python float as
//   rstd = rsqrtf(var + eps)     a product with the float32 reciprocal;
//   s    = gamma * rstd          torch.clamp keeps NaN; torch.rsqrt is
//   t    = beta - mean * s       rsqrtf)
// each step rounded on its own (`_rn` intrinsics, no FMA contraction),
// so they are bitwise the chain's on these sums.
//
// What bounds it on an H100: bytes. It reads x once (2 or 4 bytes an
// element) and does 3 flops an element. 16-byte loads along c, four
// rows in flight a thread, about two blocks per SM; the partial rows
// are at most 1/32 of x's bytes (ops/batchnorm.py `reduce_geometry`).

#include "batchnorm.cuh"

namespace {

template <typename T, int VEC>
struct StatsRows {
  using Loaded = bn::Raw<T, VEC>;
  const T* x;

  __device__ __forceinline__ void load(Loaded& raw, size_t off) const {
    raw = *reinterpret_cast<const Loaded*>(x + off);
  }
  __device__ __forceinline__ void add(const Loaded& raw, float (&s)[VEC],
                                      float (&q)[VEC]) const {
    float v[VEC];
    bn::unpack<T, VEC>(raw, v);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      s[i] = __fadd_rn(s[i], v[i]);
      q[i] = __fadd_rn(q[i], __fmul_rn(v[i], v[i]));
    }
  }
};

// out: [7, c] float32, rows sum, sumsq, mean, var, rstd, s, t.
template <typename T, int VEC>
__global__ void __launch_bounds__(bn::kThreads, bn::kBlocksPerSm)
    bn_stats_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                    const float* __restrict__ beta, float eps,
                    float* __restrict__ out, float* part,
                    unsigned int* ticket, long long n, int c) {
  __shared__ __align__(16) float smem[bn::reduce_smem_floats<VEC>()];
  const float inv_n = __fdiv_rn(1.f, static_cast<float>(n));
  bn::reduce<VEC>(
      StatsRows<T, VEC>{x}, n, c, part, ticket, smem,
      [&](int col, float sum, float sumsq) {
        const float mean = __fmul_rn(sum, inv_n);
        float var = __fsub_rn(__fmul_rn(sumsq, inv_n), __fmul_rn(mean, mean));
        var = var != var ? var : (var > 0.f ? var : 0.f);
        const float rstd = rsqrtf(__fadd_rn(var, eps));
        const float s = __fmul_rn(gamma[col], rstd);
        const float t = __fsub_rn(beta[col], __fmul_rn(mean, s));
        out[col] = sum;
        out[c + col] = sumsq;
        out[2 * c + col] = mean;
        out[3 * c + col] = var;
        out[4 * c + col] = rstd;
        out[5 * c + col] = s;
        out[6 * c + col] = t;
      });
}

template <typename T, int VEC>
cudaError_t launch(const void* x, const float* gamma, const float* beta,
                   float eps, float* out, float* part, unsigned int* ticket,
                   long long n, int c, int row_blocks, cudaStream_t stream) {
  const dim3 grid(row_blocks, bn::reduce_col_tiles(c, VEC));
  bn_stats_kernel<T, VEC><<<grid, bn::kThreads, 0, stream>>>(
      static_cast<const T*>(x), gamma, beta, eps, out, part, ticket, n, c);
  return cudaGetLastError();
}

}  // namespace

// x: [n, c] contiguous, dtype `dtype` (kF32 / kBF16); gamma, beta: [c]
// float32; out: [7, c] float32 (sum, sumsq, mean, var, rstd, s, t);
// part: [2, row_blocks, c] float32 scratch; ticket: one zeroed uint32 per
// column tile (bn::reduce_col_tiles), left zeroed; vec: elements a thread
// moves at once (16 bytes' worth, c a multiple of it and x 16-byte
// aligned, or 1). Launches one kernel on `stream` of CUDA device
// `device`; returns cudaGetLastError() after it.
extern "C" int hvd_bn_stats(const void* x, const void* gamma,
                            const void* beta, float eps, void* out,
                            void* part, void* ticket, long long n, int c,
                            int vec, int row_blocks, int dtype, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  float* o = static_cast<float*>(out);
  float* p = static_cast<float*>(part);
  unsigned int* tk = static_cast<unsigned int*>(ticket);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define HVD_BN_STATS(T, V) \
  return launch<T, V>(x, g, b, eps, o, p, tk, n, c, row_blocks, st)
  if (dtype == kBF16 && vec == 8) HVD_BN_STATS(__nv_bfloat16, 8);
  if (dtype == kBF16 && vec == 1) HVD_BN_STATS(__nv_bfloat16, 1);
  if (dtype == kF32 && vec == 4) HVD_BN_STATS(float, 4);
  if (dtype == kF32 && vec == 1) HVD_BN_STATS(float, 1);
#undef HVD_BN_STATS
  return cudaErrorInvalidValue;
}
