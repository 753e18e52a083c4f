// Shared math of the int8 wire's kernels (quant_rows.cu B11,
// quant_ef_rows.cu B12, accum_rows.cu B13, dequant_flat.cu B14): the
// block quantization of optim/compression.py, rounding step by rounding
// step.
//
//   scale = amax > 0 ? amax * (1/127) : 1      (a multiply, one rounding)
//   code  = clamp(rint(x / scale), -127, 127)  (IEEE division, ties to
//                                               even, like torch.round)
//   residual = fma(-code, scale, x)            (one rounding)
//   sum over ranks: acc = fma(code_r, scale_r, acc), acc from 0
//
// The two fused multiply-adds are where the JAX package's reference
// (XLA on the CPU) contracts `x - code * scale` and the running sum of
// `code * scale`; everywhere else each step is rounded on its own
// (`_rn` intrinsics, never contracted, and the build has no
// --use_fast_math). So the kernels are bitwise equal to the plain
// versions in ops/quantized_collectives.py and to the JAX package.
// Inputs are finite: the max ignores a NaN where torch.amax keeps it.
#pragma once

#include "common.cuh"

namespace quant {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kRecip127 = static_cast<float>(1.0 / 127.0);

__device__ __forceinline__ float scale_of(float amax) {
  return amax > 0.f ? __fmul_rn(amax, kRecip127) : 1.f;
}

// The code of v as a float; NaN (0 / 0 under a scale that underflowed
// to 0) stays NaN and converts to 0, as torch's and XLA's casts do.
__device__ __forceinline__ int8_t code_of(float v, float s) {
  float c = rintf(__fdiv_rn(v, s));
  c = c > 127.f ? 127.f : (c < -127.f ? -127.f : c);
  return static_cast<int8_t>(static_cast<int>(c));
}

__device__ __forceinline__ float dequant(int8_t q, float s) {
  return __fmul_rn(static_cast<float>(q), s);
}

// Blocks for a grid-stride loop over `items` work items of `per_block`
// each, capped where the grid-stride loop takes over.
inline int grid_for(long long items, int per_block) {
  long long blocks = (items + per_block - 1) / per_block;
  const long long cap = 132LL * 64;
  return static_cast<int>(blocks < 1 ? 1 : (blocks > cap ? cap : blocks));
}

// B11 and B12: one warp per quantization block, a grid-stride loop over
// the m / block blocks of the padded payload. Element i of the payload
// is x[i] (+ r[i] with error feedback) for i < L and 0 past it (the zero
// padding to whole rows). Pass 1 reduces |v| to the block's amax with
// shuffles; pass 2 reads the block again (from L1) and writes the codes
// and, with error feedback, the residual of the first L elements.
template <bool EF>
__global__ void __launch_bounds__(kThreads)
    quantize_kernel(const float* __restrict__ x, const float* __restrict__ r,
                    long long L, int8_t* __restrict__ q,
                    float* __restrict__ s, float* __restrict__ e,
                    long long nblocks, int block) {
  const int lane = threadIdx.x & 31;
  const long long nwarps = static_cast<long long>(gridDim.x) * kWarps;
  for (long long b = static_cast<long long>(blockIdx.x) * kWarps +
                     (threadIdx.x >> 5);
       b < nblocks; b += nwarps) {
    const long long base = b * block;
    float amax = 0.f;
    for (int j = lane; j < block; j += 32) {
      const long long i = base + j;
      float v = 0.f;
      if (i < L) v = EF ? __fadd_rn(x[i], r[i]) : x[i];
      amax = fmaxf(amax, fabsf(v));
    }
    amax = warp_max(amax);
    const float sc = scale_of(amax);
    if (lane == 0) s[b] = sc;
    for (int j = lane; j < block; j += 32) {
      const long long i = base + j;
      float v = 0.f;
      if (i < L) v = EF ? __fadd_rn(x[i], r[i]) : x[i];
      const int8_t c = code_of(v, sc);
      q[i] = c;
      if (EF && i < L) e[i] = __fmaf_rn(-static_cast<float>(c), sc, v);
    }
  }
}

}  // namespace quant
