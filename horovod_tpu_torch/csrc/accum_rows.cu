// Dequantize-accumulate: the n ranks' int8 chunks of this rank's shard
// (the all-to-all's output) summed in float32.
//
// Replaces: horovod_tpu/ops/pallas_collectives.py `_accum_kernel`
// (launched by `_accum_rows`): the local reduce of the int8 wire.
//
// Function: out[c] = sum over r = 0..n-1 of q[r, c] * s[r, c / block],
// in rank order, each step acc = fma(q, s, acc) rounded once from acc =
// 0 (quant.cuh), so every run and every rank gives the same bits. No
// atomics.
//
// What bounds it on an H100: bytes. It reads n bytes (and n scales per
// block) and writes 4 bytes for each element of the shard.
//
// Two routes, picked by the wrapper (ops/quantized_collectives.py
// `accum_route`):
// - vector (C, block a multiple of 16, q and out 16-byte aligned): a
//   thread sums kCodes = 16 consecutive codes, which lie in one scale
//   block. It issues the 16-byte loads of up to kRanksInFlight ranks'
//   codes and their scales before it uses any of them (more ranks go in
//   further rounds of that many, in rank order), and writes the 16 sums
//   as four 16-byte stores. One vector a thread; the grid covers them.
// - element (anything else): one thread per element in a grid-stride
//   loop, a 1-byte load and a scale load per rank.

#include "quant.cuh"

namespace {

constexpr int kCodes = 16;         // codes a vector thread sums
constexpr int kRanksInFlight = 8;  // ranks a vector thread loads at once

// CODES = kCodes: the vector route; CODES = 1: the element route.
template <int CODES>
__global__ void __launch_bounds__(quant::kThreads)
    accum_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                 float* __restrict__ out, int n, long long C, int block) {
  const long long nbc = C / block;
  const long long items = C / CODES;
  for (long long v = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       v < items; v += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long c0 = v * CODES;
    const long long sb = c0 / block;
    if constexpr (CODES == 1) {
      float acc = 0.f;
      for (int r = 0; r < n; ++r)
        acc = __fmaf_rn(static_cast<float>(q[r * C + c0]), s[r * nbc + sb],
                        acc);
      out[c0] = acc;
    } else {
      float acc[CODES];
#pragma unroll
      for (int j = 0; j < CODES; ++j) acc[j] = 0.f;
      for (int r0 = 0; r0 < n; r0 += kRanksInFlight) {
        int4 raw[kRanksInFlight];
        float sc[kRanksInFlight];
#pragma unroll
        for (int k = 0; k < kRanksInFlight; ++k) {
          const int r = r0 + k;
          if (r >= n) break;
          raw[k] = *reinterpret_cast<const int4*>(q + r * C + c0);
          sc[k] = s[r * nbc + sb];
        }
#pragma unroll
        for (int k = 0; k < kRanksInFlight; ++k) {
          if (r0 + k >= n) break;
          const int8_t* e = reinterpret_cast<const int8_t*>(&raw[k]);
#pragma unroll
          for (int j = 0; j < CODES; ++j)
            acc[j] = __fmaf_rn(static_cast<float>(e[j]), sc[k], acc[j]);
        }
      }
      float4* o = reinterpret_cast<float4*>(out + c0);
#pragma unroll
      for (int j = 0; j < CODES / 4; ++j)
        o[j] = make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2],
                           acc[4 * j + 3]);
    }
  }
}

}  // namespace

// q: [n, C] int8 codes; s: [n, C / block] float32 scales (block divides
// C); out: [C] float32; codes: codes a thread sums, kCodes (C and block
// multiples of it, q and out 16-byte aligned) or 1. Launches one kernel
// on `stream` of CUDA device `device`; returns cudaGetLastError() after
// it.
extern "C" int hvd_accum_rows(const void* q, const void* s, void* out, int n,
                              long long C, int block, int codes, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n <= 0 || block <= 0 || C % block != 0) return cudaErrorInvalidValue;
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(s);
  float* op = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (codes == kCodes) {
    if (C % kCodes != 0 || block % kCodes != 0 ||
        reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(out) % 16 != 0)
      return cudaErrorInvalidValue;
    const long long blocks =
        (C / kCodes + quant::kThreads - 1) / quant::kThreads;
    accum_kernel<kCodes><<<static_cast<unsigned>(
                               blocks < INT_MAX ? blocks : INT_MAX),
                           quant::kThreads, 0, st>>>(qp, sp, op, n, C,
                                                     block);
  } else if (codes == 1) {
    accum_kernel<1><<<quant::grid_for(C, quant::kThreads), quant::kThreads,
                      0, st>>>(qp, sp, op, n, C, block);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
