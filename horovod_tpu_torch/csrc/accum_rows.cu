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
// block) and writes 4 bytes for each element of the shard. One thread
// per element in a grid-stride loop: a warp reads 32 neighbouring codes
// of each rank's row.

#include "quant.cuh"

namespace {

__global__ void __launch_bounds__(quant::kThreads)
    accum_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                 float* __restrict__ out, int n, long long C, int block) {
  const long long nbc = C / block;
  for (long long c = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       c < C; c += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long sb = c / block;
    float acc = 0.f;
    for (int r = 0; r < n; ++r)
      acc = __fmaf_rn(static_cast<float>(q[r * C + c]), s[r * nbc + sb],
                      acc);
    out[c] = acc;
  }
}

}  // namespace

// q: [n, C] int8 codes; s: [n, C / block] float32 scales (block divides
// C); out: [C] float32. Launches one kernel on `stream` of CUDA device
// `device`; returns cudaGetLastError() after it.
extern "C" int hvd_accum_rows(const void* q, const void* s, void* out, int n,
                              long long C, int block, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n <= 0 || block <= 0 || C % block != 0) return cudaErrorInvalidValue;
  accum_kernel<<<quant::grid_for(C, quant::kThreads), quant::kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(s),
      static_cast<float*>(out), n, C, block);
  return cudaGetLastError();
}
