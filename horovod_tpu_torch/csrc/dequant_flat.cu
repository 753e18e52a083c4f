// Dequantize a flat int8 payload with its per-block float32 scales.
//
// Replaces: horovod_tpu/ops/pallas_collectives.py `_dequant_kernel`
// (launched by `_dequantize_flat`): the last stage of the int8 wire,
// on the all-gathered shards. The JAX package slices the padding off
// after its kernel; this one writes only the first `length` elements.
//
// Function: out[i] = q[i] * s[i / block], one IEEE multiply, for i <
// length.
//
// What bounds it on an H100: bytes. It reads 1 byte (and a scale per
// block) and writes 4 for each element. One thread per element in a
// grid-stride loop.

#include "quant.cuh"

namespace {

__global__ void __launch_bounds__(quant::kThreads)
    dequant_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                   float* __restrict__ out, long long length, int block) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < length; i += static_cast<long long>(gridDim.x) * blockDim.x)
    out[i] = quant::dequant(q[i], s[i / block]);
}

}  // namespace

// q: int8 codes and s: float32 scales of at least `length` elements
// (one scale per `block`); out: [length] float32. Launches one kernel on
// `stream` of CUDA device `device`; returns cudaGetLastError() after it.
extern "C" int hvd_dequant_flat(const void* q, const void* s, void* out,
                                long long length, int block, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (block <= 0) return cudaErrorInvalidValue;
  dequant_kernel<<<quant::grid_for(length, quant::kThreads), quant::kThreads,
                   0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(s),
      static_cast<float*>(out), length, block);
  return cudaGetLastError();
}
