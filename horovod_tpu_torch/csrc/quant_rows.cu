// Block quantize of a float32 payload to int8 codes and float32 scales,
// zero-padded to whole rows of blocks.
//
// Replaces: horovod_tpu/ops/pallas_collectives.py `_quant_kernel`
// (launched by `_quantize_rows`): the first stage of the int8 wire
// without error feedback, and the requantize of the reduced shard.
// The JAX package pads the payload before its kernel; this one reads
// the unpadded payload and writes the zero padding's codes itself,
// which saves a copy of the payload.
//
// Function: for each block of `block` elements of the payload padded
// to m, scale = amax * (1/127) (1 if the block is all zero) and code =
// clamp(rint(x / scale), -127, 127) (quant.cuh).
//
// What bounds it on an H100: bytes. It reads 4 bytes and writes 1 (and
// 4 per block) for each element; a few operations each. One warp per
// quantization block, lanes on neighbouring elements (coalesced), the
// block read twice: the second read hits L1.

#include "quant.cuh"

// x: L float32 elements; q: m int8 codes and s: m / block float32
// scales of the payload zero-padded to m (block divides m, m >= L).
// Launches one kernel on `stream` of CUDA device `device`; returns
// cudaGetLastError() after it.
extern "C" int hvd_quant_rows(const void* x, long long L, void* q, void* s,
                              long long m, int block, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (block <= 0 || m % block != 0 || L > m) return cudaErrorInvalidValue;
  const long long nblocks = m / block;
  quant::quantize_kernel<false>
      <<<quant::grid_for(nblocks, quant::kWarps), quant::kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(x), nullptr, L, static_cast<int8_t*>(q),
          static_cast<float*>(s), nullptr, nblocks, block);
  return cudaGetLastError();
}
