// Block quantize with error feedback: the payload plus this rank's
// residual, quantized as quant_rows.cu does, and the new residual.
//
// Replaces: horovod_tpu/ops/pallas_collectives.py `_quant_ef_kernel`
// (launched by `_quantize_ef_rows`): the first stage of the int8 wire
// with error feedback. The JAX package adds the residual and pads
// before its kernel; this one does both itself (v = x + r, one IEEE
// addition, then zeros past L), which saves two passes over the
// payload.
//
// Function: v = x + r for i < L, 0 past it; codes and scales of v per
// block (quant.cuh); residual e = v - code * scale rounded once
// (fma), for the first L elements.
//
// What bounds it on an H100: bytes. It reads 8 bytes and writes 5 for
// each element (and 4 per block). Design as quant_rows.cu.

#include "quant.cuh"

// x, r, e: L float32 elements (payload, residual in, residual out); q:
// m int8 codes and s: m / block float32 scales of the padded payload.
// Launches one kernel on `stream` of CUDA device `device`; returns
// cudaGetLastError() after it.
extern "C" int hvd_quant_ef_rows(const void* x, const void* r, long long L,
                                 void* q, void* s, void* e, long long m,
                                 int block, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (block <= 0 || m % block != 0 || L > m) return cudaErrorInvalidValue;
  const long long nblocks = m / block;
  quant::quantize_kernel<true>
      <<<quant::grid_for(nblocks, quant::kWarps), quant::kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(x), static_cast<const float*>(r), L,
          static_cast<int8_t*>(q), static_cast<float*>(s),
          static_cast<float*>(e), nblocks, block);
  return cudaGetLastError();
}
