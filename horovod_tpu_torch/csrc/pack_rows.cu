// Pack a flat gradient bucket into the (n, k) ring-shard rows of the
// ZeRO reduce-scatter: out[i] = i < L ? x[i] : 0 for i < n * k, where
// k = ceil(L / n). Row r of the row-major (n, k) output is rank r's
// shard, so the layout is the bucket followed by n * k - L zeros.
//
// Replaces: horovod_tpu/ops/pallas_collectives.py `_pack_kernel`
// (launched by `pack_rows_fused`, reached through `maybe_pack_rows` from
// the ZeRO-1 optimizer): the Pallas epilogue form of `zero._pad_rows`,
// zero-fill and copy-in in one kernel.
//
// Function: a bitwise copy. The kernel moves bytes and never looks at
// values, so one source serves float32 and the 2-byte types (bf16,
// fp16), and -0.0, NaN payloads and subnormals survive as they are.
// It folds in no scaling: the ZeRO path divides the reduced shard by n
// afterwards, and a prescale would change the bits.
//
// What bounds it on an H100: bytes, L * size read and n * k * size
// written once each (the largest BERT-Large bucket at n = 4: 130 MB
// each way, 0.078 ms at 3.35 TB/s). Design: 16-byte vector loads and
// stores where the source is 16-byte aligned (the output comes from
// torch.empty and always is), one vector per thread in a grid-stride
// loop; the vector that straddles L and the last n * k mod (16 / size)
// elements go element by element. A source that is not 16-byte
// aligned (a slice of a larger tensor) takes the element-wise loop
// throughout.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

int grid_for(long long items) {
  long long blocks = (items + kThreads - 1) / kThreads;
  const long long cap = 132LL * 32;
  return static_cast<int>(blocks < 1 ? 1 : (blocks > cap ? cap : blocks));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    pack_vec_kernel(const T* __restrict__ x, T* __restrict__ out,
                    long long length, long long total) {
  constexpr int V = 16 / sizeof(T);
  const long long nv = total / V;   // whole vectors of the output
  const long long lv = length / V;  // whole vectors of the source
  const bool ragged = length % V != 0;
  const uint4* __restrict__ xv = reinterpret_cast<const uint4*>(x);
  uint4* __restrict__ ov = reinterpret_cast<uint4*>(out);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid =
      blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  for (long long i = tid; i < nv; i += stride) {
    if (i < lv) {
      ov[i] = __ldg(xv + i);
    } else if (i > lv || !ragged) {
      ov[i] = make_uint4(0u, 0u, 0u, 0u);
    } else {  // the vector holding the bucket's last elements
      for (int j = 0; j < V; ++j) {
        const long long e = i * V + j;
        out[e] = e < length ? x[e] : T(0);
      }
    }
  }
  // the output's last total mod V elements (zeros, or the bucket's tail
  // when length > nv * V)
  for (long long e = nv * V + tid; e < total; e += stride)
    out[e] = e < length ? x[e] : T(0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    pack_elem_kernel(const T* __restrict__ x, T* __restrict__ out,
                     long long length, long long total) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < total; e += stride)
    out[e] = e < length ? x[e] : T(0);
}

template <typename T>
cudaError_t launch(const void* x, void* out, long long length,
                   long long total, cudaStream_t stream) {
  const T* xs = static_cast<const T*>(x);
  T* os = static_cast<T*>(out);
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (aligned) {
    const long long nv = total / (16 / sizeof(T));
    pack_vec_kernel<T><<<grid_for(nv > 0 ? nv : total), kThreads, 0,
                         stream>>>(xs, os, length, total);
  } else {
    pack_elem_kernel<T><<<grid_for(total), kThreads, 0, stream>>>(
        xs, os, length, total);
  }
  return cudaGetLastError();
}

}  // namespace

// x: `length` contiguous elements of `elem_size` (2 or 4) bytes; out:
// `total` (= n * k >= length) elements of the same size. Launches one
// kernel on `stream` of CUDA device `device`; returns cudaGetLastError()
// after it.
extern "C" int hvd_pack_rows(const void* x, void* out, long long length,
                             long long total, int elem_size, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (length < 0 || total < length || total <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_size) {
    case 2: return launch<uint16_t>(x, out, length, total, s);
    case 4: return launch<uint32_t>(x, out, length, total, s);
    default: return cudaErrorInvalidValue;
  }
}
