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
// each way, 0.078 ms at 3.35 TB/s). 260 MB stream through a 50 MB L2,
// and nothing reads them again before the reduce-scatter.
//
// Design, where the source and the output are 16-byte aligned (the
// output comes from torch.empty and always is): block b copies the
// kTileUnroll x kThreads 16-byte vectors of the source's whole vectors
// [0, L / V) (V = 16 bytes of elements) from b x that, each thread
// kTileUnroll vectors kThreads apart with all its loads before its
// stores, a block a tile (no grid-stride loop): neighbouring blocks
// stream neighbouring bytes, as PyTorch's own copy does. On an H100 it
// runs level with `copy_` of the same bytes; a persistent grid with
// four streaming-hint loads in flight a thread, and 1-D TMA bulk copies
// through an mbarrier ring, both ran about 7% behind (PERF.md). The
// zeros are a loop of their own (at most n - 1 elements), one thread
// writes the vector that straddles L, and the last n * k mod V elements
// go element by element. A source that is not 16-byte aligned (a slice
// of a larger tensor) takes the element-wise kernel throughout.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileUnroll = 2;  // 16-byte vectors a thread

int grid_for(long long items) {
  long long blocks = (items + kThreads - 1) / kThreads;
  const long long cap = 132LL * 32;
  return static_cast<int>(blocks < 1 ? 1 : (blocks > cap ? cap : blocks));
}

// The output past the source's whole vectors: zeros from the first
// vector after the bucket's last element, the straddling vector (thread
// 0 of the range), and the output's last total mod V elements (zeros,
// or the bucket's tail when length > nv * V). Thread `tid` of `stride`.
template <typename T>
__device__ __forceinline__ void pack_rest(const T* __restrict__ x,
                                          T* __restrict__ out,
                                          long long length, long long total,
                                          long long tid, long long stride) {
  constexpr int V = 16 / sizeof(T);
  const long long nv = total / V;   // whole vectors of the output
  const long long lv = length / V;  // whole vectors of the source
  const bool ragged = length % V != 0;
  uint4* __restrict__ ov = reinterpret_cast<uint4*>(out);
  for (long long i = lv + ragged + tid; i < nv; i += stride)
    __stcs(ov + i, make_uint4(0u, 0u, 0u, 0u));
  if (tid == 0 && ragged && lv < nv) {
    for (int j = 0; j < V; ++j) {
      const long long e = lv * V + j;
      out[e] = e < length ? x[e] : T(0);
    }
  }
  for (long long e = nv * V + tid; e < total; e += stride)
    out[e] = e < length ? x[e] : T(0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    pack_tiles_kernel(const T* __restrict__ x, T* __restrict__ out,
                      long long length, long long total) {
  constexpr int V = 16 / sizeof(T);
  const long long lv = length / V;
  const uint4* __restrict__ xv = reinterpret_cast<const uint4*>(x);
  uint4* __restrict__ ov = reinterpret_cast<uint4*>(out);
  const long long first =
      blockIdx.x * static_cast<long long>(kThreads * kTileUnroll) +
      threadIdx.x;
  uint4 v[kTileUnroll];
#pragma unroll
  for (int u = 0; u < kTileUnroll; ++u) {
    const long long i = first + u * kThreads;
    if (i < lv) v[u] = xv[i];
  }
#pragma unroll
  for (int u = 0; u < kTileUnroll; ++u) {
    const long long i = first + u * kThreads;
    if (i < lv) ov[i] = v[u];
  }
  pack_rest(x, out, length, total,
            blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x,
            static_cast<long long>(gridDim.x) * kThreads);
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
  constexpr int V = 16 / sizeof(T);
  if (aligned) {
    const long long tile = kThreads * kTileUnroll;
    const long long blocks = (length / V + tile - 1) / tile;
    pack_tiles_kernel<T><<<static_cast<int>(blocks < 1 ? 1 : blocks),
                           kThreads, 0, stream>>>(xs, os, length, total);
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
