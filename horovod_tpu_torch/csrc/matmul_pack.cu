// Matrix product whose output tiles land straight in the (n, k) ring
// rows of a reduce-scatter: out[i * N + j] = sum_p a[i, p] * b[p, j]
// in float32 for i < M, j < N, and out[e] = 0 for M * N <= e < n * k,
// where k = ceil(M * N / n). The row-major (n, k) layout of a row-major
// [M, N] product is the flat product followed by the padding, so the
// epilogue writes tile (i, j) at i * N + j and the kernel also zeroes
// the tail (the wrapper allocates the output with torch.empty).
//
// Replaces: horovod_tpu/ops/pallas_collectives.py `_matmul_pack_kernel`
// (launched by `_matmul_pack` under `matmul_reduce_scatter`): a
// gradient matmul fused with the ZeRO reduce-scatter's pack, whose
// product the TPU kernel computes in its own body (`jnp.dot` with
// float32 accumulation). So does this one: no library GEMM.
//
// Function: float32 accumulation of float32 or bf16 inputs (one dtype
// for both), each product added with a fused multiply-add on the CUDA
// cores. Float32 inputs never go through TF32.
//
// What bounds it on an H100: operations (2 M N K; at BERT-Large's
// MLP-out weight gradient, 4096 x 4096 @ 4096 x 1024, 34 GFLOP, 0.035
// ms at the bf16 tensor-core peak). This first kernel runs on the CUDA
// cores and is far from that bound: 64 x 64 output tiles, 256 threads
// each holding a 4 x 4 block of sums in registers, the K dimension
// streamed through shared memory 16 deep (A stored transposed so both
// operands are read as float4 rows). Ragged M, N and K are masked
// (zeros loaded past the edges); offsets are 64-bit, since M * N
// reaches 3e7 and i * N + j overflows 32 bits in larger calls. Tensor
// cores (mma.sync / wgmma with TMA) are the redesign's work.

#include "common.cuh"

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 16, kThreads = 256;
constexpr int kPad = 4;  // keeps float4 rows aligned, halves bank conflicts

template <typename T>
__global__ void __launch_bounds__(kThreads)
    matmul_pack_kernel(const T* __restrict__ a, const T* __restrict__ b,
                       float* __restrict__ out, int M, int N, int K,
                       long long total) {
  __shared__ __align__(16) float As[kBK][kBM + kPad];  // As[p][i] = a[i, p]
  __shared__ __align__(16) float Bs[kBK][kBN + kPad];  // Bs[p][j] = b[p, j]
  const int t = threadIdx.x;
  const int ty = t / 16, tx = t % 16;
  const long long row0 = static_cast<long long>(blockIdx.y) * kBM;
  const long long col0 = static_cast<long long>(blockIdx.x) * kBN;

  // the padding past M * N: a few elements, zeroed by the first block
  if (blockIdx.x == 0 && blockIdx.y == 0) {
    const long long mn = static_cast<long long>(M) * N;
    for (long long e = mn + t; e < total; e += kThreads) out[e] = 0.f;
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // loader coordinates: A tile 64 x 16 (4 consecutive p per thread),
  // B tile 16 x 64 (4 consecutive j per thread)
  const int a_i = t / 4, a_p = (t % 4) * 4;
  const int b_p = t / 16, b_j = (t % 16) * 4;

  for (int p0 = 0; p0 < K; p0 += kBK) {
    const long long gi = row0 + a_i;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int gp = p0 + a_p + q;
      As[a_p + q][a_i] = (gi < M && gp < K)
                             ? to_f32<T>(a[gi * K + gp])
                             : 0.f;
    }
    const int gp = p0 + b_p;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long long gj = col0 + b_j + q;
      Bs[b_p][b_j + q] = (gp < K && gj < N)
                             ? to_f32<T>(b[static_cast<long long>(gp) * N +
                                           gj])
                             : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < kBK; ++p) {
      const float4 av = *reinterpret_cast<const float4*>(&As[p][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[p][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long gi = row0 + ty * 4 + i;
    if (gi >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long gj = col0 + tx * 4 + j;
      if (gj < N) out[gi * N + gj] = acc[i][j];
    }
  }
}

}  // namespace

// a: [M, K] and b: [K, N], contiguous row-major, both float32 (dtype
// kF32) or both bf16 (kBF16); out: `total` (= n * k >= M * N) float32.
// Launches one kernel on `stream` of CUDA device `device`; returns
// cudaGetLastError() after it.
extern "C" int hvd_matmul_pack(const void* a, const void* b, void* out,
                               int M, int N, int K, long long total,
                               int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (M <= 0 || N <= 0 || K < 0 ||
      total < static_cast<long long>(M) * N)
    return cudaErrorInvalidValue;
  const long long gy = (M + kBM - 1) / kBM;
  if (gy > 65535) return cudaErrorInvalidValue;
  dim3 grid((N + kBN - 1) / kBN, static_cast<unsigned>(gy));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (dtype == kF32) {
    matmul_pack_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), o, M, N,
        K, total);
  } else if (dtype == kBF16) {
    matmul_pack_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(b), o, M, N, K, total);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
