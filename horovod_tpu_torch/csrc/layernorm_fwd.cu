// LayerNorm / RMSNorm forward over the last axis of an [N, C] tensor.
//
// Replaces: horovod_tpu/ops/pallas_layernorm.py `_fwd_kernel` (run by
// `_run_fwd`), the TPU kernel behind `fused_layer_norm` forward.
//
// Math (the TPU kernel's, not Welford): per row, in float32,
//   mean = sum(x) / C,  var = max(sum(x*x) / C - mean*mean, 0)
//   rstd = 1 / sqrt(var + eps)            (RMSNorm: mean = 0,
//   y    = (x - mean) * rstd * gamma (+ beta)   var = sum(x*x) / C)
// with y stored in x's dtype. The elementwise steps use the _rn
// intrinsics so the compiler cannot contract them into FMAs: only the
// order of the two row sums differs from the plain version.
//
// What bounds it on an H100: bytes. It reads x once and writes y once
// ([N, C] each) and does ~8 flops per element, far below the ~20
// flops/byte the card's float32 units need to be the limit.
//
// Design (the register route, C <= 4096): a warp per row, as the
// backward (layernorm_bwd.cu), on layernorm.cuh's chunk layout: each
// lane holds its columns of the row in registers from 16-byte loads (8
// bf16 or 4 float32 a load; one element a load where C is no multiple
// of that or a pointer is not 16-byte aligned), takes the row's
// statistics from layernorm.cuh's `warp_row_stats` (the backward's,
// bit for bit) with warp shuffles and no barrier, and writes y from
// the same registers: x is read once. gamma and beta sit in shared
// memory, loaded once a block. The grid is persistent: warp w walks
// rows w, w + warps, ... and issues the next row's loads before the
// current row's reductions, so each SM keeps its warps' next rows in
// flight (16 warps x 2 KB at C = 1024 bf16, 32 KB: about what 3.35
// TB/s over 132 SMs needs at ~1 us of latency). A lane's row buffer of
// more than 32 registers (float32 or one-element chunks at C > 1024,
// bf16 at C > 2048) is not doubled, and rows of more than 64 columns a
// lane (C > 2048) run at one block an SM, so no template spills.
//
// Rows of C > 4096 (the long-row route) take a block a row: two block
// sums over 16-byte (or one-element) loads, layernorm.cuh's fold, and a
// second pass over the row, which hits L1/L2.

#include "layernorm.cuh"

namespace {

constexpr int kWarps = 8;          // rows in flight a block
constexpr int kThreads = kWarps * 32;
constexpr int kBlocksPerSm = 2;    // blocks = this x the SM count (C <= 2048)
constexpr int kMaxCols = 128;      // columns a lane, so C <= 4096 here
constexpr int kPrefetchRegs = 32;  // a row buffer this small is doubled

// Blocks an SM of the register route's template of kCpl columns a lane
// (ops/layernorm.py `fwd_blocks` gives the grid).
constexpr int blocks_per_sm(int cpl) {
  return cpl < kMaxCols ? kBlocksPerSm : 1;
}

// gamma or beta at columns col .. col + V from shared memory
template <int V>
__device__ __forceinline__ void smem_cols(const float* p, float (&v)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      v[i] = q.x;
      v[i + 1] = q.y;
      v[i + 2] = q.z;
      v[i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = p[i];
  }
}

template <typename T, bool kWide, int kCpl>
__global__ void __launch_bounds__(kThreads, blocks_per_sm(kCpl))
    layernorm_fwd_kernel(const T* __restrict__ x,
                         const float* __restrict__ gamma,
                         const float* __restrict__ beta, T* __restrict__ y,
                         int n, int c, float eps, int rms) {
  using L = ln::Cols<T, kWide>;
  constexpr int V = L::V;
  constexpr int kChunks = kCpl / V;  // chunks a lane
  using Raw = typename L::Raw;
  constexpr int kRowRegs = kChunks * static_cast<int>((sizeof(Raw) + 3) / 4);
  constexpr bool kPrefetch = kRowRegs <= kPrefetchRegs;
  extern __shared__ __align__(16) float smem[];
  float* gs = smem;      // gamma [c]
  float* bs = smem + c;  // beta [c], when there is one
  const bool with_b = beta != nullptr;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = gridDim.x * kWarps;

  Raw cx[kChunks], nx[kPrefetch ? kChunks : 1];
  auto load = [&](auto& rx, int r) {
    const T* xr = x + static_cast<size_t>(r) * c;
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int col = (k * 32 + lane) * V;
      if (col < c) rx[k] = L::load(xr + col);
    }
  };

  // the first row's loads fly while gamma and beta go to shared memory
  int r = blockIdx.x * kWarps + warp;
  if (r < n) load(cx, r);
  for (int i = threadIdx.x; i < c; i += kThreads) {
    gs[i] = gamma[i];
    if (with_b) bs[i] = beta[i];
  }
  __syncthreads();

  for (; r < n; r += n_warps) {
    if constexpr (kPrefetch) {
      if (r + n_warps < n) load(nx, r + n_warps);
    }

    float mean, rstd;
    ln::warp_row_stats<T, kWide, kChunks>(cx, lane, c, eps, rms, mean, rstd);

    T* yr = y + static_cast<size_t>(r) * c;
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int col = (k * 32 + lane) * V;
      if (col >= c) continue;
      float v[V], g[V], b[V];
      L::unpack(cx[k], v);
      smem_cols<V>(gs + col, g);
      if (with_b) smem_cols<V>(bs + col, b);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float o = __fmul_rn(__fmul_rn(__fsub_rn(v[e], mean), rstd), g[e]);
        if (with_b) o = __fadd_rn(o, b[e]);
        v[e] = o;
      }
      L::store(yr + col, v);
    }
    if constexpr (kPrefetch) {
#pragma unroll
      for (int k = 0; k < kChunks; ++k) cx[k] = nx[k];
    } else if (r + n_warps < n) {
      load(cx, r + n_warps);
    }
  }
}

// The long-row route (C > 4096): block b takes rows b, b + blocks, ...
template <typename T, bool kWide>
__global__ void __launch_bounds__(kThreads)
    layernorm_fwd_row_kernel(const T* __restrict__ x,
                             const float* __restrict__ gamma,
                             const float* __restrict__ beta,
                             T* __restrict__ y, int n, int c, float eps,
                             int rms) {
  using L = ln::Cols<T, kWide>;
  constexpr int V = L::V;
  __shared__ float scratch[32];
  const int nv = c / V;  // chunks of the row (c % V == 0 when kWide)
  for (int row = blockIdx.x; row < n; row += gridDim.x) {
    const T* xr = x + static_cast<size_t>(row) * c;
    T* yr = y + static_cast<size_t>(row) * c;
    float s = 0.f, ss = 0.f;
    for (int i = threadIdx.x; i < nv; i += kThreads) {
      float v[V];
      L::unpack(L::load(xr + i * V), v);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        s += v[e];
        ss = fmaf(v[e], v[e], ss);
      }
    }
    s = block_sum(s, scratch);
    ss = block_sum(ss, scratch);
    float mean, rstd;
    ln::fold(s, ss, c, eps, rms, mean, rstd);
    for (int i = threadIdx.x; i < nv; i += kThreads) {
      float v[V];
      L::unpack(L::load(xr + i * V), v);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int col = i * V + e;
        float o = __fmul_rn(__fmul_rn(__fsub_rn(v[e], mean), rstd),
                            __ldg(gamma + col));
        if (beta != nullptr) o = __fadd_rn(o, __ldg(beta + col));
        v[e] = o;
      }
      L::store(yr + i * V, v);
    }
  }
}

template <typename T, bool kWide>
cudaError_t launch_route(const void* x, const float* gamma,
                         const float* beta, void* y, int n, int c,
                         int blocks, float eps, int rms,
                         cudaStream_t stream) {
  const T* xs = static_cast<const T*>(x);
  T* ys = static_cast<T*>(y);
  if (c > 32 * kMaxCols) {
    layernorm_fwd_row_kernel<T, kWide><<<blocks, kThreads, 0, stream>>>(
        xs, gamma, beta, ys, n, c, eps, rms);
    return cudaGetLastError();
  }
  const int need = (c + 31) / 32;  // columns a lane
  const size_t smem = (beta != nullptr ? 2 : 1) * static_cast<size_t>(c) *
                      sizeof(float);  // at most 32 KB
  auto go = [&](auto kernel) {
    kernel<<<blocks, kThreads, smem, stream>>>(xs, gamma, beta, ys, n, c,
                                               eps, rms);
    return cudaGetLastError();
  };
  // the least power of two of columns a lane, at least 8 (>= V)
  static_assert(ln::Cols<T, kWide>::V <= 8, "a chunk fits 8 columns a lane");
  if (need <= 8) return go(layernorm_fwd_kernel<T, kWide, 8>);
  if (need <= 16) return go(layernorm_fwd_kernel<T, kWide, 16>);
  if (need <= 32) return go(layernorm_fwd_kernel<T, kWide, 32>);
  if (need <= 64) return go(layernorm_fwd_kernel<T, kWide, 64>);
  return go(layernorm_fwd_kernel<T, kWide, kMaxCols>);
}

template <typename T>
cudaError_t launch(const void* x, const float* gamma, const float* beta,
                   void* y, int n, int c, int blocks, float eps, int rms,
                   cudaStream_t stream) {
  // 16-byte loads need whole chunks in every row (rows start 16-byte
  // aligned when c is a multiple of the chunk and x and y are)
  constexpr int V = ln::Cols<T, true>::V;
  const bool wide =
      c % V == 0 && ((reinterpret_cast<uintptr_t>(x) |
                      reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  if (wide)
    return launch_route<T, true>(x, gamma, beta, y, n, c, blocks, eps, rms,
                                 stream);
  return launch_route<T, false>(x, gamma, beta, y, n, c, blocks, eps, rms,
                                stream);
}

}  // namespace

// x, y: [n, c] contiguous, dtype `dtype` (kF32 / kBF16); gamma, beta:
// [c] float32 (beta may be null). `blocks`: the grid, ops/layernorm.py
// `fwd_blocks` (at most kBlocksPerSm blocks an SM on the register
// route, a block a row on the long-row route). Launches one kernel on
// `stream` of CUDA device `device`; returns cudaGetLastError() after it.
extern "C" int hvd_layernorm_fwd(const void* x, const void* gamma,
                                 const void* beta, void* y, int n, int c,
                                 int blocks, float eps, int rms, int dtype,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (blocks < 1 || c < 1) return cudaErrorInvalidValue;
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(x, g, b, y, n, c, blocks, eps, rms, s);
  if (dtype == kF32)
    return launch<float>(x, g, b, y, n, c, blocks, eps, rms, s);
  return cudaErrorInvalidValue;
}
