// LayerNorm / RMSNorm backward over the last axis of an [N, C] tensor.
//
// Replaces: horovod_tpu/ops/pallas_layernorm.py `_bwd_kernel` (run by
// `_run_bwd`), the TPU kernel behind `fused_layer_norm`'s VJP.
//
// Math (the TPU kernel's): per row, mean and rstd are recomputed from x
// with the forward's formula (var = E[x^2] - mean^2 clamped at 0), then
// in float32
//   xhat = (x - mean) * rstd,           gdy = dy * gamma
//   s1 = sum(gdy) / C,                  s2 = sum(gdy * xhat) / C
//   dx = rstd * (gdy - s1 - xhat * s2)  (RMSNorm: no s1 term)
//   dgamma = sum_rows(dy * xhat),       dbeta = sum_rows(dy)
// with dx stored in x's dtype. Elementwise steps use the _rn intrinsics
// so nothing is contracted into an FMA. mean and rstd come from
// layernorm.cuh's `warp_row_stats`, as the forward's do (C <= 4096), so
// they are the forward's bit for bit.
//
// What bounds it on an H100: bytes. It reads x and dy and writes dx
// ([N, C] each) and does ~20 flops per element, far below the card's
// flops per byte.
//
// Design: a warp per row, no barrier inside a row. A lane holds the
// row's columns (k * 32 + lane) * V .. + V for k < CPL / V, V = 16 bytes
// of x's dtype (8 bf16, 4 float32; 1 where C is no multiple of V), read
// by 16-byte loads (layernorm.cuh's `Cols`); the four row sums (sum x,
// sum x^2, sum gdy, sum gdy * xhat) are warp shuffles. Each warp walks
// rows warp_id, warp_id + n_warps, ... and starts the next row's loads
// before the current row's reductions. gamma sits in shared memory.
//
// dgamma and dbeta: each lane accumulates its columns across its rows
// in float32 registers; a block's warps add theirs in warp order through
// shared memory into the block's row of a float32 [blocks, C] scratch.
// The TPU kernel adds into one output block across its in-order grid;
// blocks here run in no order, so the last block to finish (a ticket
// counter after __threadfence, reset by that block) sums the scratch
// rows in block order. One launch in place of three (the earlier design
// ran two column-sum kernels after the row kernel), no float atomics,
// and the result does not change from run to run. A second launch with
// a fixed tree was the other choice; the ticket keeps the whole
// backward one kernel, whose last block reads blocks x C floats from
// L2 with 16-byte loads.

#include "layernorm.cuh"

namespace {

constexpr int kWarps = 8;                // rows in flight a block
constexpr int kThreads = kWarps * 32;
constexpr int kBlocksPerSm = 1;          // blocks = this x the SM count
constexpr int kMaxCols = 128;            // columns a lane, so C <= 4096

template <typename T, bool kWide, int kCpl>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    layernorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                         const float* __restrict__ gamma, T* __restrict__ dx,
                         float* __restrict__ dg, float* __restrict__ db,
                         float* dg_part, float* db_part,
                         unsigned int* ticket, int n, int c, float eps,
                         int rms) {
  using L = ln::Cols<T, kWide>;
  constexpr int V = L::V;
  constexpr int kChunks = kCpl / V;  // chunks a lane
  using Raw = typename L::Raw;
  extern __shared__ __align__(16) float smem[];
  float* gs = smem;      // gamma [c]; dbeta's column sums after the rows
  float* sdg = gs + c;   // dgamma's column sums [c]
  __shared__ bool last;

  for (int i = threadIdx.x; i < c; i += kThreads) gs[i] = gamma[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = gridDim.x * kWarps;
  const bool with_db = db != nullptr;
  const float cf = static_cast<float>(c);

  float adg[kChunks][V], adb[kChunks][V];
#pragma unroll
  for (int k = 0; k < kChunks; ++k)
#pragma unroll
    for (int e = 0; e < V; ++e) adg[k][e] = adb[k][e] = 0.f;

  Raw cx[kChunks], cd[kChunks], nx[kChunks], nd[kChunks];
  auto load = [&](Raw (&rx)[kChunks], Raw (&rd)[kChunks], int r) {
    const size_t off = static_cast<size_t>(r) * c;
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int col = (k * 32 + lane) * V;
      if (col < c) {
        rx[k] = L::load(x + off + col);
        rd[k] = L::load(dy + off + col);
      }
    }
  };

  int r = blockIdx.x * kWarps + warp;
  if (r < n) load(cx, cd, r);
  for (; r < n; r += n_warps) {
    if (r + n_warps < n) load(nx, nd, r + n_warps);

    float mean, rstd;
    ln::warp_row_stats<T, kWide, kChunks>(cx, lane, c, eps, rms, mean, rstd);

    float a1 = 0.f, a2 = 0.f;
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int col = (k * 32 + lane) * V;
      if (col >= c) continue;
      float xv[V], dv[V];
      L::unpack(cx[k], xv);
      L::unpack(cd[k], dv);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float xhat = __fmul_rn(__fsub_rn(xv[e], mean), rstd);
        const float gdy = __fmul_rn(dv[e], gs[col + e]);
        a1 += gdy;
        a2 = fmaf(gdy, xhat, a2);
      }
    }
    const float s1 = rms ? 0.f : __fdiv_rn(warp_sum(a1), cf);
    const float s2 = __fdiv_rn(warp_sum(a2), cf);

    T* dxr = dx + static_cast<size_t>(r) * c;
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int col = (k * 32 + lane) * V;
      if (col >= c) continue;
      float xv[V], dv[V], out[V];
      L::unpack(cx[k], xv);
      L::unpack(cd[k], dv);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float xhat = __fmul_rn(__fsub_rn(xv[e], mean), rstd);
        const float gdy = __fmul_rn(dv[e], gs[col + e]);
        const float inner = rms ? gdy : __fsub_rn(gdy, s1);
        out[e] = __fmul_rn(rstd, __fsub_rn(inner, __fmul_rn(xhat, s2)));
        adg[k][e] = fmaf(dv[e], xhat, adg[k][e]);
        adb[k][e] += dv[e];
      }
      L::store(dxr + col, out);
    }
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      cx[k] = nx[k];
      cd[k] = nd[k];
    }
  }

  // the block's column sums: warps add in warp order
  __syncthreads();  // gamma is read no more: gs takes dbeta's sums
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int k = 0; k < kChunks; ++k) {
        const int col = (k * 32 + lane) * V;
        if (col >= c) continue;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          sdg[col + e] = w == 0 ? adg[k][e] : sdg[col + e] + adg[k][e];
          gs[col + e] = w == 0 ? adb[k][e] : gs[col + e] + adb[k][e];
        }
      }
    }
    __syncthreads();
  }
  float* dgp = dg_part + static_cast<size_t>(blockIdx.x) * c;
  float* dbp =
      with_db ? db_part + static_cast<size_t>(blockIdx.x) * c : nullptr;
  for (int i = threadIdx.x; i < c; i += kThreads) {
    dgp[i] = sdg[i];
    if (with_db) dbp[i] = gs[i];
  }

  // the last block to finish sums the blocks' rows in block order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int blocks = gridDim.x;
  if (c % 4 == 0) {
    for (int i = threadIdx.x * 4; i < c; i += kThreads * 4) {
      float4 g4 = make_float4(0.f, 0.f, 0.f, 0.f), b4 = g4;
#pragma unroll 16
      for (int b = 0; b < blocks; ++b) {
        const float4 pg = __ldcg(reinterpret_cast<const float4*>(
            dg_part + static_cast<size_t>(b) * c + i));
        g4.x += pg.x; g4.y += pg.y; g4.z += pg.z; g4.w += pg.w;
        if (with_db) {
          const float4 pb = __ldcg(reinterpret_cast<const float4*>(
              db_part + static_cast<size_t>(b) * c + i));
          b4.x += pb.x; b4.y += pb.y; b4.z += pb.z; b4.w += pb.w;
        }
      }
      *reinterpret_cast<float4*>(dg + i) = g4;
      if (with_db) *reinterpret_cast<float4*>(db + i) = b4;
    }
  } else {
    for (int i = threadIdx.x; i < c; i += kThreads) {
      float gsum = 0.f, bsum = 0.f;
#pragma unroll 16
      for (int b = 0; b < blocks; ++b) {
        gsum += __ldcg(dg_part + static_cast<size_t>(b) * c + i);
        if (with_db) bsum += __ldcg(db_part + static_cast<size_t>(b) * c + i);
      }
      dg[i] = gsum;
      if (with_db) db[i] = bsum;
    }
  }
  if (threadIdx.x == 0) *ticket = 0;  // for the next launch on the stream
}

template <typename T, bool kWide>
cudaError_t launch_wide(const void* x, const void* dy, const float* gamma,
                        void* dx, float* dg, float* db, float* dg_part,
                        float* db_part, unsigned int* ticket, int n, int c,
                        int blocks, float eps, int rms, cudaStream_t stream) {
  constexpr int V = ln::Cols<T, kWide>::V;
  const int need = (c + 31) / 32;  // columns a lane
  const size_t smem = 2 * static_cast<size_t>(c) * sizeof(float);
  auto go = [&](auto kernel) {
    if (smem > 32 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
    kernel<<<blocks, kThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy), gamma,
        static_cast<T*>(dx), dg, db, dg_part, db_part, ticket, n, c, eps,
        rms);
    return cudaGetLastError();
  };
  // the least power of two of columns a lane, at least 8 (>= V)
  static_assert(V <= 8, "a chunk fits 8 columns a lane");
  if (need <= 8) return go(layernorm_bwd_kernel<T, kWide, 8>);
  if (need <= 16) return go(layernorm_bwd_kernel<T, kWide, 16>);
  if (need <= 32) return go(layernorm_bwd_kernel<T, kWide, 32>);
  if (need <= 64) return go(layernorm_bwd_kernel<T, kWide, 64>);
  if (need <= kMaxCols) return go(layernorm_bwd_kernel<T, kWide, kMaxCols>);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch(const void* x, const void* dy, const float* gamma,
                   void* dx, float* dg, float* db, float* dg_part,
                   float* db_part, unsigned int* ticket, int n, int c,
                   int blocks, float eps, int rms, cudaStream_t stream) {
  // 16-byte loads need whole chunks in every row (rows start 16-byte
  // aligned when c is a multiple of the chunk and x, dy, dx are)
  constexpr int V = ln::Cols<T, true>::V;
  const bool wide =
      c % V == 0 && ((reinterpret_cast<uintptr_t>(x) |
                      reinterpret_cast<uintptr_t>(dy) |
                      reinterpret_cast<uintptr_t>(dx)) & 15) == 0;
  if (wide)
    return launch_wide<T, true>(x, dy, gamma, dx, dg, db, dg_part, db_part,
                                ticket, n, c, blocks, eps, rms, stream);
  return launch_wide<T, false>(x, dy, gamma, dx, dg, db, dg_part, db_part,
                               ticket, n, c, blocks, eps, rms, stream);
}

}  // namespace

// The build compiles this file as two translation units at once
// (ops/_build.py PARTS, -DHVD_PART=k): part 0 the entry point and the
// bf16 kernels, part 1 the float32 kernels. Without HVD_PART one unit
// emits both.
#ifdef HVD_PART
#define HVD_EMITS_PART(k) (HVD_PART == (k))
#else
#define HVD_EMITS_PART(k) 1
#endif

namespace layernorm_bwd_parts {

#define HVD_LN_ARGS                                                        \
  const void *x, const void *dy, const float *gamma, void *dx, float *dg,  \
      float *db, float *dg_part, float *db_part, unsigned int *ticket,     \
      int n, int c, int blocks, float eps, int rms, cudaStream_t stream
#define HVD_LN_PASS \
  x, dy, gamma, dx, dg, db, dg_part, db_part, ticket, n, c, blocks, eps, \
      rms, stream

cudaError_t launch_f32(HVD_LN_ARGS);

#if HVD_EMITS_PART(1)
cudaError_t launch_f32(HVD_LN_ARGS) { return launch<float>(HVD_LN_PASS); }
#endif

}  // namespace layernorm_bwd_parts

#if HVD_EMITS_PART(0)
// x, dy, dx: [n, c] contiguous, dtype `dtype` (kF32 / kBF16), c <= 4096;
// gamma, dg, db: [c] float32 (db and db_part null without a beta);
// dg_part, db_part: [blocks, c] float32 scratch; ticket: one zeroed
// uint32 that the kernel leaves zeroed, not shared with a launch that
// may run at the same time. Launches one kernel of `blocks` blocks on
// `stream` of CUDA device `device`; returns cudaGetLastError() after it.
extern "C" int hvd_layernorm_bwd(const void* x, const void* dy,
                                 const void* gamma, void* dx, void* dg,
                                 void* db, void* dg_part, void* db_part,
                                 void* ticket, int n, int c, int blocks,
                                 float eps, int rms, int dtype, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (c > 32 * kMaxCols || blocks < 1) return cudaErrorInvalidValue;
  const float* g = static_cast<const float*>(gamma);
  float* dgf = static_cast<float*>(dg);
  float* dbf = static_cast<float*>(db);
  float* dgp = static_cast<float*>(dg_part);
  float* dbp = static_cast<float*>(db_part);
  unsigned int* tk = static_cast<unsigned int*>(ticket);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(x, dy, g, dx, dgf, dbf, dgp, dbp, tk, n, c,
                                 blocks, eps, rms, s);
  if (dtype == kF32)
    return layernorm_bwd_parts::launch_f32(x, dy, g, dx, dgf, dbf, dgp, dbp,
                                           tk, n, c, blocks, eps, rms, s);
  return cudaErrorInvalidValue;
}
#endif
