// Flash-attention backward, dQ.
//
// Replaces: horovod_tpu/ops/pallas_attention.py `_flash_bwd_dq_kernel`
// (the first pallas_call of `_flash_bwd`).
//
// For one block of query rows, stream the K/V tiles the forward visited
// and rebuild each probability from the saved row logsumexp:
//   p  = visible ? exp(s - lse) : 0   (mask first: lse = -1e30 rows
//                                      would overflow the exp)
//   dS = p * (dO.V^T - delta),  dQ = scale * round(dS) . K
// with q scaled and rounded to the input dtype as in the forward, and
// float32 sums. Each dQ row is written by exactly one block, so the
// result is deterministic and needs no atomics.
//
// What bounds it on an H100: at GPT-2-medium shapes ([8, 16, 1024, 64]
// bf16, causal) the least time is its operations, 25.8 GFLOP (three
// products over the causal half) at 989 TFLOP/s, 0.0261 ms.
//
// bf16 (the training path): `flash_bwd_dq_mma_kernel`, on the tensor
// cores (flash_mma.cuh). A block of 4 warps holds 64 query rows, 16 a
// warp; each warp keeps its Q rows (scaled and rounded in registers)
// and its dO rows as mma A fragments, the rows' lse and delta, and a
// float32 16 x D dQ accumulator. K and V stream in tiles of kv_tile<D>()
// key rows through a two-stage cp.async ring. Per tile, three products:
//   S   = Qs . K^T      K from ldmatrix (n-major)
//   dP  = dO . V^T      V from ldmatrix (n-major)
//   dQ += round(dS) . K dS = P (dP - delta) repacked from C to A
//                       fragments, rounded to bf16 there; K from
//                       ldmatrix.trans (k-major)
// and dQ is scaled and rounded once at the end. Masks apply only to
// tiles that cross the causal diagonal or the end of K; the heaviest
// causal blocks (last query rows) are launched first.
//
// float32: `flash_bwd_dq_kernel`, the CUDA-core kernel of flash.cuh.

#include "flash_mma.cuh"

namespace {

using namespace flash;

template <typename T, int D>
__global__ void __launch_bounds__(Shape<D>::kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int tq, int tk, float scale, int causal, int q_off,
                        int k_off) {
  using S = Shape<D>;
  constexpr int kTile = S::kTile;
  __shared__ __align__(16) float sk[kTile * D];
  __shared__ __align__(16) float sv[kTile * D];

  const size_t bh = blockIdx.x;
  const int q_base = blockIdx.y * kRows;
  const int row = threadIdx.x / S::kParts, part = threadIdx.x % S::kParts;
  const int qi = q_base + row;
  const bool live = qi < tq;
  const T* kb = k + bh * tk * D;
  const T* vb = v + bh * tk * D;

  float qr[S::kDims], dor[S::kDims], acc[S::kDims];
  load_part<T, D>(qr, q + (bh * tq + qi) * D, part, live);
  load_part<T, D>(dor, dout + (bh * tq + qi) * D, part, live);
#pragma unroll
  for (int i = 0; i < S::kDims; ++i) {
    qr[i] = round_to<T>(__fmul_rn(qr[i], scale));
    acc[i] = 0.f;
  }
  const float row_lse = live ? lse[bh * tq + qi] : 0.f;
  const float row_delta = live ? delta[bh * tq + qi] : 0.f;

  const int n_tiles = (tk + kTile - 1) / kTile;
  const int limit =
      causal ? causal_kv_limit(min(q_base + kRows, tq) - 1, q_off, k_off,
                               kTile, n_tiles)
             : n_tiles;
  for (int t = 0; t < limit; ++t) {
    const int k0 = t * kTile;
    __syncthreads();
    load_tile<T, D>(sk, kb, k0, kTile, tk);
    load_tile<T, D>(sv, vb, k0, kTile, tk);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      const float s = sum_parts<D>(dot_part<D>(qr, sk + j * D, part));
      const float dp = sum_parts<D>(dot_part<D>(dor, sv + j * D, part));
      const bool vis = live && visible(qi, k0 + j, tk, causal, q_off, k_off);
      const float p = vis ? expf(s - row_lse) : 0.f;
      const float ds = __fmul_rn(p, __fsub_rn(dp, row_delta));
      axpy_part<D>(acc, round_to<T>(ds), sk + j * D, part);
    }
  }
  if (live) store_part<T, D>(dq + (bh * tq + qi) * D, acc, scale, part);
}

// float32, on the CUDA cores
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dq, int bh, int tq, int tk,
                       int d, float scale, int causal, int q_off, int k_off,
                       cudaStream_t stream) {
  using F = const float*;
  return with_head_dim(d, [&](auto dd) {
    constexpr int D = decltype(dd)::value;
    const dim3 grid(bh, (tq + kRows - 1) / kRows);
    flash_bwd_dq_kernel<float, D><<<grid, Shape<D>::kThreads, 0, stream>>>(
        static_cast<F>(q), static_cast<F>(k), static_cast<F>(v),
        static_cast<F>(dout), lse, delta, static_cast<float*>(dq), tq, tk,
        scale, causal, q_off, k_off);
    return cudaGetLastError();
  });
}

// ---- bf16 on the tensor cores ---------------------------------------------

// Key rows of a streamed K/V tile: 64, and 32 at D = 128, where the
// resident Q and dO fragments and the 16 x D accumulator leave too few
// registers for 16 x 64 float32 S and dP tiles.
template <int D>
__host__ __device__ constexpr int kv_tile() {
  return D <= 64 ? 64 : 32;
}

template <int D>
constexpr int dq_smem_bytes() {
  // Q and dO rows, two stages of K and V tiles
  return (2 * flash_mma::kBlockRows + 4 * kv_tile<D>()) *
         flash_mma::Geometry<D>::kStride * 2;
}

// Blocks an SM holds at head_dim <= 64: 3 caps the registers at 168
// (172 uncapped: 2 blocks), 14% faster at [8, 16, 1024, 64]; at 128 the
// cap spills and is slower.
template <int D>
__global__ void __launch_bounds__(flash_mma::kThreads, D <= 64 ? 3 : 1)
    flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const __nv_bfloat16* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            __nv_bfloat16* __restrict__ dq, int tq, int tk,
                            float scale, int causal, int q_off, int k_off) {
  using namespace flash_mma;
  using G = Geometry<D>;
  constexpr int S = G::kStride;
  constexpr int kKv = kv_tile<D>();
  constexpr int kKTiles = kKv / 8;  // n8 tiles of S and dP a warp
  constexpr int kDTiles = D / 8;    // n8 tiles of dQ a warp
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);  // [kBlockRows][S]
  bf16* sdo = sq + kBlockRows * S;           // [kBlockRows][S]
  bf16* sk = sdo + kBlockRows * S;           // [2][kKv][S]
  bf16* sv = sk + 2 * kKv * S;               // [2][kKv][S]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t bh = blockIdx.x;
  const int q_base = (gridDim.y - 1 - blockIdx.y) * kBlockRows;
  const bf16* kb = k + bh * tk * D;
  const bf16* vb = v + bh * tk * D;

  const int n_tiles = (tk + kKv - 1) / kKv;
  const int limit =
      causal ? causal_kv_limit(min(q_base + kBlockRows, tq) - 1, q_off,
                               k_off, kKv, n_tiles)
             : n_tiles;

  load_rows<D, kBlockRows>(sq, q + bh * tq * D, q_base, tq);
  load_rows<D, kBlockRows>(sdo, dout + bh * tq * D, q_base, tq);
  cp_async_commit();
  if (limit > 0) {
    load_rows<D, kKv>(sk, kb, 0, tk);
    load_rows<D, kKv>(sv, vb, 0, tk);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // this warp's 16 query rows: Qs = (q.f32 * scale).bf16, and dO
  uint32_t qf[G::kSteps][4], dof[G::kSteps][4];
#pragma unroll
  for (int kk = 0; kk < G::kSteps; ++kk) {
    ldsm_x4(qf[kk], a_addr<D>(sq, warp * kWarpRows, kk * 16, lane));
#pragma unroll
    for (int i = 0; i < 4; ++i) qf[kk][i] = scale_bf16x2(qf[kk][i], scale);
    ldsm_x4(dof[kk], a_addr<D>(sdo, warp * kWarpRows, kk * 16, lane));
  }
  // rows r0 = row and r1 = row + 8
  const int row = q_base + warp * kWarpRows + g;
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool live = row + 8 * r < tq;
    row_lse[r] = live ? lse[bh * tq + row + 8 * r] : 0.f;
    row_delta[r] = live ? delta[bh * tq + row + 8 * r] : 0.f;
  }
  float acc[kDTiles][4];
#pragma unroll
  for (int j = 0; j < kDTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int t = 0; t < limit; ++t) {
    if (t + 1 < limit) {
      const int nxt = (t + 1) & 1;
      load_rows<D, kKv>(sk + nxt * kKv * S, kb, (t + 1) * kKv, tk);
      load_rows<D, kKv>(sv + nxt * kKv * S, vb, (t + 1) * kKv, tk);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* ks = sk + (t & 1) * kKv * S;
    const bf16* vs = sv + (t & 1) * kKv * S;
    const int k0 = t * kKv;

    // S = Qs . K^T and dP = dO . V^T
    float s[kKTiles][4], dp[kKTiles][4];
#pragma unroll
    for (int j = 0; j < kKTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < G::kSteps; ++kk)
#pragma unroll
      for (int np = 0; np < kKv / 16; ++np) {
        uint32_t b[4];
        ldsm_x4(b, b_addr<D>(ks, np * 16, kk * 16, lane));
        mma(s[2 * np], qf[kk], b[0], b[1]);
        mma(s[2 * np + 1], qf[kk], b[2], b[3]);
        ldsm_x4(b, b_addr<D>(vs, np * 16, kk * 16, lane));
        mma(dp[2 * np], dof[kk], b[0], b[1]);
        mma(dp[2 * np + 1], dof[kk], b[2], b[3]);
      }

    // dS = P (dP - delta) in dP's place, P = exp(S - lse) with masked
    // entries selected to 0 before anything multiplies them; the tile
    // crosses the end of K or the causal diagonal of the block
    const bool masked =
        k0 + kKv > tk ||
        (causal && k_off + k0 + kKv - 1 > q_off + q_base);
#pragma unroll
    for (int j = 0; j < kKTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = expf(s[j][e] - row_lse[e >> 1]);
        if (masked && !visible(row + (e >> 1) * 8, k0 + 8 * j + 2 * t4 +
                                                       (e & 1),
                               tk, causal, q_off, k_off))
          p = 0.f;
        dp[j][e] = __fmul_rn(p, __fsub_rn(dp[j][e], row_delta[e >> 1]));
      }

    // dQ += round(dS) . K, K k-major from ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < kKv / 16; ++kk) {
      uint32_t a[4];
      c_to_a(a, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t b[4];
        ldsm_x4_t(b, a_addr<D>(ks, kk * 16, np * 16, lane));
        mma(acc[2 * np], a, b[0], b[1]);
        mma(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // stage t & 1 is refilled at iteration t + 1
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row + 8 * r;
    if (qi >= tq) continue;
    bf16* dqrow = dq + (bh * tq + qi) * D;
#pragma unroll
    for (int j = 0; j < kDTiles; ++j)
      *reinterpret_cast<uint32_t*>(dqrow + 8 * j + 2 * t4) =
          pack_bf16(__fmul_rn(acc[j][2 * r], scale),
                    __fmul_rn(acc[j][2 * r + 1], scale));
  }
}

cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse,
                        const float* delta, void* dq, int bh, int tq, int tk,
                        int d, float scale, int causal, int q_off, int k_off,
                        cudaStream_t stream) {
  using B = const __nv_bfloat16*;
  return with_head_dim(d, [&](auto dd) {
    constexpr int D = decltype(dd)::value;
    constexpr int smem = dq_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_mma_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(bh, (tq + flash_mma::kBlockRows - 1) /
                            flash_mma::kBlockRows);
    flash_bwd_dq_mma_kernel<D><<<grid, flash_mma::kThreads, smem, stream>>>(
        static_cast<B>(q), static_cast<B>(k), static_cast<B>(v),
        static_cast<B>(dout), lse, delta, static_cast<__nv_bfloat16*>(dq),
        tq, tk, scale, causal, q_off, k_off);
    return cudaGetLastError();
  });
}

}  // namespace

// q/dout/dq: [bh, tq, d], k/v: [bh, tk, d], contiguous, dtype `dtype`
// (bf16 rows 16-byte aligned, for cp.async; bf16 runs on the tensor
// cores, float32 on the CUDA cores); lse/delta: [bh, tq] float32.
// Returns cudaGetLastError() after the launch on `stream` of device
// `device`.
extern "C" int hvd_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, int bh, int tq,
                                int tk, int d, float scale, int causal,
                                int q_off, int k_off, int dtype, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_bf16(q, k, v, dout, l, dl, dq, bh, tq, tk, d, scale,
                       causal, q_off, k_off, s);
  if (dtype == kF32)
    return launch_f32(q, k, v, dout, l, dl, dq, bh, tq, tk, d, scale, causal,
                      q_off, k_off, s);
  return cudaErrorInvalidValue;
}
