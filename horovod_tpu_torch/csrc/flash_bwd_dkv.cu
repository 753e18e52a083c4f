// Flash-attention backward, dK and dV.
//
// Replaces: horovod_tpu/ops/pallas_attention.py `_flash_bwd_dkv_kernel`
// (the second pallas_call of `_flash_bwd`).
//
// For one block of key rows, stream the Q / dO / lse / delta tiles and
// rebuild each probability from lse:
//   p  = visible ? exp(qs.k - lse) : 0,   dS = p * (dO.v - delta)
//   dV = round(p)^T . dO,                 dK = scale * round(dS)^T . Q
// where qs is q scaled and rounded to the input dtype (the forward's
// logits) and Q in dK is the unscaled input, as in the TPU kernel.
// Masked probabilities are selected to 0 (their exp overflows on rows
// with lse = -1e30). Under the causal mask the q tiles wholly above the
// diagonal are skipped (the TPU kernel's `start`). Each dK/dV row is
// written by exactly one block: no float atomics, deterministic.
//
// What bounds it on an H100: at GPT-2-medium shapes ([8, 16, 1024, 64]
// bf16, causal) the least time is its operations, 34.4 GFLOP (four
// products over the causal half) at 989 TFLOP/s, 0.0348 ms.
//
// bf16 (the training path): `flash_bwd_dkv_mma_kernel`, on the
// tensor cores (flash_mma.cuh). A block of 4 warps holds 64 key rows,
// 16 a warp; each warp keeps its K and V rows in registers as mma A
// fragments, and two float32 16 x D accumulators (dK, dV). Q, dO, lse
// and delta stream in tiles of q_tile<D>() query rows through a
// two-stage cp.async ring, Q and dO in bf16. Per tile, four products:
//   S^T  = K . Qs^T     Qs from ldmatrix, scaled and rounded in registers
//   dV  += round(P^T) . dO     P^T repacked from C to A fragments,
//                              dO from ldmatrix.trans
//   dP^T = V . dO^T     dO from ldmatrix
//   dK  += round(dS^T) . Q     dS^T = P^T (dP^T - delta), Q unscaled
//                              from ldmatrix.trans
// and dK is scaled and rounded, dV rounded, once at the end. Masks apply
// only to tiles that cross the causal diagonal or either end.
//
// float32: `flash_bwd_dkv_kernel`, the CUDA-core kernel of flash.cuh.

#include "flash_mma.cuh"

namespace {

using namespace flash;

template <typename T, int D>
__global__ void __launch_bounds__(Shape<D>::kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, int tq,
                         int tk, float scale, int causal, int q_off,
                         int k_off) {
  using S = Shape<D>;
  constexpr int kTile = S::kTile;
  __shared__ __align__(16) float sq[kTile * D];   // q as given
  __shared__ __align__(16) float sqs[kTile * D];  // q scaled and rounded
  __shared__ __align__(16) float sdo[kTile * D];
  __shared__ float slse[kTile];
  __shared__ float sdelta[kTile];

  const size_t bh = blockIdx.x;
  const int k_base = blockIdx.y * kRows;
  const int row = threadIdx.x / S::kParts, part = threadIdx.x % S::kParts;
  const int kj = k_base + row;
  const bool live = kj < tk;
  const T* qb = q + bh * tq * D;
  const T* dob = dout + bh * tq * D;

  float kr[S::kDims], vr[S::kDims], dk_acc[S::kDims], dv_acc[S::kDims];
  load_part<T, D>(kr, k + (bh * tk + kj) * D, part, live);
  load_part<T, D>(vr, v + (bh * tk + kj) * D, part, live);
#pragma unroll
  for (int i = 0; i < S::kDims; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  const int n_tiles = (tq + kTile - 1) / kTile;
  int start = 0;
  if (causal) {
    // q tiles whose last row sits above the block's first key see none
    // of its keys
    const int first = k_off + k_base - q_off;
    start = first <= 0 ? 0 : min(n_tiles, first / kTile);
  }
  for (int t = start; t < n_tiles; ++t) {
    const int q0 = t * kTile;
    __syncthreads();
    const int live_q = min(kTile, tq - q0) * D;
    for (int i = threadIdx.x; i < kTile * D; i += blockDim.x) {
      const float x = i < live_q ? to_f32(qb[static_cast<size_t>(q0) * D + i])
                                 : 0.f;
      sq[i] = x;
      sqs[i] = round_to<T>(__fmul_rn(x, scale));
    }
    load_tile<T, D>(sdo, dob, q0, kTile, tq);
    for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
      const bool in = q0 + i < tq;
      slse[i] = in ? lse[bh * tq + q0 + i] : 0.f;
      sdelta[i] = in ? delta[bh * tq + q0 + i] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < kTile; ++i) {
      const int qi = q0 + i;
      const float s = sum_parts<D>(dot_part<D>(kr, sqs + i * D, part));
      const float dp = sum_parts<D>(dot_part<D>(vr, sdo + i * D, part));
      const bool vis =
          qi < tq && visible(qi, kj, tk, causal, q_off, k_off);
      const float p = vis ? expf(s - slse[i]) : 0.f;
      const float ds = __fmul_rn(p, __fsub_rn(dp, sdelta[i]));
      axpy_part<D>(dv_acc, round_to<T>(p), sdo + i * D, part);
      axpy_part<D>(dk_acc, round_to<T>(ds), sq + i * D, part);
    }
  }
  if (!live) return;
  store_part<T, D>(dk + (bh * tk + kj) * D, dk_acc, scale, part);
  store_part<T, D>(dv + (bh * tk + kj) * D, dv_acc, 1.f, part);
}

// float32, on the CUDA cores
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv, int bh,
                       int tq, int tk, int d, float scale, int causal,
                       int q_off, int k_off, cudaStream_t stream) {
  using F = const float*;
  return with_head_dim(d, [&](auto dd) {
    constexpr int D = decltype(dd)::value;
    const dim3 grid(bh, (tk + kRows - 1) / kRows);
    flash_bwd_dkv_kernel<float, D><<<grid, Shape<D>::kThreads, 0, stream>>>(
        static_cast<F>(q), static_cast<F>(k), static_cast<F>(v),
        static_cast<F>(dout), lse, delta, static_cast<float*>(dk),
        static_cast<float*>(dv), tq, tk, scale, causal, q_off, k_off);
    return cudaGetLastError();
  });
}

// ---- bf16 on the tensor cores ---------------------------------------------

// Query rows of a streamed Q/dO tile: 64, and 32 at D = 128, where the
// two resident operands and two accumulators of 16 x D leave too few
// registers for 16 x 64 float32 S^T and dP^T tiles.
template <int D>
__host__ __device__ constexpr int q_tile() {
  return D <= 64 ? 64 : 32;
}

template <int D>
constexpr int dkv_smem_bytes() {
  // K and V rows, two stages of Q and dO tiles, two of lse and delta
  return (2 * flash_mma::kBlockRows + 4 * q_tile<D>()) *
             flash_mma::Geometry<D>::kStride * 2 +
         4 * q_tile<D>() * 4;
}

template <int D>
__global__ void __launch_bounds__(flash_mma::kThreads)
    flash_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv, int tq, int tk,
                   float scale, int causal, int q_off, int k_off) {
  using namespace flash_mma;
  using G = Geometry<D>;
  constexpr int S = G::kStride;
  constexpr int kQ = q_tile<D>();
  constexpr int kQTiles = kQ / 8;   // n8 tiles of S^T a warp
  constexpr int kDTiles = D / 8;    // n8 tiles of dK, dV a warp
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sk = reinterpret_cast<bf16*>(smem);  // [kBlockRows][S]
  bf16* sv = sk + kBlockRows * S;            // [kBlockRows][S]
  bf16* sq = sv + kBlockRows * S;            // [2][kQ][S]
  bf16* sdo = sq + 2 * kQ * S;               // [2][kQ][S]
  float* slse = reinterpret_cast<float*>(sdo + 2 * kQ * S);  // [2][kQ]
  float* sdelta = slse + 2 * kQ;                             // [2][kQ]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t bh = blockIdx.x;
  const int k_base = blockIdx.y * kBlockRows;
  const bf16* qb = q + bh * tq * D;
  const bf16* dob = dout + bh * tq * D;
  const float* lb = lse + bh * tq;
  const float* db = delta + bh * tq;

  const int n_tiles = (tq + kQ - 1) / kQ;
  int start = 0;
  if (causal) {
    // q tiles whose last row sits above the block's first key see none
    // of its keys
    const int first = k_off + k_base - q_off;
    start = first <= 0 ? 0 : min(n_tiles, first / kQ);
  }

  auto load_tile = [&](int t, int stage) {
    const int q0 = t * kQ;
    load_rows<D, kQ>(sq + stage * kQ * S, qb, q0, tq);
    load_rows<D, kQ>(sdo + stage * kQ * S, dob, q0, tq);
    load_floats(slse + stage * kQ, lb, q0, kQ, tq);
    load_floats(sdelta + stage * kQ, db, q0, kQ, tq);
  };
  load_rows<D, kBlockRows>(sk, k + bh * tk * D, k_base, tk);
  load_rows<D, kBlockRows>(sv, v + bh * tk * D, k_base, tk);
  cp_async_commit();
  if (start < n_tiles) load_tile(start, 0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  uint32_t kf[G::kSteps][4], vf[G::kSteps][4];
#pragma unroll
  for (int kk = 0; kk < G::kSteps; ++kk) {
    ldsm_x4(kf[kk], a_addr<D>(sk, warp * kWarpRows, kk * 16, lane));
    ldsm_x4(vf[kk], a_addr<D>(sv, warp * kWarpRows, kk * 16, lane));
  }
  float dk_acc[kDTiles][4], dv_acc[kDTiles][4];
#pragma unroll
  for (int j = 0; j < kDTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;
  const int key = k_base + warp * kWarpRows + g;  // and key + 8

  for (int t = start; t < n_tiles; ++t) {
    const int stage = (t - start) & 1;
    if (t + 1 < n_tiles) load_tile(t + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* qs = sq + stage * kQ * S;
    const bf16* dos = sdo + stage * kQ * S;
    const float* ls = slse + stage * kQ;
    const float* ds = sdelta + stage * kQ;
    const int q0 = t * kQ;

    // S^T = K . Qs^T, Qs = (q.f32 * scale).bf16
    float st[kQTiles][4];
#pragma unroll
    for (int j = 0; j < kQTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < G::kSteps; ++kk)
#pragma unroll
      for (int np = 0; np < kQ / 16; ++np) {
        uint32_t b[4];
        ldsm_x4(b, b_addr<D>(qs, np * 16, kk * 16, lane));
#pragma unroll
        for (int i = 0; i < 4; ++i) b[i] = scale_bf16x2(b[i], scale);
        mma(st[2 * np], kf[kk], b[0], b[1]);
        mma(st[2 * np + 1], kf[kk], b[2], b[3]);
      }

    // P^T = exp(S^T - lse), masked entries selected to 0
    const bool masked =
        q0 + kQ > tq || k_base + kBlockRows > tk ||
        (causal && k_off + k_base + kBlockRows - 1 > q_off + q0);
#pragma unroll
    for (int j = 0; j < kQTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t4 + (e & 1);
        float p = expf(st[j][e] - ls[c]);
        if (masked && !(q0 + c < tq && visible(q0 + c, key + (e >> 1) * 8,
                                               tk, causal, q_off, k_off)))
          p = 0.f;
        st[j][e] = p;
      }

    // dV += round(P^T) . dO
#pragma unroll
    for (int kk = 0; kk < kQ / 16; ++kk) {
      uint32_t a[4];
      c_to_a(a, st[2 * kk], st[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t b[4];
        ldsm_x4_t(b, a_addr<D>(dos, kk * 16, np * 16, lane));
        mma(dv_acc[2 * np], a, b[0], b[1]);
        mma(dv_acc[2 * np + 1], a, b[2], b[3]);
      }
    }

    // dP^T = V . dO^T, then dS^T = P^T (dP^T - delta) in its place
    float dpt[kQTiles][4];
#pragma unroll
    for (int j = 0; j < kQTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < G::kSteps; ++kk)
#pragma unroll
      for (int np = 0; np < kQ / 16; ++np) {
        uint32_t b[4];
        ldsm_x4(b, b_addr<D>(dos, np * 16, kk * 16, lane));
        mma(dpt[2 * np], vf[kk], b[0], b[1]);
        mma(dpt[2 * np + 1], vf[kk], b[2], b[3]);
      }
#pragma unroll
    for (int j = 0; j < kQTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dpt[j][e] = __fmul_rn(
            st[j][e], __fsub_rn(dpt[j][e], ds[8 * j + 2 * t4 + (e & 1)]));

    // dK += round(dS^T) . Q, Q unscaled
#pragma unroll
    for (int kk = 0; kk < kQ / 16; ++kk) {
      uint32_t a[4];
      c_to_a(a, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t b[4];
        ldsm_x4_t(b, a_addr<D>(qs, kk * 16, np * 16, lane));
        mma(dk_acc[2 * np], a, b[0], b[1]);
        mma(dk_acc[2 * np + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // this stage is refilled at iteration t + 1
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = key + 8 * r;
    if (kj >= tk) continue;
    bf16* dkrow = dk + (bh * tk + kj) * D;
    bf16* dvrow = dv + (bh * tk + kj) * D;
#pragma unroll
    for (int j = 0; j < kDTiles; ++j) {
      const int c = 8 * j + 2 * t4;
      *reinterpret_cast<uint32_t*>(dkrow + c) =
          pack_bf16(__fmul_rn(dk_acc[j][2 * r], scale),
                    __fmul_rn(dk_acc[j][2 * r + 1], scale));
      *reinterpret_cast<uint32_t*>(dvrow + c) =
          pack_bf16(dv_acc[j][2 * r], dv_acc[j][2 * r + 1]);
    }
  }
}

cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse,
                        const float* delta, void* dk, void* dv, int bh,
                        int tq, int tk, int d, float scale, int causal,
                        int q_off, int k_off, cudaStream_t stream) {
  using B = const __nv_bfloat16*;
  return with_head_dim(d, [&](auto dd) {
    constexpr int D = decltype(dd)::value;
    constexpr int smem = dkv_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_mma_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(bh, (tk + flash_mma::kBlockRows - 1) /
                            flash_mma::kBlockRows);
    flash_bwd_dkv_mma_kernel<D><<<grid, flash_mma::kThreads, smem, stream>>>(
        static_cast<B>(q), static_cast<B>(k), static_cast<B>(v),
        static_cast<B>(dout), lse, delta, static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), tq, tk, scale, causal, q_off, k_off);
    return cudaGetLastError();
  });
}

}  // namespace

// q/dout: [bh, tq, d], k/v/dk/dv: [bh, tk, d], contiguous, dtype
// `dtype` (bf16 rows 16-byte aligned, for cp.async; bf16 runs on the
// tensor cores, float32 on the CUDA cores); lse/delta: [bh, tq] float32.
// Returns cudaGetLastError() after the launch on `stream` of device
// `device`.
extern "C" int hvd_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv,
                                 int bh, int tq, int tk, int d, float scale,
                                 int causal, int q_off, int k_off, int dtype,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_bf16(q, k, v, dout, l, dl, dk, dv, bh, tq, tk, d, scale,
                       causal, q_off, k_off, s);
  if (dtype == kF32)
    return launch_f32(q, k, v, dout, l, dl, dk, dv, bh, tq, tk, d, scale,
                         causal, q_off, k_off, s);
  return cudaErrorInvalidValue;
}
