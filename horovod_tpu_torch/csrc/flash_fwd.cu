// Flash-attention forward: O and the float32 row logsumexp.
//
// Replaces: horovod_tpu/ops/pallas_attention.py `_flash_fwd_kernel`
// (pallas_call in `_flash_core`), the forward of `flash_attention`.
//
// Semantics kept from the TPU kernel:
//   * q is scaled in float32 and rounded to the input dtype before Q.K^T;
//   * logits, the running max m and sum l are float32; p is rounded to
//     the input dtype before P.V, whose sum is float32;
//   * masked entries of p are selected to 0, so a row with no visible
//     key gives O = 0 and lse = -1e30 (NEG_INF);
//   * the causal mask is on global positions (query_offset/key_offset)
//     and kv tiles above the diagonal are never visited
//     (`_causal_kv_limit`); T need not be a tile multiple (bounds, not
//     padding).
//
// What bounds it on an H100: at GPT-2-medium shapes ([8, 16, 1024, 64]
// bf16, causal) the least time is its bytes, 67.6 MB of q/k/v/o/lse at
// 3.35 TB/s, 0.0202 ms (its 17.2 GFLOP take 0.0174 ms at 989 TFLOP/s).
//
// bf16 (the training path): `flash_fwd_mma_kernel`, on the tensor
// cores (flash_mma.cuh). A block of 4 warps holds 64 query rows, 16 a
// warp, as mma A fragments in registers (loaded once with ldmatrix,
// scaled and rounded there). K and V stream in bf16 tiles of kKvTile
// rows through a two-stage cp.async ring. S = Qs.K^T takes K's
// fragments from ldmatrix; the online softmax runs on the accumulator
// fragments (a thread holds rows lane/4 and lane/4 + 8; a row's max
// meets in two xor-shuffles, its sum once after the loop); p is rounded
// to bf16 and repacked from the C fragments straight into the A
// fragments of O += P.V, whose V fragments come from ldmatrix.trans.
// Masks apply only to tiles that cross the causal diagonal or the end
// of K (the TPU kernel's static `masked`). The heaviest causal blocks
// (last query rows) are launched first.
//
// float32: `flash_fwd_kernel`, the CUDA-core kernel of flash.cuh (TF32
// tensor cores would not meet float32's tolerance).

#include "flash_mma.cuh"

namespace {

using namespace flash;

template <typename T, int D>
__global__ void __launch_bounds__(Shape<D>::kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int tq, int tk, float scale,
                     int causal, int q_off, int k_off) {
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

  float qr[S::kDims], acc[S::kDims];
  load_part<T, D>(qr, q + (bh * tq + qi) * D, part, live);
#pragma unroll
  for (int i = 0; i < S::kDims; ++i) {
    qr[i] = round_to<T>(__fmul_rn(qr[i], scale));
    acc[i] = 0.f;
  }
  float m = kNegInf, l = 0.f;

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

    float s[kTile];
    float m_cur = kNegInf;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const float x = sum_parts<D>(dot_part<D>(qr, sk + j * D, part));
      s[j] = visible(qi, k0 + j, tk, causal, q_off, k_off) ? x : kNegInf;
      m_cur = fmaxf(m_cur, s[j]);
    }
    const float m_new = fmaxf(m, m_cur);
    const float alpha = expf(m - m_new);
#pragma unroll
    for (int i = 0; i < S::kDims; ++i) acc[i] *= alpha;
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const float p = visible(qi, k0 + j, tk, causal, q_off, k_off)
                          ? expf(s[j] - m_new)
                          : 0.f;
      psum += p;
      axpy_part<D>(acc, round_to<T>(p), sv + j * D, part);
    }
    l = l * alpha + psum;
    m = m_new;
  }

  if (!live) return;
  const float safe_l = l > 0.f ? l : 1.f;
#pragma unroll
  for (int i = 0; i < S::kDims; ++i) acc[i] = __fdiv_rn(acc[i], safe_l);
  store_part<T, D>(o + (bh * tq + qi) * D, acc, 1.f, part);
  if (part == 0) lse[bh * tq + qi] = l > 0.f ? m + logf(safe_l) : kNegInf;
}

// float32, on the CUDA cores
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       void* o, float* lse, int bh, int tq, int tk, int d,
                       float scale, int causal, int q_off, int k_off,
                       cudaStream_t stream) {
  using F = const float*;
  return with_head_dim(d, [&](auto dd) {
    constexpr int D = decltype(dd)::value;
    const dim3 grid(bh, (tq + kRows - 1) / kRows);
    flash_fwd_kernel<float, D><<<grid, Shape<D>::kThreads, 0, stream>>>(
        static_cast<F>(q), static_cast<F>(k), static_cast<F>(v),
        static_cast<float*>(o), lse, tq, tk, scale, causal, q_off, k_off);
    return cudaGetLastError();
  });
}

// ---- bf16 on the tensor cores ---------------------------------------------

constexpr int kKvTile = 64;  // key rows of a streamed K/V tile (bf16)

template <int D>
__global__ void __launch_bounds__(flash_mma::kThreads)
    flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                   int tq, int tk, float scale, int causal, int q_off,
                   int k_off) {
  using namespace flash_mma;
  using G = Geometry<D>;
  constexpr int S = G::kStride;
  constexpr int kKTiles = kKvTile / 8;  // n8 tiles of S a warp
  constexpr int kDTiles = D / 8;        // n8 tiles of O a warp
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);  // [kBlockRows][S]
  bf16* sk = sq + kBlockRows * S;            // [2][kKvTile][S]
  bf16* sv = sk + 2 * kKvTile * S;           // [2][kKvTile][S]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t bh = blockIdx.x;
  const int q_base = (gridDim.y - 1 - blockIdx.y) * kBlockRows;
  const bf16* kb = k + bh * tk * D;
  const bf16* vb = v + bh * tk * D;

  const int n_tiles = (tk + kKvTile - 1) / kKvTile;
  const int limit =
      causal ? causal_kv_limit(min(q_base + kBlockRows, tq) - 1, q_off,
                               k_off, kKvTile, n_tiles)
             : n_tiles;

  load_rows<D, kBlockRows>(sq, q + bh * tq * D, q_base, tq);
  cp_async_commit();
  if (limit > 0) {
    load_rows<D, kKvTile>(sk, kb, 0, tk);
    load_rows<D, kKvTile>(sv, vb, 0, tk);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // this warp's 16 query rows, scaled and rounded: (q.f32 * scale).bf16
  uint32_t qf[G::kSteps][4];
#pragma unroll
  for (int kk = 0; kk < G::kSteps; ++kk) {
    ldsm_x4(qf[kk], a_addr<D>(sq, warp * kWarpRows, kk * 16, lane));
#pragma unroll
    for (int i = 0; i < 4; ++i) qf[kk][i] = scale_bf16x2(qf[kk][i], scale);
  }

  float acc[kDTiles][4];
#pragma unroll
  for (int j = 0; j < kDTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  // rows r0 = row and r1 = row + 8: running max, and this thread's
  // share of the running sum (the four shares meet after the loop)
  const int row = q_base + warp * kWarpRows + g;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int t = 0; t < limit; ++t) {
    if (t + 1 < limit) {
      const int nxt = (t + 1) & 1;
      load_rows<D, kKvTile>(sk + nxt * kKvTile * S, kb, (t + 1) * kKvTile,
                            tk);
      load_rows<D, kKvTile>(sv + nxt * kKvTile * S, vb, (t + 1) * kKvTile,
                            tk);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* ks = sk + (t & 1) * kKvTile * S;
    const bf16* vs = sv + (t & 1) * kKvTile * S;
    const int k0 = t * kKvTile;

    float s[kKTiles][4];
#pragma unroll
    for (int j = 0; j < kKTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < G::kSteps; ++kk)
#pragma unroll
      for (int np = 0; np < kKvTile / 16; ++np) {
        uint32_t b[4];
        ldsm_x4(b, b_addr<D>(ks, np * 16, kk * 16, lane));
        mma(s[2 * np], qf[kk], b[0], b[1]);
        mma(s[2 * np + 1], qf[kk], b[2], b[3]);
      }

    // the tile crosses the end of K or the causal diagonal of the block
    const bool masked =
        k0 + kKvTile > tk ||
        (causal && k_off + k0 + kKvTile - 1 > q_off + q_base);
    uint32_t vis = 0xffffffffu;  // bit 4j + e: element s[j][e] is seen
    if (masked) {
#pragma unroll
      for (int j = 0; j < kKTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = k0 + 8 * j + 2 * t4 + (e & 1);
          if (!visible(row + (e >> 1) * 8, kj, tk, causal, q_off, k_off)) {
            vis &= ~(1u << (4 * j + e));
            s[j][e] = kNegInf;
          }
        }
    }
    float m_new[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kKTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        m_new[e >> 1] = fmaxf(m_new[e >> 1], s[j][e]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 1));
      m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 2));
    }
    const float alpha[2] = {expf(m[0] - m_new[0]), expf(m[1] - m_new[1])};
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kKTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = expf(s[j][e] - m_new[e >> 1]);
        if (!((vis >> (4 * j + e)) & 1u)) p = 0.f;
        s[j][e] = p;
        psum[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = l[r] * alpha[r] + psum[r];
      m[r] = m_new[r];
    }
#pragma unroll
    for (int j = 0; j < kDTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];

    // O += round(P) . V: P from the S accumulators, V from ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < kKvTile / 16; ++kk) {
      uint32_t a[4];
      c_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t b[4];
        ldsm_x4_t(b, a_addr<D>(vs, kk * 16, np * 16, lane));
        mma(acc[2 * np], a, b[0], b[1]);
        mma(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // stage t & 1 is refilled at iteration t + 1
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row + 8 * r;
    if (qi >= tq) continue;
    const float safe_l = l[r] > 0.f ? l[r] : 1.f;
    bf16* orow = o + (bh * tq + qi) * D;
#pragma unroll
    for (int j = 0; j < kDTiles; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t4) =
          pack_bf16(__fdiv_rn(acc[j][2 * r], safe_l),
                    __fdiv_rn(acc[j][2 * r + 1], safe_l));
    if (t4 == 0)
      lse[bh * tq + qi] = l[r] > 0.f ? m[r] + logf(safe_l) : kNegInf;
  }
}

cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        float* lse, int bh, int tq, int tk, int d,
                        float scale, int causal, int q_off, int k_off,
                        cudaStream_t stream) {
  return with_head_dim(d, [&](auto dd) {
    constexpr int D = decltype(dd)::value;
    using flash_mma::kBlockRows;
    const int smem = (kBlockRows + 4 * kKvTile) *
                     flash_mma::Geometry<D>::kStride * 2;
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_mma_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(bh, (tq + kBlockRows - 1) / kBlockRows);
    flash_fwd_mma_kernel<D><<<grid, flash_mma::kThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(o), lse, tq, tk, scale, causal, q_off,
        k_off);
    return cudaGetLastError();
  });
}

}  // namespace

// q: [bh, tq, d], k/v: [bh, tk, d], o: [bh, tq, d], all contiguous of
// dtype `dtype` (kF32 / kBF16; bf16 rows 16-byte aligned, for cp.async);
// lse: [bh, tq] float32. d is 16, 32, 64 or 128. bf16 runs on the
// tensor cores, float32 on the CUDA cores. Launches on `stream` of CUDA
// device `device`; returns cudaGetLastError() after the launch.
extern "C" int hvd_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int bh, int tq, int tk,
                             int d, float scale, int causal, int q_off,
                             int k_off, int dtype, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_bf16(q, k, v, o, l, bh, tq, tk, d, scale, causal, q_off,
                       k_off, s);
  if (dtype == kF32)
    return launch_f32(q, k, v, o, l, bh, tq, tk, d, scale, causal, q_off,
                         k_off, s);
  return cudaErrorInvalidValue;
}
