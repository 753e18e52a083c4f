// Decode append + attend over a float32 or bfloat16 slotted KV cache.
//
// Replaces: horovod_tpu/ops/pallas_collectives.py
// `_append_attend_kernel` (launched by `decode_append_attend`), the TPU
// kernel that merges the new K/V rows into one layer of the slotted
// cache and attends over the merged slice.
//
// Function (the plain version is serving/decode.py
// `SlottedKVCache.update` + models/transformer.py `cached_attention`):
//   * merge: cache row m of batch row b becomes the float32 sum, in t
//     order, of the new rows t with positions[b, t] == m, cast to the
//     cache dtype; rows no position hits keep their value; a position
//     outside [0, M) writes nothing. Only the replaced rows are
//     written, in place, into the layer's strided view of the cache
//     buffer. (A kept row that holds -0.0 stays -0.0, where the plain
//     `cache * 1 + 0` gives +0.0: compare buffers with ==.)
//   * attend: query row t of head h reads kv head h / (H / KH) over
//     the merged rows j <= positions[b, t] (all M rows, masked -1e30,
//     when the position lies outside [0, M)). Rounding points of the
//     plain version: logits rounded to the compute dtype, then scaled
//     in float32; a float32 softmax with the row's exact maximum;
//     probabilities rounded to the compute dtype; PV summed in float32
//     and rounded once.
//
// Every route builds its batch row's cover table (which new row
// replaces which cache row) in shared memory and reads a replaced row
// straight from the new rows, never from the cache, so no block reads
// a row another block writes: blocks have no order, and the write needs
// no second kernel.
//
// What bounds it on an H100: bytes. A decode step reads each valid K
// and V row once (B * KH * (pos + 1) * D elements each) and does 4 flops
// per element read per query head sharing it; a prefill of T rows (H =
// KH, float32 cache) does about 2 T^2 H D flops over 16 T H D bytes,
// T / 8 flops a byte (128 at T = 1024), below the card's ~295 for bf16
// tensor cores.
//
// Routes (the C entry point picks one and reports it):
//
// * prefill (bf16 compute, T >= kPrefillMinT): `prefill_mma_kernel`, on
//   the tensor cores (flash_mma.cuh). One block per (query tile of 64
//   rows, head, batch row), the causally heaviest tiles launched first:
//   key groups of 4 warps (4 groups at head_dim 64, 2 at 128), each warp
//   16 query rows on `mma.sync` m16n8k16, group k of n taking the key
//   tiles k, k + n, ... The heaviest
//   block sets the kernel's time, so its key tiles are split: the groups
//   meet once for each row's maximum and sum and once to add their
//   partial output rows, in group order.
//   Merged K/V rows stream through shared memory in bf16 tiles of 64
//   rows: a tile whose rows are each a fresh row covered exactly once
//   (the engine's whole prefill) or a kept row of a bf16 cache arrives
//   by 16-byte `cp.async` into a two-stage ring; any other tile (kept
//   rows of a float32 cache, repeated positions) is gathered by threads
//   through the exact merge of `FpRows`. Two passes over K keep the
//   plain version's P = round(exp(l - max) / sum): pass 1 computes the
//   logits and each row's maximum and sum (the running sum rescaled
//   when the maximum rises), pass 2 recomputes them, forms the rounded
//   P in the A fragments and accumulates P.V. Key tiles past a warp's
//   last visible row are skipped. Bound: the second Q.K^T is a third
//   more tensor-core work, on a kernel far below the operations line;
//   what the card spends is the float32 softmax per logit (exp, an IEEE
//   division) on the heaviest block's path.
//
// * decode (bf16 compute, T < kPrefillMinT): decode_cluster.cuh's
//   `decode_cluster_kernel`, one thread-block cluster per (batch row, kv
//   head), its CTAs exchanging each query's maximum and sum through
//   distributed shared memory, with the float caches' row policy
//   `FpDecodeRows` below (16-byte loads of a kept row or of a fresh row
//   covered once, the element-wise merge for a repeated position).
//
// * CUDA cores (float32 compute; a head_dim other than 64 or 128;
//   rows not 16-byte aligned; a call whose shared memory the route above
//   for its T cannot hold: a long cache, or a decode call whose T * H / KH
//   query rows outgrow it): `append_attend_kernel`, one block per (head,
//   query row, batch row) over attend.cuh's `attend_row`.

#include <type_traits>

#include "decode_cluster.cuh"
#include "flash_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kQueryTile = 64;    // query rows a prefill block holds
constexpr int kKeyTile = 64;      // merged rows a prefill K/V tile holds
static_assert(kQueryTile == flash_mma::kBlockRows, "a warp's m16 rows");
static_assert(kPrefillMinT == flash_mma::kWarpRows, "one m16 tile of rows");

// Merged rows of one (batch row, kv head) of a float cache.
template <typename TQ, typename TC>
struct FpRows {
  const TC* cache;   // [M, D]
  const TQ* fresh;   // new row t at fresh + t * stride_t, [D]
  int stride_t;
  const int* pos_b;  // [T]
  const int* first;
  const int* count;
  int T, D;

  // float32 value of the merge before the cast to the cache dtype
  __device__ __forceinline__ float merged(int m, int d) const {
    const int c = count[m];
    if (c == 0) return to_f32(cache[(size_t)m * D + d]);
    const int t0 = first[m];
    float acc = 0.f + to_f32(fresh[(size_t)t0 * stride_t + d]);
    if (c > 1) {
      for (int t = t0 + 1; t < T; ++t)
        if (pos_b[t] == m) acc += to_f32(fresh[(size_t)t * stride_t + d]);
    }
    return acc;
  }

  // element of the merged row in the compute dtype
  __device__ __forceinline__ float operator()(int m, int d) const {
    return round_to<TQ>(round_to<TC>(merged(m, d)));
  }
};

// Eight values of a row chunk, as float32, to the cache dtype.
__device__ __forceinline__ void store8(float* dst, const float (&v)[8]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(bf16* dst, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(
      flash_mma::pack_bf16(v[0], v[1]), flash_mma::pack_bf16(v[2], v[3]),
      flash_mma::pack_bf16(v[4], v[5]), flash_mma::pack_bf16(v[6], v[7]));
}

// The replaced rows this block writes, as the float32 merge cast to the
// cache dtype: for r < n_rows, `row_of(r)` is the merged row the block
// writes, or -1. A row one new row covers is a copy (0 + x, as the
// merge adds it) by 16-byte loads, four chunks a thread loaded before
// any is stored; a repeated position takes the element-wise merge.
template <typename TC, typename RowOf>
__device__ __forceinline__ void write_rows(TC* kc, TC* vc,
                                           const FpRows<bf16, TC>& kr,
                                           const FpRows<bf16, TC>& vr,
                                           int n_rows, RowOf row_of) {
  constexpr int kBatch = 4;
  const int D = kr.D, chunks = D / 8, n = n_rows * chunks;
  for (int i0 = threadIdx.x; i0 < n; i0 += kBatch * blockDim.x) {
    uint4 kw[kBatch], vw[kBatch];
    int m[kBatch], d0[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * blockDim.x;
      m[u] = i < n ? row_of(i / chunks) : -1;
      d0[u] = (i % chunks) * 8;
      if (m[u] >= 0 && kr.count[m[u]] == 1) {
        const size_t f = (size_t)kr.first[m[u]] * kr.stride_t + d0[u];
        kw[u] = __ldg(reinterpret_cast<const uint4*>(kr.fresh + f));
        vw[u] = __ldg(reinterpret_cast<const uint4*>(vr.fresh + f));
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (m[u] < 0) continue;
      float kv[8], vv[8];
      if (kr.count[m[u]] == 1) {
        const uint32_t kx[4] = {kw[u].x, kw[u].y, kw[u].z, kw[u].w};
        const uint32_t vx[4] = {vw[u].x, vw[u].y, vw[u].z, vw[u].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          kv[2 * e] = 0.f + __uint_as_float(kx[e] << 16);
          kv[2 * e + 1] = 0.f + __uint_as_float(kx[e] & 0xffff0000u);
          vv[2 * e] = 0.f + __uint_as_float(vx[e] << 16);
          vv[2 * e + 1] = 0.f + __uint_as_float(vx[e] & 0xffff0000u);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          kv[e] = round_to<TC>(kr.merged(m[u], d0[u] + e));
          vv[e] = round_to<TC>(vr.merged(m[u], d0[u] + e));
        }
      }
      store8(kc + (size_t)m[u] * D + d0[u], kv);
      store8(vc + (size_t)m[u] * D + d0[u], vv);
    }
  }
}

// ---- CUDA cores: float32 compute and the shapes the routes below refuse

template <typename TQ, typename TC, int kLanes>
__global__ void __launch_bounds__(kMaxThreads)
    append_attend_kernel(const TQ* __restrict__ q, TC* kc, TC* vc,
                         long long slot_stride, const TQ* __restrict__ kn,
                         const TQ* __restrict__ vn,
                         const int* __restrict__ pos, TQ* __restrict__ out,
                         int T, int H, int KH, int M, int D, float scale) {
  extern __shared__ float smem[];
  int* first = reinterpret_cast<int*>(smem);
  int* count = first + M;
  const int h = blockIdx.x, t = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int* pos_b = pos + (size_t)b * T;
  build_cover(pos_b, T, M, first, count);

  const size_t slice = (size_t)b * slot_stride + (size_t)kh * M * D;
  const size_t fresh = (size_t)b * T * KH * D + (size_t)kh * D;
  const FpRows<TQ, TC> krows{kc + slice, kn + fresh, KH * D, pos_b,
                             first, count, T, D};
  const FpRows<TQ, TC> vrows{vc + slice, vn + fresh, KH * D, pos_b,
                             first, count, T, D};
  const int p_t = pos_b[t];

  // the first head of the kv group writes the row this t replaces
  // (the first t of a duplicated position writes the summed row)
  if (h % (H / KH) == 0 && p_t >= 0 && p_t < M && first[p_t] == t) {
    for (int d = threadIdx.x; d < D; d += blockDim.x) {
      kc[slice + (size_t)p_t * D + d] = from_f32<TC>(krows.merged(p_t, d));
      vc[slice + (size_t)p_t * D + d] = from_f32<TC>(vrows.merged(p_t, d));
    }
  }

  const size_t row = ((size_t)b * T + t) * H + h;
  attend_row<kLanes, TQ>(q + row * D, D, M, p_t, scale, krows, vrows, smem,
                 out + row * D);
}

template <typename TQ, typename TC, int kLanes>
cudaError_t launch_lanes(const void* q, void* kc, void* vc,
                         long long slot_stride, const void* kn,
                         const void* vn, const int* pos, void* out, int B,
                         int T, int H, int KH, int M, int D, float scale,
                         cudaStream_t stream) {
  const int threads = attend_threads(B, T, H);
  const size_t smem = attend_smem_floats(M, D, threads) * sizeof(float);
  cudaError_t err = set_smem(append_attend_kernel<TQ, TC, kLanes>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, T, B);
  append_attend_kernel<TQ, TC, kLanes><<<grid, threads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<TC*>(kc), static_cast<TC*>(vc),
      slot_stride, static_cast<const TQ*>(kn), static_cast<const TQ*>(vn),
      pos, static_cast<TQ*>(out), T, H, KH, M, D, scale);
  return cudaGetLastError();
}

template <typename TQ, typename TC>
cudaError_t launch_cuda_cores(const void* q, void* kc, void* vc,
                              long long slot_stride, const void* kn,
                              const void* vn, const int* pos, void* out,
                              int B, int T, int H, int KH, int M, int D,
                              float scale, cudaStream_t stream) {
  if (D <= 64)
    return launch_lanes<TQ, TC, 2>(q, kc, vc, slot_stride, kn, vn, pos, out,
                                   B, T, H, KH, M, D, scale, stream);
  if (D <= 128)
    return launch_lanes<TQ, TC, 4>(q, kc, vc, slot_stride, kn, vn, pos, out,
                                   B, T, H, KH, M, D, scale, stream);
  if (D <= kMaxHeadDim)
    return launch_lanes<TQ, TC, 8>(q, kc, vc, slot_stride, kn, vn, pos, out,
                                   B, T, H, KH, M, D, scale, stream);
  return cudaErrorInvalidValue;
}

// ---- prefill: bf16 compute on the tensor cores ----------------------------

// Warp groups of 4 splitting a prefill block's key tiles: 4 at head_dim
// 64, 2 at 128, where four groups' K/V rings outgrow shared memory.
template <int D>
__host__ __device__ constexpr int key_groups() {
  return D <= 64 ? 4 : 2;
}
constexpr int kMaxKeyGroups = 4;

template <int D>
__host__ __device__ constexpr size_t prefill_tile_bytes() {
  // the block's query rows; each key group's two stages of K and V tiles
  return (size_t)(kQueryTile + key_groups<D>() * 4 * kKeyTile) *
         flash_mma::Geometry<D>::kStride * sizeof(bf16);
}

__host__ __device__ inline int key_tiles(int M) {
  return (M + kKeyTile - 1) / kKeyTile;
}

template <int D>
__host__ inline size_t prefill_smem_bytes(int M) {
  // then the cover table (2 M ints) and a fast-copy flag per key tile
  return prefill_tile_bytes<D>() + (2 * (size_t)M + key_tiles(M)) * 4;
}

// A barrier of the 128 threads of key group `grp` (ids 1.., 0 is
// __syncthreads).
__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + grp), "r"(flash_mma::kThreads)
               : "memory");
}

// exp(m - to) * s: a partial row sum taken at maximum m, rescaled to the
// maximum `to` (0 for a partial that saw no row)
__device__ __forceinline__ float rescale(float s, float m, float to) {
  return m == -INFINITY ? 0.f : __fmul_rn(s, expf(__fsub_rn(m, to)));
}

template <typename TC, int D>
__global__ void __launch_bounds__(key_groups<D>() * flash_mma::kThreads)
    prefill_mma_kernel(const bf16* __restrict__ q, TC* kc, TC* vc,
                       long long slot_stride, const bf16* __restrict__ kn,
                       const bf16* __restrict__ vn,
                       const int* __restrict__ pos, bf16* __restrict__ out,
                       int T, int H, int KH, int M, float scale) {
  using namespace flash_mma;
  using G = Geometry<D>;
  constexpr int S = G::kStride;
  constexpr int kChunks = D / 8;         // 16-byte chunks of a row
  constexpr int kKT = kKeyTile / 8;      // n8 tiles of S a warp
  constexpr int kDT = D / 8;             // n8 tiles of O a warp
  constexpr int kStage = kKeyTile * S;   // bf16 of one K or V tile
  constexpr bool kBf16Cache = std::is_same<TC, bf16>::value;
  constexpr int kKeyGroups = key_groups<D>();
  constexpr int kPrefillThreads = kKeyGroups * kThreads;
  extern __shared__ __align__(16) unsigned char tiles[];
  bf16* sq = reinterpret_cast<bf16*>(tiles);  // [kQueryTile][S]
  int* first = reinterpret_cast<int*>(tiles + prefill_tile_bytes<D>());
  int* count = first + M;
  int* fast = count + M;                     // [key_tiles(M)]
  __shared__ int block_end;
  __shared__ float part_max[kMaxKeyGroups][kQueryTile];
  __shared__ float part_sum[kMaxKeyGroups][kQueryTile];

  const int lane = threadIdx.x & 31;
  const int grp = threadIdx.x / kThreads;       // key group
  const int gtid = threadIdx.x % kThreads;      // thread of the group
  const int warp = gtid >> 5;                   // query rows of the warp
  const int g = lane >> 2, t4 = lane & 3;
  // this group's two stages of K tiles, then of V tiles
  bf16* sk = sq + kQueryTile * S + grp * 4 * kStage;
  bf16* sv = sk + 2 * kStage;
  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kQueryTile;
  const int rep = H / KH, kh = h / rep;
  const int* pos_b = pos + (size_t)b * T;

  // this block's query rows (row t of head h at stride H * D)
  for (int i = threadIdx.x; i < kQueryTile * kChunks; i += kPrefillThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool live = q0 + r < T;
    const bf16* src =
        q + (((size_t)b * T + (live ? q0 + r : 0)) * H + h) * D + c * 8;
    cp_async16(sq + r * S + c * 8, src, live);
  }
  cp_async_commit();

  if (threadIdx.x == 0) block_end = 0;
  build_cover(pos_b, T, M, first, count);
  const int tid = threadIdx.x;
  if (tid < kQueryTile && q0 + tid < T)
    atomicMax(&block_end, row_end(pos_b[q0 + tid], M));
  const int n_all = key_tiles(M);
  for (int i = tid; i < n_all; i += kPrefillThreads) fast[i] = 1;
  __syncthreads();
  // a tile copies by cp.async when each row is a fresh row covered once
  // or a kept row already in bf16
  const int n_tiles = (block_end + kKeyTile - 1) / kKeyTile;
  for (int j = tid; j < min(M, n_tiles * kKeyTile); j += kPrefillThreads) {
    const int c = count[j];
    if (!(c == 1 || (c == 0 && kBf16Cache))) fast[j / kKeyTile] = 0;
  }
  __syncthreads();

  const size_t slice = (size_t)b * slot_stride + (size_t)kh * M * D;
  const size_t fresh = (size_t)b * T * KH * D + (size_t)kh * D;
  const FpRows<bf16, TC> krows{kc + slice, kn + fresh, KH * D, pos_b,
                               first, count, T, D};
  const FpRows<bf16, TC> vrows{vc + slice, vn + fresh, KH * D, pos_b,
                               first, count, T, D};

  // merged rows [tile * kKeyTile, + kKeyTile) into a padded bf16 tile by
  // the group's threads; rows at or past M are zero
  auto stage = [&](bf16* dst, const FpRows<bf16, TC>& rows, int tile) {
    const int j0 = tile * kKeyTile;
    if (fast[tile]) {
      for (int i = gtid; i < kKeyTile * kChunks; i += kThreads) {
        const int r = i / kChunks, c = i % kChunks, j = j0 + r;
        const bool live = j < M;
        const bf16* src = rows.fresh;
        if (live) {
          if constexpr (kBf16Cache) {
            src = count[j] == 1 ? rows.fresh + (size_t)first[j] * KH * D
                                : rows.cache + (size_t)j * D;
          } else {
            src = rows.fresh + (size_t)first[j] * KH * D;
          }
        }
        cp_async16(dst + r * S + c * 8, src + c * 8, live);
      }
    } else {
      for (int i = gtid; i < kKeyTile * D; i += kThreads) {
        const int r = i / D, d = i % D, j = j0 + r;
        dst[r * S + d] = __float2bfloat16_rn(j < M ? rows(j, d) : 0.f);
      }
    }
  };

  // rows r = 0, 1 of this lane: query rows g and g + 8 of the warp
  const int row = q0 + warp * kWarpRows + g;
  int p[2], mend[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool live = row + 8 * r < T;
    p[r] = live ? pos_b[row + 8 * r] : -1;
    mend[r] = live ? row_end(p[r], M) : 0;
  }
  const int warp_end = __reduce_max_sync(0xffffffffu, max(mend[0], mend[1]));
  // group grp takes the key tiles grp, grp + kKeyGroups, ...
  const int n_mine = (n_tiles - grp + kKeyGroups - 1) / kKeyGroups;
  auto tile_of = [&](int it) { return grp + it * kKeyGroups; };

  if (n_mine > 0) stage(sk, krows, tile_of(0));
  cp_async_commit();
  cp_async_wait<1>();  // the query rows
  __syncthreads();
  uint32_t qf[G::kSteps][4];
#pragma unroll
  for (int kk = 0; kk < G::kSteps; ++kk)
    ldsm_x4(qf[kk], a_addr<D>(sq, warp * kWarpRows, kk * 16, lane));

  // S = Q . K^T of one key tile, K from ldmatrix (n-major)
  auto qk = [&](float (&s)[kKT][4], const bf16* ks) {
#pragma unroll
    for (int j = 0; j < kKT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < G::kSteps; ++kk)
#pragma unroll
      for (int np = 0; np < kKeyTile / 16; ++np) {
        uint32_t bb[4];
        ldsm_x4(bb, b_addr<D>(ks, np * 16, kk * 16, lane));
        mma(s[2 * np], qf[kk], bb[0], bb[1]);
        mma(s[2 * np + 1], qf[kk], bb[2], bb[3]);
      }
  };

  // pass 1: each row's maximum and sum of exp(l - max) over the group's
  // tiles
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
  for (int it = 0; it < n_mine; ++it) {
    if (it + 1 < n_mine)
      stage(sk + ((it + 1) & 1) * kStage, krows, tile_of(it + 1));
    cp_async_commit();
    cp_async_wait<1>();
    group_sync(grp);
    const int j0 = tile_of(it) * kKeyTile;
    if (j0 < warp_end) {
      float s[kKT][4];
      qk(s, sk + (it & 1) * kStage);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float tmax = -INFINITY;
#pragma unroll
        for (int jt = 0; jt < kKT; ++jt)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            const int j = j0 + 8 * jt + 2 * t4 + (e & 1);
            s[jt][e] = j < mend[r] ? logit(s[jt][e], j, p[r], scale)
                                   : -INFINITY;
            tmax = fmaxf(tmax, s[jt][e]);
          }
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
        if (tmax > mx[r]) {
          sum[r] = rescale(sum[r], mx[r], tmax);
          mx[r] = tmax;
        }
#pragma unroll
        for (int jt = 0; jt < kKT; ++jt)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e)
            if (s[jt][e] != -INFINITY)  // mx may still be -inf
              sum[r] += expf(__fsub_rn(s[jt][e], mx[r]));
      }
    }
    group_sync(grp);  // stage it & 1 is refilled at iteration it + 1
  }
  cp_async_wait<0>();
  // the groups' maxima and sums meet: every row's maximum, and its sum
  // rescaled to it and added in group order (both groups compute it)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    if (t4 == 0) {
      part_max[grp][warp * kWarpRows + g + 8 * r] = mx[r];
      part_sum[grp][warp * kWarpRows + g + 8 * r] = sum[r];
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = warp * kWarpRows + g + 8 * r;
    float m = part_max[0][i];
#pragma unroll
    for (int k = 1; k < kKeyGroups; ++k) m = fmaxf(m, part_max[k][i]);
    float total = 0.f;
#pragma unroll
    for (int k = 0; k < kKeyGroups; ++k)
      total += rescale(part_sum[k][i], part_max[k][i], m);
    mx[r] = m;
    sum[r] = total;
  }

  // pass 2: P = round(exp(l - max) / sum) and O = P . V over the group's
  // tiles
  float acc[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  if (n_mine > 0) {
    stage(sk, krows, tile_of(0));
    stage(sv, vrows, tile_of(0));
  }
  cp_async_commit();
  for (int it = 0; it < n_mine; ++it) {
    if (it + 1 < n_mine) {
      const int nxt = (it + 1) & 1;
      stage(sk + nxt * kStage, krows, tile_of(it + 1));
      stage(sv + nxt * kStage, vrows, tile_of(it + 1));
    }
    cp_async_commit();
    cp_async_wait<1>();
    group_sync(grp);
    const int j0 = tile_of(it) * kKeyTile;
    if (j0 < warp_end) {
      float s[kKT][4];
      qk(s, sk + (it & 1) * kStage);
#pragma unroll
      for (int jt = 0; jt < kKT; ++jt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, j = j0 + 8 * jt + 2 * t4 + (e & 1);
          // c_to_a rounds P to bf16, where the plain version does
          s[jt][e] = j < mend[r]
                         ? __fdiv_rn(expf(__fsub_rn(
                                         logit(s[jt][e], j, p[r], scale),
                                         mx[r])),
                                     sum[r])
                         : 0.f;
        }
      const bf16* vs = sv + (it & 1) * kStage;
#pragma unroll
      for (int kk = 0; kk < kKeyTile / 16; ++kk) {
        uint32_t a[4];
        c_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int np = 0; np < D / 16; ++np) {
          uint32_t bb[4];
          ldsm_x4_t(bb, a_addr<D>(vs, kk * 16, np * 16, lane));
          mma(acc[2 * np], a, bb[0], bb[1]);
          mma(acc[2 * np + 1], a, bb[2], bb[3]);
        }
      }
    }
    group_sync(grp);
  }
  cp_async_wait<0>();

  // the groups' partial O rows meet in group order through the K/V tile
  // space, and group 0 writes the output
  float* obuf = reinterpret_cast<float*>(sq + kQueryTile * S);
  __syncthreads();
  if (grp > 0) {
#pragma unroll
    for (int j = 0; j < kDT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        obuf[(((grp - 1) * kThreads + gtid) * kDT + j) * 4 + e] = acc[j][e];
  }
  __syncthreads();
  if (grp == 0) {
#pragma unroll
    for (int k = 1; k < kKeyGroups; ++k)
#pragma unroll
      for (int j = 0; j < kDT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[j][e] += obuf[(((k - 1) * kThreads + gtid) * kDT + j) * 4 + e];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = row + 8 * r;
      if (t >= T) continue;
      bf16* orow = out + (((size_t)b * T + t) * H + h) * D;
#pragma unroll
      for (int j = 0; j < kDT; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t4) =
            pack_bf16(acc[j][2 * r], acc[j][2 * r + 1]);
    }
  }

  // the first head of the kv group writes the rows its query rows
  // replace (the first t of a repeated position writes the summed row)
  if (h % rep == 0)
    write_rows(kc + slice, vc + slice, krows, vrows,
               min(kQueryTile, T - q0), [&](int r) {
                 const int t = q0 + r, pt = pos_b[t];
                 return pt >= 0 && pt < M && first[pt] == t ? pt : -1;
               });
}

template <typename TC, int D>
cudaError_t launch_prefill(const void* q, void* kc, void* vc,
                           long long slot_stride, const void* kn,
                           const void* vn, const int* pos, void* out, int B,
                           int T, int H, int KH, int M, float scale,
                           cudaStream_t stream) {
  const size_t smem = prefill_smem_bytes<D>(M);
  cudaError_t err = set_smem(prefill_mma_kernel<TC, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, (T + kQueryTile - 1) / kQueryTile, B);
  prefill_mma_kernel<TC, D>
      <<<grid, key_groups<D>() * flash_mma::kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<TC*>(kc), static_cast<TC*>(vc),
      slot_stride, static_cast<const bf16*>(kn), static_cast<const bf16*>(vn),
      pos, static_cast<bf16*>(out), T, H, KH, M, scale);
  return cudaGetLastError();
}

// ---- decode: the float caches' row policy of decode_cluster.cuh -------

// One lane's kVec elements d0.. of merged row j: `fetch` loads them (one
// 16-byte load of a kept cache row, one 16- or 8-byte load of a fresh
// row covered once, nothing for a row to merge element-wise), and
// `values` gives them in the compute dtype (bf16 values held in
// float32).
struct ChunkLoad {
  uint4 raw;
  int kind;  // 0 kept cache row, 1 fresh row, 2 merge, 3 no row
};

__device__ __forceinline__ void unpack_bf16x2(uint32_t x, float* v) {
  v[0] = __uint_as_float(x << 16);
  v[1] = __uint_as_float(x & 0xffff0000u);
}

template <typename TC>
struct FpSide : FpRows<bf16, TC> {
  static constexpr int kVec = 16 / sizeof(TC);

  __device__ __forceinline__ void fetch(ChunkLoad& c, int j, int j_end,
                                        int d0) const {
    if (j >= j_end) {
      c.kind = 3;
      c.raw = make_uint4(0, 0, 0, 0);
      return;
    }
    const int n = this->count[j];
    if (n == 0) {
      c.kind = 0;
      c.raw = *reinterpret_cast<const uint4*>(this->cache +
                                              (size_t)j * this->D + d0);
    } else if (n == 1) {
      c.kind = 1;
      const bf16* src =
          this->fresh + (size_t)this->first[j] * this->stride_t + d0;
      if constexpr (kVec == 8) {
        c.raw = *reinterpret_cast<const uint4*>(src);
      } else {
        const uint2 h = *reinterpret_cast<const uint2*>(src);
        c.raw = make_uint4(h.x, h.y, 0, 0);
      }
    } else {
      c.kind = 2;
    }
  }

  __device__ __forceinline__ void values(float (&v)[kVec],
                                         const ChunkLoad& c, int j,
                                         int d0) const {
    const uint32_t w[4] = {c.raw.x, c.raw.y, c.raw.z, c.raw.w};
    if (c.kind == 3) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) v[e] = 0.f;
    } else if (c.kind == 2) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) v[e] = (*this)(j, d0 + e);
    } else if (c.kind == 1 || std::is_same<TC, bf16>::value) {
      // bf16 values: exact in the compute dtype
#pragma unroll
      for (int e = 0; e < kVec / 2; ++e) unpack_bf16x2(w[e], v + 2 * e);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        v[e] = round_to<bf16>(__uint_as_float(w[e]));
    }
  }
};

// The merged rows of a float32 or bf16 cache: nothing to stage (a fresh
// row is read from the new rows), the replaced rows written by
// write_rows.
template <typename TC>
struct FpDecodeRows {
  struct Cache {
    TC* k;
    TC* v;
    long long slot_stride;
  };
  using Load = ChunkLoad;
  static constexpr int kVec = FpSide<TC>::kVec;

  __host__ static size_t smem_words(int, int, const Cache&) { return 0; }

  TC* kc;
  TC* vc;
  FpSide<TC> k, v;

  __device__ __forceinline__ FpDecodeRows(const Cache& c,
                                          const DecodeSlot& s)
      : kc(c.k + (size_t)s.b * c.slot_stride + (size_t)s.kh * s.M * s.D),
        vc(c.v + (size_t)s.b * c.slot_stride + (size_t)s.kh * s.M * s.D),
        k{{kc, s.kn, s.stride_t, s.pos_b, s.first, s.count, s.T, s.D}},
        v{{vc, s.vn, s.stride_t, s.pos_b, s.first, s.count, s.T, s.D}} {}

  __device__ __forceinline__ void stage(int, int) const {}

  __device__ __forceinline__ void write(int s0, int s1) const {
    const int* count = k.count;
    write_rows(kc, vc, k, v, s1 - s0,
               [&](int r) { return count[s0 + r] > 0 ? s0 + r : -1; });
  }
};

// bf16 compute: the tensor-core prefill (T >= kPrefillMinT) or the
// cluster decode route (fewer rows) where the shapes allow; a call either
// refuses runs on the CUDA cores.
template <typename TC>
cudaError_t launch_bf16(const void* q, void* kc, void* vc,
                        long long slot_stride, const void* kn, const void* vn,
                        const int* pos, void* out, int B, int T, int H,
                        int KH, int M, int D, float scale, int device,
                        cudaStream_t stream, int* route, int* cluster) {
  const bool rows16 =
      aligned16(q) && aligned16(kc) && aligned16(vc) && aligned16(kn) &&
      aligned16(vn) && aligned16(out) &&
      (slot_stride * (long long)sizeof(TC)) % 16 == 0;
  const bool mma_dim = D == 64 || D == 128;
  if (rows16 && mma_dim && T < kPrefillMinT) {
    const cudaError_t err = routed_head_dim(D, [&](auto dd) {
      constexpr int kD = decltype(dd)::value;
      using Rows = FpDecodeRows<TC>;
      return launch_decode<Rows, kD>(
          q, typename Rows::Cache{static_cast<TC*>(kc), static_cast<TC*>(vc),
                                  slot_stride},
          kn, vn, pos, out, B, T, H, KH, M, scale, device, stream, cluster);
    });
    if (err != cudaErrorNotSupported) {
      *route = kRouteDecode;
      return err;
    }
    *cluster = 0;
  } else if (rows16 && mma_dim) {
    const bool fits = routed_head_dim(D, [&](auto dd) {
      constexpr int kD = decltype(dd)::value;
      return prefill_smem_bytes<kD>(M) <= kMaxSmem ? cudaSuccess
                                                   : cudaErrorNotSupported;
    }) == cudaSuccess;
    if (fits) {
      *route = kRoutePrefill;
      return routed_head_dim(D, [&](auto dd) {
        constexpr int kD = decltype(dd)::value;
        return launch_prefill<TC, kD>(q, kc, vc, slot_stride, kn, vn, pos,
                                      out, B, T, H, KH, M, scale, stream);
      });
    }
  }
  *route = kRouteCudaCores;
  return launch_cuda_cores<bf16, TC>(q, kc, vc, slot_stride, kn, vn, pos,
                                     out, B, T, H, KH, M, D, scale, stream);
}

}  // namespace

// q, out: [B, T, H, D] contiguous, dtype q_dtype (also the dtype of the
// new rows kn, vn: [B, T, KH, D] contiguous, and the compute dtype).
// kc, vc: one layer's view of the cache, element (b, kh, m, d) at
// b * slot_stride + (kh * M + m) * D + d, dtype c_dtype. pos: [B, T]
// int32. Launches on `stream` of CUDA device `device`, writes the route
// it took to *route (kRouteCudaCores, kRoutePrefill, kRouteDecode) and
// the CTAs of a decode cluster to *cluster (0 on the other routes), and
// returns cudaGetLastError() after the launch.
extern "C" int hvd_append_attend(const void* q, void* kc, void* vc,
                                 long long slot_stride, const void* kn,
                                 const void* vn, const void* pos, void* out,
                                 int B, int T, int H, int KH, int M, int D,
                                 float scale, int q_dtype, int c_dtype,
                                 int device, void* stream, int* route,
                                 int* cluster) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int* p = static_cast<const int*>(pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *route = kRouteCudaCores;
  *cluster = 0;
  if (q_dtype == kBF16 && c_dtype == kBF16)
    return launch_bf16<bf16>(q, kc, vc, slot_stride, kn, vn, p, out, B, T, H,
                             KH, M, D, scale, device, s, route, cluster);
  if (q_dtype == kBF16 && c_dtype == kF32)
    return launch_bf16<float>(q, kc, vc, slot_stride, kn, vn, p, out, B, T,
                              H, KH, M, D, scale, device, s, route, cluster);
  if (q_dtype == kF32 && c_dtype == kF32)
    return launch_cuda_cores<float, float>(q, kc, vc, slot_stride, kn, vn, p,
                                           out, B, T, H, KH, M, D, scale, s);
  if (q_dtype == kF32 && c_dtype == kBF16)
    return launch_cuda_cores<float, bf16>(q, kc, vc, slot_stride, kn, vn, p,
                                          out, B, T, H, KH, M, D, scale, s);
  return cudaErrorInvalidValue;
}
