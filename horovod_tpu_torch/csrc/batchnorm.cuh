// Shared pieces of the four BatchNorm kernels (bn_stats.cu, bn_apply.cu,
// bn_bwd_reduce.cu, bn_bwd_dx.cu), which work on the [n, c] view of a
// channels-last activation: c channels contiguous, n = N*H*W rows.
//
// Every kernel moves VEC elements per thread: 16 bytes (8 bf16 or 4
// float32) when c is a multiple of that and the tensors are 16-byte
// aligned, else 1 (the wrapper in ops/batchnorm.py picks VEC).
//
// The reductions (B7, B9) are one launch each, on a 2-D grid of row
// blocks x column tiles (ops/batchnorm.py `reduce_geometry` sizes it and
// `reduce_block_of_rows` states it; tests/test_torch_kernels.py holds it
// to the constexprs below):
// - a block's threads lie across a tile of up to kTileVecs vectors of a
//   row and over kThreads / tile row groups (reduce_slot<kTileVecs>);
//   group g of row block b sums rows b * groups + g, then every
//   row_blocks * groups rows on, issuing the 16-byte loads of kRows rows
//   before it uses any (sum_rows);
// - the groups' sums are added in group order through shared memory
//   into the block's row of two float32 [row_blocks, c] partial arrays
//   (write_partials); the wrapper picks few enough row blocks that the
//   partials are a few percent of x's bytes;
// - each block then fences and takes a ticket of its column tile; the
//   last block of the tile to arrive sums the tile's columns of every
//   partial row (finish_tile): its threads split the partial rows into
//   fixed contiguous chunks, sum their chunk in row order with 16-byte
//   loads, and the chunks are added in chunk order through shared
//   memory. That block writes the kernel's outputs and resets the
//   ticket for the next launch on the stream.
// The order of every addition is set by (n, c, row_blocks), never by
// which block arrives last: no float atomics, the same bits on every
// run. (The TPU kernels add into one output block across their in-order
// grid; the ticket takes the place of that order here.)
#pragma once

#include <type_traits>

#include "common.cuh"

namespace bn {

constexpr int kThreads = 256;
constexpr int kTileVecs = 64;     // vectors a reduction block spans in a row
constexpr int kRows = 4;          // rows a thread has in flight
constexpr int kBlocksPerSm = 2;   // reduction blocks an SM holds at once

// The elements of one vector of T at p, as float32.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         float (&out)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = to_f32<T>(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = to_f32<T>(p[i]);
  }
}

// Round VEC float32 values to T and store them at p.
template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* __restrict__ p,
                                          const float (&v)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) e[i] = from_f32<T>(v[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = from_f32<T>(v[i]);
  }
}

// The raw bits of one vector: a uint4 when it is 16 bytes, else one T.
// A thread loads several rows' Raw before it unpacks any.
template <typename T, int VEC>
using Raw = std::conditional_t<VEC * sizeof(T) == 16, uint4, T>;

template <typename T, int VEC>
__device__ __forceinline__ void unpack(const Raw<T, VEC>& raw,
                                       float (&out)[VEC]) {
  static_assert(VEC == 1 || VEC * sizeof(T) == 16, "vector width");
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC; ++i) out[i] = to_f32<T>(e[i]);
}

// ReLU as torch.relu computes it: NaN stays NaN, -0 becomes +0.
__device__ __forceinline__ float relu(float v) {
  return v != v ? v : (v > 0.f ? v : 0.f);
}

// Where a thread of a 2-D (row blocks x column tiles) block sits: column
// vector `vcol` of the row group `group` (0 .. groups-1) in a tile of
// `tile` vectors; `active` if that column exists. A tile spans up to
// kMaxTile vectors (B10: kThreads; the reductions: kTileVecs).
struct ReduceSlot {
  int vcol, group, groups, tile;
  bool active;
};

template <int kMaxTile = kThreads>
__device__ __forceinline__ ReduceSlot reduce_slot(int cv) {
  ReduceSlot s;
  s.tile = min(cv, kMaxTile);
  s.groups = kThreads / s.tile;
  s.group = threadIdx.x / s.tile;
  s.vcol = blockIdx.y * kMaxTile + threadIdx.x % s.tile;
  s.active = s.group < s.groups && s.vcol < cv;
  return s;
}

// Floats of a reduction kernel's static shared memory: two arrays of a
// value per thread and element (write_partials), or of a 16-byte vector
// per thread (finish_tile).
template <int VEC>
__host__ __device__ constexpr int reduce_smem_floats() {
  return 2 * kThreads * (VEC > 4 ? VEC : 4);
}

// Add this thread's rows of its column vector into a and b: rows
// blockIdx.x * groups + group, then every gridDim.x * groups rows on, in
// increasing order, kRows loads in flight. `rows` loads one row's raw
// vectors (`load(raw, offset)`) and adds them (`add(raw, a, b)`).
template <int VEC, typename Rows>
__device__ __forceinline__ void sum_rows(const Rows& rows,
                                         const ReduceSlot& s, long long n,
                                         int c, float (&a)[VEC],
                                         float (&b)[VEC]) {
  using R = typename Rows::Loaded;
  const long long stride = static_cast<long long>(gridDim.x) * s.groups;
  const size_t col = static_cast<size_t>(s.vcol) * VEC;
  for (long long r0 =
           static_cast<long long>(blockIdx.x) * s.groups + s.group;
       r0 < n; r0 += kRows * stride) {
    R raw[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const long long r = r0 + k * stride;
      if (r < n) rows.load(raw[k], static_cast<size_t>(r) * c + col);
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      if (r0 + k * stride >= n) break;
      rows.add(raw[k], a, b);
    }
  }
}

// Add the block's threads' a and b over its row groups, in group order,
// and write them to row blockIdx.x of part_a and part_b ([gridDim.x, c]
// float32). Every thread calls it.
template <int VEC>
__device__ __forceinline__ void write_partials(const ReduceSlot& s,
                                               const float (&a)[VEC],
                                               const float (&b)[VEC],
                                               float* smem, float* part_a,
                                               float* part_b, int c) {
  float* ra = smem;
  float* rb = smem + kThreads * VEC;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    ra[threadIdx.x * VEC + i] = a[i];
    rb[threadIdx.x * VEC + i] = b[i];
  }
  __syncthreads();
  if (s.group != 0 || !s.active) return;
  float va[VEC], vb[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) va[i] = vb[i] = 0.f;
  for (int g = 0; g < s.groups; ++g) {
    const int at = (g * s.tile + threadIdx.x) * VEC;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      va[i] += ra[at + i];
      vb[i] += rb[at + i];
    }
  }
  const size_t o = static_cast<size_t>(blockIdx.x) * c +
                   static_cast<size_t>(s.vcol) * VEC;
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      *reinterpret_cast<float4*>(part_a + o + i) =
          make_float4(va[i], va[i + 1], va[i + 2], va[i + 3]);
      *reinterpret_cast<float4*>(part_b + o + i) =
          make_float4(vb[i], vb[i + 1], vb[i + 2], vb[i + 3]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      part_a[o + i] = va[i];
      part_b[o + i] = vb[i];
    }
  }
}

// After write_partials: true in the last block of its column tile to
// arrive (ticket[blockIdx.y] counts them), whose reads of the other
// blocks' partials then see their writes. Every thread calls it.
__device__ __forceinline__ bool last_block(unsigned int* ticket) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(ticket + blockIdx.y, 1u) == gridDim.x - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

template <int FV>
__device__ __forceinline__ void load_part(const float* p, float (&v)[FV]) {
  if constexpr (FV == 4) {
    const float4 q = __ldcg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    v[0] = __ldcg(p);
  }
}

// In the last block of column tile blockIdx.y: the sums over all
// gridDim.x partial rows of the tile's w columns from col0, left in
// smem[0 .. w) (part_a's) and smem[kThreads * FV ..) (part_b's). The
// threads lie over nv = w / FV column vectors of FV floats and kThreads
// / nv chunks of contiguous partial rows; each sums its chunk in row
// order, then the chunks are added in chunk order. Every thread of the
// block calls it.
template <int FV>
__device__ __forceinline__ void finish_tile(const float* part_a,
                                            const float* part_b, int c,
                                            int col0, int w, float* smem) {
  const int nv = w / FV;
  const int chunks = kThreads / nv;  // nv <= kTileVecs * 8 / 4 = 128
  const int rows = gridDim.x;
  const int per = (rows + chunks - 1) / chunks;
  const int j = threadIdx.x % nv, k = threadIdx.x / nv;
  float va[FV], vb[FV];
#pragma unroll
  for (int e = 0; e < FV; ++e) va[e] = vb[e] = 0.f;
  if (k < chunks) {
    const int r1 = min(rows, (k + 1) * per);
    const size_t col = static_cast<size_t>(col0) + j * FV;
#pragma unroll 4
    for (int r = k * per; r < r1; ++r) {
      float pa[FV], pb[FV];
      load_part<FV>(part_a + static_cast<size_t>(r) * c + col, pa);
      load_part<FV>(part_b + static_cast<size_t>(r) * c + col, pb);
#pragma unroll
      for (int e = 0; e < FV; ++e) {
        va[e] += pa[e];
        vb[e] += pb[e];
      }
    }
  }
  float* ca = smem;                   // [chunks, w]
  float* cb = smem + kThreads * FV;   // [chunks, w]
  __syncthreads();  // write_partials' use of smem is over
  if (k < chunks) {
#pragma unroll
    for (int e = 0; e < FV; ++e) {
      ca[k * w + j * FV + e] = va[e];
      cb[k * w + j * FV + e] = vb[e];
    }
  }
  __syncthreads();
  if (k == 0) {
    for (int kk = 1; kk < chunks; ++kk) {
#pragma unroll
      for (int e = 0; e < FV; ++e) {
        va[e] += ca[kk * w + j * FV + e];
        vb[e] += cb[kk * w + j * FV + e];
      }
    }
#pragma unroll
    for (int e = 0; e < FV; ++e) {
      ca[j * FV + e] = va[e];
      cb[j * FV + e] = vb[e];
    }
  }
  __syncthreads();
}

// The whole reduction of one launch: sum_rows, write_partials and, in
// the last block of each column tile, finish_tile, then `epilogue(col,
// a, b)` for each of the tile's columns with their two sums, then the
// ticket's reset. `smem` holds reduce_smem_floats<VEC>() floats.
template <int VEC, typename Rows, typename Epilogue>
__device__ __forceinline__ void reduce(const Rows& rows, long long n, int c,
                                       float* part, unsigned int* ticket,
                                       float* smem, Epilogue epilogue) {
  const ReduceSlot slot = reduce_slot<kTileVecs>(c / VEC);
  float a[VEC], b[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) a[i] = b[i] = 0.f;
  if (slot.active) sum_rows<VEC>(rows, slot, n, c, a, b);
  float* part_a = part;
  float* part_b = part + static_cast<size_t>(gridDim.x) * c;
  write_partials<VEC>(slot, a, b, smem, part_a, part_b, c);
  if (!last_block(ticket)) return;
  const int col0 = blockIdx.y * kTileVecs * VEC;
  const int w = min(kTileVecs * VEC, c - col0);
  // 16-byte loads of the partial rows need whole float4s in every row
  if (c % 4 == 0) {
    finish_tile<4>(part_a, part_b, c, col0, w, smem);
    for (int i = threadIdx.x; i < w; i += kThreads)
      epilogue(col0 + i, smem[i], smem[kThreads * 4 + i]);
  } else {
    finish_tile<1>(part_a, part_b, c, col0, w, smem);
    for (int i = threadIdx.x; i < w; i += kThreads)
      epilogue(col0 + i, smem[i], smem[kThreads + i]);
  }
  if (threadIdx.x == 0) ticket[blockIdx.y] = 0;  // for the next launch
}

// Column tiles of a reduction over c channels moved VEC at a time.
inline int reduce_col_tiles(int c, int vec) {
  return (c / vec + kTileVecs - 1) / kTileVecs;
}

}  // namespace bn
