// Tensor-core building blocks of the bf16 flash-attention kernels
// (flash_fwd.cu B1, flash_bwd_dq.cu B2, flash_bwd_dkv.cu B3).
//
// Products are `mma.sync.m16n8k16` on bf16 operands with float32
// accumulation: exactly the TPU kernels' rounding points (bf16 inputs to
// each product, float32 sums), only the order of the sums differs.
//
// A block is kWarps warps; each warp owns kWarpRows resident rows (the
// A operand of its products: queries in B1 and B2, keys in B3), so a
// block holds kBlockRows rows. The streamed operand arrives in bf16 tiles of
// shared memory through 16-byte `cp.async` copies into a two-stage ring
// (tile t+1 loads while tile t computes); rows past the end are
// zero-filled by the copy's src-size operand. Each shared row is padded
// by kPad bf16 (16 bytes): at a row stride of 2D + 16 bytes the eight
// rows one `ldmatrix` reads start in eight different 4-bank groups for
// every head_dim in 16..128, so no read conflicts (an unpadded 128-byte
// stride at D = 64 puts all eight rows in the same banks).
//
// Fragment layouts (PTX ISA, mma.m16n8k16 .bf16): lane = 4 g + t;
//   A (16 x 16, row-major): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g,
//     2t+8..), a3 (g+8, 2t+8..);
//   B (16 x 8, k x n): b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g);
//   C (16 x 8): c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1).
// Two n8 C tiles of one row band are one k16 A operand (c0 c1 of the
// first tile -> a0, c2 c3 -> a1, the second tile's -> a2, a3): P and dS
// go from one product into the next without leaving registers.
#pragma once

#include "flash.cuh"

namespace flash_mma {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kWarpRows = 16;                   // an m16 A operand
constexpr int kBlockRows = kWarps * kWarpRows;  // resident rows a block
constexpr int kPad = 8;                         // bf16 past D a shared row

template <int D>
struct Geometry {
  static_assert(D % 16 == 0 && D >= 16 && D <= 128, "head_dim");
  static constexpr int kStride = D + kPad;  // bf16 a shared row
  static constexpr int kSteps = D / 16;     // k16 steps over D
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; 16 zero bytes when !live
// (src-size 0 reads nothing, but `src` must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared (one float32 of lse or delta), zero when !live.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(live ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices from shared memory; lanes 8i..8i+7 give the
// row addresses of matrix i, register i receives matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The same, each matrix transposed.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a . b on the tensor cores: m16n8k16, bf16 in, float32 sums.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two float32 values rounded to bf16 (nearest even, like a cast), the
// first in the low half: the order of a fragment's column pair.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A bf16 pair scaled in float32 and rounded back: (q.f32 * scale).bf16.
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t x, float scale) {
  const float lo = __uint_as_float(x << 16);
  const float hi = __uint_as_float(x & 0xffff0000u);
  return pack_bf16(__fmul_rn(lo, scale), __fmul_rn(hi, scale));
}

// C fragments n8 tiles 2kk and 2kk + 1 as the k16 A fragment kk, each
// value rounded to bf16.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Shared address of this lane's row for an A fragment (rows r0..r0+15,
// columns c0..c0+15 of a tile stored row-major), or, read with
// ldsm_x4_t, for the B fragments of two n8 tiles of an operand stored
// k-major (k rows r0..r0+15, n columns c0..c0+15).
template <int D>
__device__ __forceinline__ uint32_t a_addr(const bf16* tile, int r0, int c0,
                                           int lane) {
  return smem_u32(tile + (r0 + (lane & 15)) * Geometry<D>::kStride + c0 +
                  (lane >> 4) * 8);
}

// Shared address of this lane's row for the B fragments of two n8 tiles
// (n rows r0..r0+15) of one k16 step (columns c0..c0+15) of an operand
// stored n-major (K in Q.K^T): registers 0, 1 are the first tile's b0,
// b1 and registers 2, 3 the second's.
template <int D>
__device__ __forceinline__ uint32_t b_addr(const bf16* tile, int r0, int c0,
                                           int lane) {
  return smem_u32(tile + (r0 + ((lane >> 4) << 3) + (lane & 7)) *
                             Geometry<D>::kStride +
                  c0 + ((lane >> 3) & 1) * 8);
}

// Rows [row0, row0 + R) of a [n_rows, D] bf16 matrix into a padded
// shared tile, 16 bytes a copy; rows past n_rows are zero. Every thread
// of the block calls it; the caller commits the group.
template <int D, int R>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          int row0, int n_rows) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < R * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool live = row0 + r < n_rows;
    const bf16* s =
        src + static_cast<size_t>(live ? row0 + r : 0) * D + c * 8;
    cp_async16(dst + r * Geometry<D>::kStride + c * 8, s, live);
  }
}

// Values [i0, i0 + n) of a float32 row into shared memory, zero past
// `len`.
__device__ __forceinline__ void load_floats(float* dst, const float* src,
                                            int i0, int n, int len) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const bool live = i0 + i < len;
    cp_async4(dst + i, src + (live ? i0 + i : 0), live);
  }
}

}  // namespace flash_mma
