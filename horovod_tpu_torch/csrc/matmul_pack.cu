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
// What bounds it on an H100: operations (2 M N K; at BERT-Large's
// MLP-out weight gradient, 4096 x 4096 @ 4096 x 1024, 34 GFLOP, 0.0347
// ms at the bf16 tensor-core peak; at the MLM head's, @ 4096 x 30522,
// 0.259 ms).
//
// bf16 (the training dtype): `matmul_pack_wgmma_kernel`, on Hopper's
// warpgroup tensor-core products. A block computes a kTileM x kTileN
// output tile: two consumer warpgroups of 64 rows each issue
// `wgmma.mma_async.m64n128k16` (bf16 in, float32 sums) with both
// operands in shared memory, and one producer warpgroup keeps a ring of
// kStages stages of kTileK-deep A and B tiles in flight, separated from
// the consumers by full and empty mbarriers. A ([M, K], K-major) and B
// ([K, N] row-major: N-major, which wgmma takes through its transpose
// immediate, so no transposed copy of b is made) lie in 128-byte
// swizzled tiles. An operand whose rows are 16-byte aligned arrives by
// TMA (one thread, `cp.async.bulk.tensor`, zero fill past every edge);
// any other (the MLM head's N = 30522, K or N odd) is copied by the
// producer's 128 threads with the widest `cp.async` its alignment
// allows (8 or 4 bytes, zero fill past the edges), or 2-byte loads and
// stores, into the same swizzled layout (the XOR computed here), and
// signals the same barrier. The epilogue stores straight from the
// accumulator registers at i * N + j (float2 where N is even), masked
// at the edges, with 64-bit offsets (M * N reaches 3e7).
//
// float32: `matmul_pack_kernel`, on the CUDA cores (TF32 would not meet
// float32's tolerance): 64 x 64 output tiles, 256 threads each holding
// a 4 x 4 block of sums, K streamed through shared memory 16 deep, each
// product a fused multiply-add.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through
                   // the runtime (cudaGetDriverEntryPoint), so no -lcuda

#include <type_traits>

#include "common.cuh"

namespace {

// ---- float32 on the CUDA cores --------------------------------------------

constexpr int kBM = 64, kBN = 64, kBK = 16, kThreads = 256;
constexpr int kPad = 4;  // keeps float4 rows aligned, halves bank conflicts

__global__ void __launch_bounds__(kThreads)
    matmul_pack_kernel(const float* __restrict__ a,
                       const float* __restrict__ b, float* __restrict__ out,
                       int M, int N, int K, long long total) {
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
      As[a_p + q][a_i] = (gi < M && gp < K) ? a[gi * K + gp] : 0.f;
    }
    const int gp = p0 + b_p;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long long gj = col0 + b_j + q;
      Bs[b_p][b_j + q] =
          (gp < K && gj < N) ? b[static_cast<long long>(gp) * N + gj] : 0.f;
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

cudaError_t launch_f32(const void* a, const void* b, float* out, int M,
                       int N, int K, long long total, cudaStream_t stream) {
  const long long gy = (M + kBM - 1) / kBM;
  if (gy > 65535) return cudaErrorInvalidValue;
  const dim3 grid((N + kBN - 1) / kBN, static_cast<unsigned>(gy));
  matmul_pack_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), out, M, N,
      K, total);
  return cudaGetLastError();
}

// ---- bf16 on the tensor cores: wgmma fed by TMA ---------------------------

using bf16 = __nv_bfloat16;

constexpr int kTileM = 128;   // output rows a block: two warpgroups of 64
constexpr int kTileN = 128;   // output columns a block: one m64n128 each
constexpr int kTileK = 64;    // K depth of a stage: 128-byte rows of A
constexpr int kStages = 4;    // depth of the ring
constexpr int kConsumers = 2;                       // warpgroups
constexpr int kWgThreads = (kConsumers + 1) * 128;  // + the producer
constexpr int kABytes = kTileM * kTileK * 2;             // 16 KB
constexpr int kBHalf = kTileK * 64 * 2;  // 8 KB: kTileK rows of 64 columns
constexpr int kStageBytes = kABytes + 2 * kBHalf;        // 32 KB
constexpr int kWgmmaSmem = kStages * kStageBytes + 2 * kStages * 8 + 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of element (r, c) in a tile of 128-byte rows (64 bf16)
// under the 128-byte swizzle: 16-byte chunk c / 8 of row r lands at
// chunk (c / 8) ^ (r % 8), as TMA writes it and wgmma reads it.
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return r * 128 + ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the phase of parity `parity` to complete. A phase that never
// completes (a lost arrival) traps after ~2^35 cycles instead of
// holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = -1;
  while (!mbar_try_wait(bar, parity)) {
    const long long now = clock64();
    if (t0 < 0) t0 = now;
    else if (now - t0 > (1ll << 35)) __trap();
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// ---- operands TMA cannot read ----------------------------------------------
//
// A tensor map needs rows 16 bytes apart. Any other operand (the MLM
// head's N = 30522, odd K or N) is copied by the producer's 128 threads
// straight into the swizzled tile (the XOR computed here): `cp.async` of
// W bytes, the widest of 8 and 4 that the rows' alignment allows (zero
// past the edges through src-size), whose completion arrives on the
// stage's full barrier (`cp.async.mbarrier.arrive.noinc`); rows of odd
// length take 2-byte loads and stores. This route runs at a fifth of
// the TMA route's rate (PERF.md): one SM's load/store unit, not its
// tensor cores, is the limit.

// One arrival on `bar` once this thread's cp.asyncs so far have landed.
__device__ __forceinline__ void mbar_arrive_cp_async(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(bar)
               : "memory");
}

// W bytes global -> shared (W = 8 or 4 by cp.async, zero when !live;
// W = 2 by a load and a store).
template <int W>
__device__ __forceinline__ void copy_chunk(unsigned char* tile, uint32_t off,
                                           const bf16* src, bool live) {
  if constexpr (W == 2) {
    *reinterpret_cast<uint16_t*>(tile + off) =
        live ? *reinterpret_cast<const uint16_t*>(src) : 0;
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_u32(tile + off)),
                 "l"(src), "n"(W), "r"(live ? W : 0)
                 : "memory");
  }
}

// A tile [kTileM rows i][kTileK columns p] of a [M, K], W bytes a copy.
template <int W>
__device__ __forceinline__ void copy_a(unsigned char* tile, const bf16* a,
                                       int m0, int k0, int M, int K,
                                       int tid) {
  constexpr int E = W / 2, kPerRow = kTileK / E;
  for (int i = tid; i < kTileM * kPerRow; i += 128) {
    const int r = i / kPerRow, c = i % kPerRow * E;
    const bool live = m0 + r < M && k0 + c < K;
    const bf16* src =
        live ? a + static_cast<size_t>(m0 + r) * K + k0 + c : a;
    copy_chunk<W>(tile, sw128(r, c), src, live);
  }
}

// B tile [kTileK rows p][kTileN columns j] of b [K, N], as two halves
// of 64 columns, W bytes a copy.
template <int W>
__device__ __forceinline__ void copy_b(unsigned char* tile, const bf16* b,
                                       int k0, int n0, int K, int N,
                                       int tid) {
  constexpr int E = W / 2, kPerRow = kTileN / E;
  for (int i = tid; i < kTileK * kPerRow; i += 128) {
    const int r = i / kPerRow, c = i % kPerRow * E;
    const bool live = k0 + r < K && n0 + c < N;
    const bf16* src =
        live ? b + static_cast<size_t>(k0 + r) * N + n0 + c : b;
    copy_chunk<W>(tile, (c >> 6) * kBHalf + sw128(r, c & 63), src, live);
  }
}

template <typename F>
__device__ __forceinline__ void with_width(int w, F&& body) {
  if (w == 8) body(std::integral_constant<int, 8>{});
  else if (w == 4) body(std::integral_constant<int, 4>{});
  else body(std::integral_constant<int, 2>{});
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3fff) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3fff) << 32 |
         static_cast<uint64_t>(1) << 62;
}

// d += A . B over k16: A (64 x 16) K-major, B (16 x 128) N-major (the
// transpose immediate set), float32 sums.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

// Keep the compiler from moving accesses of the accumulators across the
// asynchronous products.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// wa, wb: 0 when the operand arrives by TMA (map_a, map_b), else the
// bytes of one copy of the producer's threads (8, 4 or 2).
__global__ void __launch_bounds__(kWgThreads, 1)
    matmul_pack_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                             const __grid_constant__ CUtensorMap map_b,
                             const bf16* __restrict__ a,
                             const bf16* __restrict__ b,
                             float* __restrict__ out, int M, int N, int K,
                             long long total, int wa, int wb) {
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte aligned tiles: the swizzle repeats every 8 rows of 128 bytes
  unsigned char* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  const uint32_t full0 = smem_u32(smem + kStages * kStageBytes);
  const uint32_t empty0 = full0 + kStages * 8;
  const int tid = threadIdx.x;
  const bool copies = wa || wb;  // the producer's 128 threads copy
  const int tma_bytes = (wa ? 0 : kABytes) + (wb ? 0 : 2 * kBHalf);
  const int m0 = blockIdx.x * kTileM, n0 = blockIdx.y * kTileN;
  const int n_k = (K + kTileK - 1) / kTileK;

  if (blockIdx.x == 0 && blockIdx.y == 0) {
    // the padding past M * N: a few elements, zeroed by the first block
    const long long mn = static_cast<long long>(M) * N;
    for (long long e = mn + tid; e < total; e += kWgThreads) out[e] = 0.f;
  }
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, (tma_bytes ? 1 : 0) + (copies ? 128 : 0));
      mbar_init(empty0 + 8 * s, kConsumers * 4);  // a lane of each warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // the producer warpgroup: thread 0 issues the TMA loads; all 128
    // copy an operand that TMA cannot read. It runs up to kStages
    // stages ahead of the consumers.
    if (!copies && tid != 0) return;
    for (int kt = 0; kt < n_k; ++kt) {
      const int s = kt % kStages;
      if (kt >= kStages) mbar_wait(empty0 + 8 * s, (kt / kStages - 1) & 1);
      unsigned char* ta = smem + s * kStageBytes;
      unsigned char* tb = ta + kABytes;
      const uint32_t full = full0 + 8 * s;
      const int k0 = kt * kTileK;
      if (tid == 0 && tma_bytes) {
        mbar_arrive_tx(full, tma_bytes);
        if (!wa) tma_load_2d(smem_u32(ta), &map_a, full, k0, m0);
        if (!wb) {
          tma_load_2d(smem_u32(tb), &map_b, full, n0, k0);
          tma_load_2d(smem_u32(tb + kBHalf), &map_b, full, n0 + 64, k0);
        }
      }
      if (!copies) continue;
      if (wa) with_width(wa, [&](auto w) {
        copy_a<decltype(w)::value>(ta, a, m0, k0, M, K, tid);
      });
      if (wb) with_width(wb, [&](auto w) {
        copy_b<decltype(w)::value>(tb, b, k0, n0, K, N, tid);
      });
      if (wa == 2 || wb == 2) {
        // the plain stores (and any cp.async) land before the arrival,
        // and reach wgmma's proxy
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(full);
      } else {
        mbar_arrive_cp_async(full);
      }
    }
    return;
  }

  // a consumer warpgroup: 64 output rows
  const int wg = tid / 128 - 1, warp = (tid / 32) % 4, lane = tid % 32;
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  for (int kt = 0; kt < n_k; ++kt) {
    const int s = kt % kStages;
    mbar_wait(full0 + 8 * s, (kt / kStages) & 1);
    // copies written through the generic proxy, read by wgmma's
    if (copies) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const uint32_t ta = smem_u32(smem + s * kStageBytes) + wg * 64 * 128;
    const uint32_t tb = smem_u32(smem + s * kStageBytes + kABytes);
    fence_acc(d);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kTileK / 16; ++kk)
      // A: +32 bytes a k16 step inside the swizzled rows, 8-row groups
      // 1024 bytes apart; B: +16 rows a k16 step, 8-row groups 1024
      // bytes apart, the two 64-column halves kBHalf apart
      wgmma_m64n128k16(d, gmma_desc(ta + kk * 32, 16, 1024),
                       gmma_desc(tb + kk * 16 * 128, kBHalf, 1024));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // the products of stage kt - 1 are done: release it
    wgmma_wait<1>();
    fence_acc(d);
    if (kt > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((kt - 1) % kStages));
  }
  wgmma_wait<0>();
  fence_acc(d);

  // d[4j + 2h + e]: row 16 warp + g + 8h, column 8j + 2t + e
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long i = m0 + wg * 64 + warp * 16 + g + 8 * h;
    if (i >= M) continue;
    float* orow = out + i * N;
#pragma unroll
    for (int jt = 0; jt < kTileN / 8; ++jt) {
      const int j = n0 + 8 * jt + 2 * t4;
      const float x = d[4 * jt + 2 * h], y = d[4 * jt + 2 * h + 1];
      if (N % 2 == 0) {
        if (j < N) *reinterpret_cast<float2*>(orow + j) = make_float2(x, y);
      } else {
        if (j < N) orow[j] = x;
        if (j + 1 < N) orow[j + 1] = y;
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The TMA map of a row-major bf16 [outer, inner] matrix, read in boxes
// of [box_outer, box_inner] under the 128-byte swizzle; zero fill past
// the edges.
bool tma_map(CUtensorMap* map, const void* base, long long inner,
             long long outer, int box_inner, int box_outer) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// 0 when TMA can read a bf16 matrix with rows of `row` elements from
// `base` (16-byte aligned rows), else the widest copy its rows'
// alignment allows: 8, 4 or 2 bytes.
int copy_width(const void* base, long long row) {
  const uintptr_t x =
      reinterpret_cast<uintptr_t>(base) | static_cast<uintptr_t>(row * 2);
  return x % 16 == 0 ? 0 : x % 8 == 0 ? 8 : x % 4 == 0 ? 4 : 2;
}

cudaError_t launch_bf16(const void* a, const void* b, float* out, int M,
                        int N, int K, long long total, cudaStream_t stream) {
  const long long gy = (N + kTileN - 1) / kTileN;
  if (gy > 65535) return cudaErrorInvalidValue;
  CUtensorMap map_a{}, map_b{};
  const int wa = K > 0 ? copy_width(a, K) : 2;
  const int wb = K > 0 ? copy_width(b, N) : 2;
  if (!wa && !tma_map(&map_a, a, K, M, kTileK, kTileM))
    return cudaErrorInvalidValue;
  if (!wb && !tma_map(&map_b, b, N, K, 64, kTileK))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      matmul_pack_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kWgmmaSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + kTileM - 1) / kTileM, static_cast<unsigned>(gy));
  matmul_pack_wgmma_kernel<<<grid, kWgThreads, kWgmmaSmem, stream>>>(
      map_a, map_b, static_cast<const bf16*>(a), static_cast<const bf16*>(b),
      out, M, N, K, total, wa, wb);
  return cudaGetLastError();
}

}  // namespace

// a: [M, K] and b: [K, N], contiguous row-major, both float32 (dtype
// kF32, on the CUDA cores) or both bf16 (kBF16, on the tensor cores);
// out: `total` (= n * k >= M * N) float32. Launches one kernel on
// `stream` of CUDA device `device`; returns cudaGetLastError() after it.
extern "C" int hvd_matmul_pack(const void* a, const void* b, void* out,
                               int M, int N, int K, long long total,
                               int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (M <= 0 || N <= 0 || K < 0 ||
      total < static_cast<long long>(M) * N)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (dtype == kF32) return launch_f32(a, b, o, M, N, K, total, s);
  if (dtype == kBF16) return launch_bf16(a, b, o, M, N, K, total, s);
  return cudaErrorInvalidValue;
}
