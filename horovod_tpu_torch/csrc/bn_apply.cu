// BatchNorm apply: y = act(x * s + t [+ res]) over an [n, c]
// channels-last tensor, s and t per-channel float32 constants (s =
// gamma * rstd, t = beta - mean * s, folded by the caller), act ReLU or
// none, y in x's dtype.
//
// Replaces: horovod_tpu/ops/pallas_batchnorm.py `_apply_kernel` and
// `_apply_res_kernel` (run by `_run_apply`), the second pass of
// `fused_batch_norm`'s forward.
//
// Rounding: float32, in the plain version's order, each step rounded on
// its own (`__fmul_rn`, `__fadd_rn`: nvcc would otherwise contract
// x * s + t into one FMA, which eager PyTorch never does): x * s, then
// + t, then + res, then ReLU, then the cast. So the output is bitwise the
// plain version's, and the ReLU mask that bn_bwd_reduce.cu and
// bn_bwd_dx.cu recompute from x (and res) has exactly the forward's bits.
//
// What bounds it on an H100: bytes. It reads x (and res) and writes y
// once, two or three flops an element.
//
// Layout: a 2-D grid of row tiles x column tiles. A block's threads lie
// across a column tile of up to kThreads vectors of a row and over
// kThreads / tile row groups (bn::reduce_slot); block b takes the
// contiguous tile of groups * kRows rows from b * groups * kRows, so the
// grid sweeps memory in order. A thread loads its columns' s and t once
// and issues the 16-byte loads of its kRows rows of x (and res), groups
// rows apart, before it uses any of them; no per-vector remainder. One
// tile a block: the grid covers the rows (a grid-stride loop past
// 2^31 - 1 tiles). Stores keep the default cache policy. On an H100
// this order ran faster at ResNet-50's large shapes than B10's (rows
// strided over the blocks the card holds at once; PERF.md).
// ops/batchnorm.py `apply_geometry` and `apply_block_of_rows` state the
// layout.

#include "batchnorm.cuh"

namespace {

using bn::kRows;  // rows a thread has in flight

template <typename T, int VEC>
__global__ void __launch_bounds__(bn::kThreads)
    bn_apply_kernel(const T* __restrict__ x, const float* __restrict__ s,
                    const float* __restrict__ t, const T* __restrict__ res,
                    T* __restrict__ y, long long n, int c, int relu) {
  using R = bn::Raw<T, VEC>;
  const bn::ReduceSlot slot = bn::reduce_slot(c / VEC);
  if (!slot.active) return;  // no barrier below
  const int col = slot.vcol * VEC;
  float ks[VEC], kt[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    ks[i] = s[col + i];
    kt[i] = t[col + i];
  }

  const long long per_tile = static_cast<long long>(slot.groups) * kRows;
  for (long long tile = blockIdx.x; tile * per_tile < n;
       tile += gridDim.x) {
    const long long r0 = tile * per_tile + slot.group;
    R xr[kRows], rr[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const long long r = r0 + k * slot.groups;
      if (r >= n) continue;
      const size_t off = static_cast<size_t>(r) * c + col;
      xr[k] = *reinterpret_cast<const R*>(x + off);
      if (res != nullptr) rr[k] = *reinterpret_cast<const R*>(res + off);
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const long long r = r0 + k * slot.groups;
      if (r >= n) break;
      float xv[VEC], rv[VEC], out[VEC];
      bn::unpack<T, VEC>(xr[k], xv);
      if (res != nullptr) bn::unpack<T, VEC>(rr[k], rv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        float o = __fadd_rn(__fmul_rn(xv[i], ks[i]), kt[i]);
        if (res != nullptr) o = __fadd_rn(o, rv[i]);
        out[i] = relu ? bn::relu(o) : o;
      }
      bn::store_vec<T, VEC>(y + static_cast<size_t>(r) * c + col, out);
    }
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* x, const float* s, const float* t,
                   const void* res, void* y, long long n, int c, int relu,
                   cudaStream_t stream) {
  const int cv = c / VEC;
  const int tile = cv < bn::kThreads ? cv : bn::kThreads;
  const long long per_tile = static_cast<long long>(bn::kThreads / tile) *
                             kRows;
  const long long tiles = (n + per_tile - 1) / per_tile;
  const dim3 grid(static_cast<unsigned>(tiles < INT_MAX ? tiles : INT_MAX),
                  (cv + bn::kThreads - 1) / bn::kThreads);
  bn_apply_kernel<T, VEC><<<grid, bn::kThreads, 0, stream>>>(
      static_cast<const T*>(x), s, t, static_cast<const T*>(res),
      static_cast<T*>(y), n, c, relu);
  return cudaGetLastError();
}

}  // namespace

// x, res, y: [n, c] contiguous, dtype `dtype` (kF32 / kBF16), res null
// for none; s, t: [c] float32; vec: elements a thread moves at once (16
// bytes' worth, c a multiple of it and x, res, y 16-byte aligned, or 1).
// Launches one kernel on `stream` of CUDA device `device`; returns
// cudaGetLastError() after it.
extern "C" int hvd_bn_apply(const void* x, const void* s, const void* t,
                            const void* res, void* y, long long n, int c,
                            int vec, int relu, int dtype, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const float* sf = static_cast<const float*>(s);
  const float* tf = static_cast<const float*>(t);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16 && vec == 8)
    return launch<__nv_bfloat16, 8>(x, sf, tf, res, y, n, c, relu, st);
  if (dtype == kBF16 && vec == 1)
    return launch<__nv_bfloat16, 1>(x, sf, tf, res, y, n, c, relu, st);
  if (dtype == kF32 && vec == 4)
    return launch<float, 4>(x, sf, tf, res, y, n, c, relu, st);
  if (dtype == kF32 && vec == 1)
    return launch<float, 1>(x, sf, tf, res, y, n, c, relu, st);
  return cudaErrorInvalidValue;
}
