// Shared device code of the LayerNorm / RMSNorm kernels: the forward
// (layernorm_fwd.cu, B4) and the backward (layernorm_bwd.cu, B5).
//
// Both hold a row a warp, each lane its chunks of columns, and both take
// the row's statistics from `warp_row_stats` below: the same sums in the
// same order and the same fold. So the backward's recomputed mean and
// rstd are the forward's, bit for bit. `fold` is the one place that
// turns a row's sums into mean and rstd; the forward's long rows (C >
// 4096, a block per row) sum in another order and fold here too.
#pragma once

#include "common.cuh"

namespace ln {

// One lane's chunk of V columns: 16-byte loads (kWide) or one element.
// Lane `lane` of a warp holds columns (k * 32 + lane) * V .. + V of its
// row in chunk k.
template <typename T, bool kWide>
struct Cols;

template <typename T>
struct Cols<T, true> {
  static constexpr int V = 16 / sizeof(T);
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const T* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&v)[V]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
    if constexpr (sizeof(T) == 2) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[2 * i] = __uint_as_float(w[i] << 16);
        v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = __uint_as_float(w[i]);
    }
  }
  static __device__ __forceinline__ void store(T* p, const float (&v)[V]) {
    uint32_t w[4];
    if constexpr (sizeof(T) == 2) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
        w[i] = *reinterpret_cast<const uint32_t*>(&h);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = __float_as_uint(v[i]);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <typename T>
struct Cols<T, false> {
  static constexpr int V = 1;
  using Raw = T;
  static __device__ __forceinline__ Raw load(const T* p) { return *p; }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&v)[1]) {
    v[0] = to_f32(r);
  }
  static __device__ __forceinline__ void store(T* p, const float (&v)[1]) {
    *p = from_f32<T>(v[0]);
  }
};

// mean and rstd of a row of c columns from its sum and sum of squares
// (the TPU kernel's formula, not Welford): mean = s / c, var =
// max(ss / c - mean^2, 0), rstd = 1 / sqrt(var + eps); RMSNorm: mean = 0,
// var = ss / c. Correctly rounded steps, nothing contracted.
__device__ __forceinline__ void fold(float s, float ss, int c, float eps,
                                     int rms, float& mean, float& rstd) {
  const float cf = static_cast<float>(c);
  float var;
  if (rms) {
    mean = 0.f;
    var = __fdiv_rn(ss, cf);
  } else {
    mean = __fdiv_rn(s, cf);
    var = fmaxf(__fsub_rn(__fdiv_rn(ss, cf), __fmul_rn(mean, mean)), 0.f);
  }
  rstd = __frcp_rn(__fsqrt_rn(__fadd_rn(var, eps)));
}

// A warp's row statistics from the row's chunks in its lanes' registers
// (`cx[k]`, the layout of `Cols`): each lane adds its columns in chunk
// order, then `warp_sum` adds the lanes; every lane gets mean and rstd.
template <typename T, bool kWide, int kChunks>
__device__ __forceinline__ void warp_row_stats(
    const typename Cols<T, kWide>::Raw (&cx)[kChunks], int lane, int c,
    float eps, int rms, float& mean, float& rstd) {
  using L = Cols<T, kWide>;
  constexpr int V = L::V;
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    if ((k * 32 + lane) * V >= c) continue;
    float xv[V];
    L::unpack(cx[k], xv);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      s += xv[e];
      ss = fmaf(xv[e], xv[e], ss);
    }
  }
  fold(warp_sum(s), warp_sum(ss), c, eps, rms, mean, rstd);
}

}  // namespace ln
