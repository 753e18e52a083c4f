// Decode append + attend over an int8 block-quantized slotted KV cache.
//
// Replaces: horovod_tpu/ops/pallas_collectives.py
// `_append_attend_int8_kernel` (launched by `decode_append_attend`):
// quantize-on-write of the new K/V rows, merge of codes and scales,
// dequantize and attention, in one kernel.
//
// Function (plain version: serving/decode.py `SlottedKVCache.update`
// on an int8 cache + models/transformer.py `cached_attention`):
//   * quantize each new row in blocks of `block` along head_dim, the
//     block math of optim/compression.py:
//       scale = amax * (1/127)  (1 for an all-zero block)
//       code  = clamp(rint(x / scale), -127, 127)
//     with an IEEE division and round-half-to-even, so codes and scales
//     are bitwise equal to the plain version's (and the JAX package's);
//   * merge like append_attend.cu, on codes (summed in float32,
//     rounded, cast to int8 with saturation) and on scales;
//   * dequantize code * scale in float32, cast to the compute dtype,
//     and attend exactly as append_attend.cu does.
//
// What bounds it on an H100: bytes, as append_attend.cu; the cache is a
// quarter of the float32 bytes plus one float32 scale per block.
//
// Design: append_attend.cu's, with the replaced rows re-quantized from
// the new rows wherever they are read (a few rows per call at decode).

#include "attend.cuh"

namespace {

constexpr float kRecip127 = static_cast<float>(1.0 / 127.0);

// Merged rows of one (batch row, kv head) of an int8 cache.
template <typename TQ>
struct Int8Rows {
  const int8_t* codes;  // [M, D]
  const float* scales;  // [M, D / block]
  const TQ* fresh;      // new row t at fresh + t * stride_t, [D]
  int stride_t;
  const int* pos_b;
  const int* first;
  const int* count;
  int T, D, block;

  // code and scale of element d of new row t
  __device__ __forceinline__ void quantize(int t, int d, float* code,
                                           float* scale) const {
    const TQ* row = fresh + (size_t)t * stride_t;
    const int j0 = (d / block) * block;
    float amax = 0.f;
    for (int j = j0; j < j0 + block; ++j)
      amax = fmaxf(amax, fabsf(to_f32(row[j])));
    const float s = amax > 0.f ? __fmul_rn(amax, kRecip127) : 1.f;
    const float c = rintf(__fdiv_rn(to_f32(row[d]), s));
    *code = fminf(fmaxf(c, -127.f), 127.f);
    *scale = s;
  }

  __device__ __forceinline__ void merged(int m, int d, int8_t* code,
                                         float* scale) const {
    const int c = count[m];
    if (c == 0) {
      *code = codes[(size_t)m * D + d];
      *scale = scales[(size_t)m * (D / block) + d / block];
      return;
    }
    const int t0 = first[m];
    float qv, sv;
    quantize(t0, d, &qv, &sv);
    float qsum = 0.f + qv, ssum = 0.f + sv;
    if (c > 1) {
      for (int t = t0 + 1; t < T; ++t) {
        if (pos_b[t] != m) continue;
        quantize(t, d, &qv, &sv);
        qsum += qv;
        ssum += sv;
      }
    }
    // float -> int8 saturates, as XLA's conversion does
    *code = static_cast<int8_t>(fminf(fmaxf(rintf(qsum), -128.f), 127.f));
    *scale = ssum;
  }

  __device__ __forceinline__ float operator()(int m, int d) const {
    int8_t q;
    float s;
    merged(m, d, &q, &s);
    return round_to<TQ>(__fmul_rn(static_cast<float>(q), s));
  }
};

template <typename TQ, int kLanes>
__global__ void __launch_bounds__(kMaxThreads)
    append_attend_int8_kernel(const TQ* __restrict__ q, int8_t* kc,
                              float* ks, int8_t* vc, float* vs,
                              long long slot_stride,
                              long long scale_slot_stride,
                              const TQ* __restrict__ kn,
                              const TQ* __restrict__ vn,
                              const int* __restrict__ pos,
                              TQ* __restrict__ out, int T, int H, int KH,
                              int M, int D, int block, float scale) {
  extern __shared__ float smem[];
  int* first = reinterpret_cast<int*>(smem);
  int* count = first + M;
  const int h = blockIdx.x, t = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int nb = D / block;
  const int* pos_b = pos + (size_t)b * T;
  build_cover(pos_b, T, M, first, count);

  const size_t slice = (size_t)b * slot_stride + (size_t)kh * M * D;
  const size_t sslice =
      (size_t)b * scale_slot_stride + (size_t)kh * M * nb;
  const size_t fresh = (size_t)b * T * KH * D + (size_t)kh * D;
  const Int8Rows<TQ> krows{kc + slice, ks + sslice, kn + fresh, KH * D,
                           pos_b, first, count, T, D, block};
  const Int8Rows<TQ> vrows{vc + slice, vs + sslice, vn + fresh, KH * D,
                           pos_b, first, count, T, D, block};
  const int p_t = pos_b[t];

  if (h % (H / KH) == 0 && p_t >= 0 && p_t < M && first[p_t] == t) {
    for (int d = threadIdx.x; d < D; d += blockDim.x) {
      int8_t code;
      float s;
      krows.merged(p_t, d, &code, &s);
      kc[slice + (size_t)p_t * D + d] = code;
      if (d % block == 0) ks[sslice + (size_t)p_t * nb + d / block] = s;
      vrows.merged(p_t, d, &code, &s);
      vc[slice + (size_t)p_t * D + d] = code;
      if (d % block == 0) vs[sslice + (size_t)p_t * nb + d / block] = s;
    }
  }

  const size_t row = ((size_t)b * T + t) * H + h;
  attend_row<kLanes, TQ>(q + row * D, D, M, p_t, scale, krows, vrows, smem,
                 out + row * D);
}

template <typename TQ, int kLanes>
cudaError_t launch_lanes(const void* q, void* kc, void* ks, void* vc,
                         void* vs, long long slot_stride,
                         long long scale_slot_stride, const void* kn,
                         const void* vn, const int* pos, void* out, int B,
                         int T, int H, int KH, int M, int D, int block,
                         float scale, cudaStream_t stream) {
  const int threads = attend_threads(B, T, H);
  const size_t smem = attend_smem_floats(M, D, threads) * sizeof(float);
  cudaError_t err = set_smem(append_attend_int8_kernel<TQ, kLanes>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, T, B);
  append_attend_int8_kernel<TQ, kLanes><<<grid, threads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<int8_t*>(kc),
      static_cast<float*>(ks), static_cast<int8_t*>(vc),
      static_cast<float*>(vs), slot_stride, scale_slot_stride,
      static_cast<const TQ*>(kn), static_cast<const TQ*>(vn), pos,
      static_cast<TQ*>(out), T, H, KH, M, D, block, scale);
  return cudaGetLastError();
}

template <typename TQ>
cudaError_t launch(const void* q, void* kc, void* ks, void* vc, void* vs,
                   long long slot_stride, long long scale_slot_stride,
                   const void* kn, const void* vn, const int* pos, void* out,
                   int B, int T, int H, int KH, int M, int D, int block,
                   float scale, cudaStream_t stream) {
  if (D <= 64)
    return launch_lanes<TQ, 2>(q, kc, ks, vc, vs, slot_stride,
                               scale_slot_stride, kn, vn, pos, out, B, T, H,
                               KH, M, D, block, scale, stream);
  if (D <= 128)
    return launch_lanes<TQ, 4>(q, kc, ks, vc, vs, slot_stride,
                               scale_slot_stride, kn, vn, pos, out, B, T, H,
                               KH, M, D, block, scale, stream);
  if (D <= kMaxHeadDim)
    return launch_lanes<TQ, 8>(q, kc, ks, vc, vs, slot_stride,
                               scale_slot_stride, kn, vn, pos, out, B, T, H,
                               KH, M, D, block, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// As hvd_append_attend, for an int8 cache: kc, vc are int8 codes at
// b * slot_stride + (kh * M + m) * D + d; ks, vs float32 scales at
// b * scale_slot_stride + (kh * M + m) * (D / block) + d / block.
extern "C" int hvd_append_attend_int8(
    const void* q, void* kc, void* ks, void* vc, void* vs,
    long long slot_stride, long long scale_slot_stride, const void* kn,
    const void* vn, const void* pos, void* out, int B, int T, int H, int KH,
    int M, int D, int block, float scale, int q_dtype, int device,
    void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int* p = static_cast<const int*>(pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == kBF16)
    return launch<__nv_bfloat16>(q, kc, ks, vc, vs, slot_stride,
                                 scale_slot_stride, kn, vn, p, out, B, T, H,
                                 KH, M, D, block, scale, s);
  if (q_dtype == kF32)
    return launch<float>(q, kc, ks, vc, vs, slot_stride, scale_slot_stride,
                         kn, vn, p, out, B, T, H, KH, M, D, block, scale, s);
  return cudaErrorInvalidValue;
}
