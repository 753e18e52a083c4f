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
//     the merged rows j <= positions[b, t], masked logits -1e30.
//
// What bounds it on an H100: bytes. A decode step reads each valid K
// and V row once (B * KH * (pos + 1) * D elements each) and does 4 flops
// per element read per query head sharing it, far below the card's
// ~295 flops/byte for bf16 tensor cores.
//
// Design: one block per (head, query row, batch row). The block builds
// the batch row's cover table (which new row replaces which cache row)
// in shared memory and reads replaced rows straight from the new rows,
// so no block waits for another's write and the write needs no second
// kernel. The first head of each kv group writes the replaced rows.
// Attention keeps the plain version's rounding points: logits are
// rounded to the compute dtype, softmax runs in float32 over logits
// held in shared memory, probabilities are rounded to the compute
// dtype before the PV sum. Rows above the query's position have
// probability exactly 0 and are not read.

#include "attend.cuh"

namespace {

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
cudaError_t launch(const void* q, void* kc, void* vc, long long slot_stride,
                   const void* kn, const void* vn, const int* pos, void* out,
                   int B, int T, int H, int KH, int M, int D, float scale,
                   cudaStream_t stream) {
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

}  // namespace

// q, out: [B, T, H, D] contiguous, dtype q_dtype (also the dtype of the
// new rows kn, vn: [B, T, KH, D] contiguous, and the compute dtype).
// kc, vc: one layer's view of the cache, element (b, kh, m, d) at
// b * slot_stride + (kh * M + m) * D + d, dtype c_dtype. pos: [B, T]
// int32. Launches on `stream` of CUDA device `device`; returns
// cudaGetLastError() after the launch.
extern "C" int hvd_append_attend(const void* q, void* kc, void* vc,
                                 long long slot_stride, const void* kn,
                                 const void* vn, const void* pos, void* out,
                                 int B, int T, int H, int KH, int M, int D,
                                 float scale, int q_dtype, int c_dtype,
                                 int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int* p = static_cast<const int*>(pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (q_dtype == kBF16 && c_dtype == kBF16)
    return launch<bf16, bf16>(q, kc, vc, slot_stride, kn, vn, p, out, B, T,
                              H, KH, M, D, scale, s);
  if (q_dtype == kBF16 && c_dtype == kF32)
    return launch<bf16, float>(q, kc, vc, slot_stride, kn, vn, p, out, B,
                               T, H, KH, M, D, scale, s);
  if (q_dtype == kF32 && c_dtype == kF32)
    return launch<float, float>(q, kc, vc, slot_stride, kn, vn, p, out, B,
                                T, H, KH, M, D, scale, s);
  if (q_dtype == kF32 && c_dtype == kBF16)
    return launch<float, bf16>(q, kc, vc, slot_stride, kn, vn, p, out, B,
                               T, H, KH, M, D, scale, s);
  return cudaErrorInvalidValue;
}
