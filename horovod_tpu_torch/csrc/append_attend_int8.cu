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
// What bounds it on an H100: bytes, as append_attend.cu; a cache row is
// D one-byte codes and D / block float32 scales (68 bytes at D = 64 and
// one scale a row, against 128 in bf16).
//
// Routes (the C entry point picks one and reports it):
//
// * decode (bf16 compute, T < kPrefillMinT, head_dim 64 or 128, block a
//   multiple of kCodesPerLoad, 16-byte-aligned rows): decode_cluster.cuh's
//   cluster kernel, the one B16 runs, with the row policy `Int8DecodeRows`
//   below. A lane loads 16 codes of a row in one 16-byte load and their
//   one scale beside it (a block of 16 or more codes holds them), so a
//   warp has 16 rows in flight at head_dim 64, and dequantizes them as
//   the plain version does, round_bf16(code * scale). The new rows are
//   quantized once per call: before the row loops each CTA quantizes the
//   new rows that land in its span into shared memory, with the merge of
//   repeated positions, and reads those rows from there; the CTA that
//   owns a replaced row writes its codes and scales to the cache.
//   Softmax, P rounding and the rank-order sums are the shared kernel's.
//
// * CUDA cores (float32 compute, and every call the route above refuses,
//   for its shapes or its shared memory): `append_attend_int8_kernel`, one
//   block per (head, query row, batch row) over attend.cuh's
//   `attend_row`, each replaced row re-quantized from the new rows
//   wherever it is read.

#include "decode_cluster.cuh"

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

// ---- decode route: the int8 cache's row policy of decode_cluster.cuh ----

using bf16 = __nv_bfloat16;

// codes a lane loads at once (16 bytes); the route takes a block that is
// a multiple of it, so the lane's codes share one scale
constexpr int kCodesPerLoad = 16;

struct Int8Load {
  uint4 raw;    // 16 codes
  float scale;  // their block's scale
};

// One side (K or V) of the merged int8 rows of one (batch row, kv head).
struct Int8Side {
  const int8_t* codes;        // [M, D] in the cache
  const float* scales;        // [M, D / block] in the cache
  const int8_t* new_codes;    // [T, D] shared: merged codes at the first t
  const float* new_scales;    // [T, D / block] shared
  const int* first;
  const int* count;
  int D, nb, block;

  // 16 codes of merged row j at d0 and their scale: a kept row from the
  // cache, a replaced row from shared memory, nothing past j_end
  __device__ __forceinline__ void fetch(Int8Load& c, int j, int j_end,
                                        int d0) const {
    if (j >= j_end) {
      c.raw = make_uint4(0, 0, 0, 0);
      c.scale = 0.f;
      return;
    }
    const int blk = d0 / block;
    if (count[j] == 0) {
      c.raw = *reinterpret_cast<const uint4*>(codes + (size_t)j * D + d0);
      c.scale = scales[(size_t)j * nb + blk];
    } else {
      const int t = first[j];
      c.raw = *reinterpret_cast<const uint4*>(new_codes + t * D + d0);
      c.scale = new_scales[t * nb + blk];
    }
  }

  // round_bf16(code * scale), as Int8Rows and the plain version
  __device__ __forceinline__ void values(float (&v)[kCodesPerLoad],
                                         const Int8Load& c, int,
                                         int) const {
    const uint32_t w[4] = {c.raw.x, c.raw.y, c.raw.z, c.raw.w};
#pragma unroll
    for (int e = 0; e < kCodesPerLoad; ++e) {
      const int8_t code = static_cast<int8_t>(w[e / 4] >> (8 * (e % 4)));
      v[e] = round_to<bf16>(__fmul_rn(static_cast<float>(code), c.scale));
    }
  }
};

// The merged rows of an int8 cache. Shared memory: the scales [2][T][nb]
// (K then V) of the new rows that land in the CTA's span, then their
// codes [2][T][D] from the next 16-byte boundary; a new row's slot holds
// the merge of its position once stage() has run, at the first t of
// that position.
struct Int8DecodeRows {
  struct Cache {
    int8_t* kc;
    float* ks;
    int8_t* vc;
    float* vs;
    long long slot_stride;
    long long scale_slot_stride;
    int block;
  };
  using Load = Int8Load;
  static constexpr int kVec = kCodesPerLoad;

  __host__ static size_t smem_words(int T, int D, const Cache& c) {
    return align4(2 * (size_t)T * (D / c.block)) + 2 * (size_t)T * D / 4;
  }

  int8_t* kc;
  float* ks;
  int8_t* vc;
  float* vs;
  float* sc;     // shared scales
  int8_t* cd;    // shared codes
  const bf16* kn;
  const bf16* vn;
  int stride_t;
  const int* pos_b;
  int T, D, nb, block;
  Int8Side k, v;

  __device__ __forceinline__ Int8DecodeRows(const Cache& c,
                                            const DecodeSlot& s)
      : kc(c.kc + (size_t)s.b * c.slot_stride + (size_t)s.kh * s.M * s.D),
        ks(c.ks + (size_t)s.b * c.scale_slot_stride +
           (size_t)s.kh * s.M * (s.D / c.block)),
        vc(c.vc + (size_t)s.b * c.slot_stride + (size_t)s.kh * s.M * s.D),
        vs(c.vs + (size_t)s.b * c.scale_slot_stride +
           (size_t)s.kh * s.M * (s.D / c.block)),
        sc(static_cast<float*>(s.smem)),
        cd(reinterpret_cast<int8_t*>(
            static_cast<float*>(s.smem) + align4(2 * (size_t)s.T *
                                                 (s.D / c.block)))),
        kn(s.kn),
        vn(s.vn),
        stride_t(s.stride_t),
        pos_b(s.pos_b),
        T(s.T),
        D(s.D),
        nb(s.D / c.block),
        block(c.block),
        k{kc, ks, cd, sc, s.first, s.count, s.D, nb, c.block},
        v{vc, vs, cd + (size_t)s.T * s.D, sc + (size_t)s.T * nb, s.first,
          s.count, s.D, nb, c.block} {}

  // new row t lands in [s0, s1)
  __device__ __forceinline__ bool lands(int t, int s0, int s1) const {
    const int p = pos_b[t];
    return p >= s0 && p < s1;
  }

  // Quantize the new rows that land in [s0, s1) into shared memory with
  // Int8Rows::quantize's arithmetic, then merge each repeated position
  // into its first t's slot with Int8Rows::merged's rule. Every thread
  // calls it; it ends in a barrier.
  __device__ void stage(int s0, int s1) const {
    const int* first = k.first;
    const int* count = k.count;
    // the scale of each block: amax * (1/127), 1 for an all-zero block
    for (int i = threadIdx.x; i < 2 * T * nb; i += blockDim.x) {
      const int side = i / (T * nb), t = (i / nb) % T, blk = i % nb;
      if (!lands(t, s0, s1)) continue;
      const bf16* x =
          (side ? vn : kn) + (size_t)t * stride_t + (size_t)blk * block;
      float amax = 0.f;
      for (int e = 0; e < block; e += 8) {
        const uint4 w = *reinterpret_cast<const uint4*>(x + e);
        const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          amax = fmaxf(amax, fabsf(__uint_as_float(ws[h] << 16)));
          amax = fmaxf(amax, fabsf(__uint_as_float(ws[h] & 0xffff0000u)));
        }
      }
      sc[i] = amax > 0.f ? __fmul_rn(amax, kRecip127) : 1.f;
    }
    __syncthreads();
    // codes: clamp(rint(x / scale), -127, 127), an IEEE division
    for (int i = threadIdx.x; i < 2 * T * D; i += blockDim.x) {
      const int side = i / (T * D), t = (i / D) % T, d = i % D;
      if (!lands(t, s0, s1)) continue;
      const float x =
          __bfloat162float((side ? vn : kn)[(size_t)t * stride_t + d]);
      const float s = sc[(side * T + t) * nb + d / block];
      cd[i] = static_cast<int8_t>(
          fminf(fmaxf(rintf(__fdiv_rn(x, s)), -127.f), 127.f));
    }
    __syncthreads();
    // repeated positions: codes summed in float32 in t order, rounded and
    // saturated; scales summed; into the first t's slot (the later slots
    // are only read)
    for (int i = threadIdx.x; i < 2 * T * D; i += blockDim.x) {
      const int side = i / (T * D), t = (i / D) % T, d = i % D;
      if (!lands(t, s0, s1)) continue;
      const int p = pos_b[t];
      if (first[p] != t || count[p] < 2) continue;
      const int base = side * T;
      float qsum = 0.f + static_cast<float>(cd[i]);
      for (int t2 = t + 1; t2 < T; ++t2)
        if (pos_b[t2] == p)
          qsum += static_cast<float>(cd[(base + t2) * D + d]);
      cd[i] = static_cast<int8_t>(fminf(fmaxf(rintf(qsum), -128.f), 127.f));
      if (d % block == 0) {
        const int blk = d / block;
        float ssum = 0.f + sc[(base + t) * nb + blk];
        for (int t2 = t + 1; t2 < T; ++t2)
          if (pos_b[t2] == p) ssum += sc[(base + t2) * nb + blk];
        sc[(base + t) * nb + blk] = ssum;
      }
    }
    __syncthreads();
  }

  // The replaced rows of [s0, s1): codes in 16-byte stores, then scales.
  __device__ __forceinline__ void write(int s0, int s1) const {
    const int* first = k.first;
    const int chunks = D / kCodesPerLoad, per = chunks + nb;
    for (int i = threadIdx.x; i < 2 * T * per; i += blockDim.x) {
      const int side = i / (T * per), t = (i / per) % T, c = i % per;
      if (!lands(t, s0, s1)) continue;
      const int p = pos_b[t];
      if (first[p] != t) continue;
      const int slot = side * T + t;
      if (c < chunks) {
        int8_t* dst = (side ? vc : kc) + (size_t)p * D + c * kCodesPerLoad;
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(
            cd + (size_t)slot * D + c * kCodesPerLoad);
      } else {
        (side ? vs : ks)[(size_t)p * nb + (c - chunks)] =
            sc[slot * nb + (c - chunks)];
      }
    }
  }
};

// bf16 compute: the cluster decode route where the shapes allow it, else
// the CUDA cores.
cudaError_t launch_bf16(const void* q, void* kc, void* ks, void* vc,
                        void* vs, long long slot_stride,
                        long long scale_slot_stride, const void* kn,
                        const void* vn, const int* pos, void* out, int B,
                        int T, int H, int KH, int M, int D, int block,
                        float scale, int device, cudaStream_t stream,
                        int* route, int* cluster) {
  const bool rows16 = aligned16(q) && aligned16(kc) && aligned16(vc) &&
                      aligned16(kn) && aligned16(vn) && aligned16(out) &&
                      slot_stride % 16 == 0;
  if (rows16 && (D == 64 || D == 128) && block % kCodesPerLoad == 0 &&
      T < kPrefillMinT) {
    const Int8DecodeRows::Cache cache{
        static_cast<int8_t*>(kc), static_cast<float*>(ks),
        static_cast<int8_t*>(vc), static_cast<float*>(vs), slot_stride,
        scale_slot_stride, block};
    const cudaError_t err = routed_head_dim(D, [&](auto dd) {
      constexpr int kD = decltype(dd)::value;
      return launch_decode<Int8DecodeRows, kD>(q, cache, kn, vn, pos, out, B,
                                               T, H, KH, M, scale, device,
                                               stream, cluster);
    });
    if (err != cudaErrorNotSupported) {
      *route = kRouteDecode;
      return err;
    }
    *cluster = 0;
  }
  *route = kRouteCudaCores;
  return launch<bf16>(q, kc, ks, vc, vs, slot_stride, scale_slot_stride, kn,
                      vn, pos, out, B, T, H, KH, M, D, block, scale, stream);
}

}  // namespace

// As hvd_append_attend, for an int8 cache: kc, vc are int8 codes at
// b * slot_stride + (kh * M + m) * D + d; ks, vs float32 scales at
// b * scale_slot_stride + (kh * M + m) * (D / block) + d / block. Writes
// the route it took to *route (kRouteCudaCores, kRouteDecode) and the
// CTAs of a decode cluster to *cluster (0 on the CUDA cores).
extern "C" int hvd_append_attend_int8(
    const void* q, void* kc, void* ks, void* vc, void* vs,
    long long slot_stride, long long scale_slot_stride, const void* kn,
    const void* vn, const void* pos, void* out, int B, int T, int H, int KH,
    int M, int D, int block, float scale, int q_dtype, int device,
    void* stream, int* route, int* cluster) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int* p = static_cast<const int*>(pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *route = kRouteCudaCores;
  *cluster = 0;
  if (q_dtype == kBF16)
    return launch_bf16(q, kc, ks, vc, vs, slot_stride, scale_slot_stride, kn,
                       vn, p, out, B, T, H, KH, M, D, block, scale, device, s,
                       route, cluster);
  if (q_dtype == kF32)
    return launch<float>(q, kc, ks, vc, vs, slot_stride, scale_slot_stride,
                         kn, vn, p, out, B, T, H, KH, M, D, block, scale, s);
  return cudaErrorInvalidValue;
}
