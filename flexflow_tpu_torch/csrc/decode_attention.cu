// Decode attention over the slot-dense KV cache, for Hopper (sm_90a).
//
// Replaces flexflow_tpu/kernels/pallas/decode.py `_call_decode` (both
// entries: fused_decode_attention, C = 1, and
// fused_multiquery_decode_attention, C >= 1). Per slot b and head h, query
// j sits at position pos[b] + j and attends cache rows
// k_pos < M && k_pos <= pos[b] + j:
//     s = q.k * scale (f32), masked s = -1e30, online softmax over cache
//     tiles with f32 m / l / acc, p rounded to q's dtype before p.v,
//     out = acc / (l == 0 ? 1 : l) in q's dtype.
//
// Bound on this card: bytes. Each (b, h) reads its cache rows once, about
// 2 * rows * d * sizeof(stored) bytes, against 2 * C * rows * d multiply-
// adds — at C = 1 a quarter of an operation per byte, far below the ~295
// operations per byte at which bf16 tensor cores become the limit.
//
// Design: one block of 128 threads per (query tile of <= 16 rows, head,
// slot), so a block stages its queries once and streams the cache through
// shared memory in tiles of `tile_k` rows (f32, rows padded to d + 1
// floats so neither the row-wise score loop nor the column-wise p.v loop
// has bank conflicts), copied in 16-byte chunks with several loads in
// flight per thread (`stage_rows`). The loop stops at the last row any query of the
// tile may attend (pos[b] + j0 + nq - 1) instead of masking the whole
// cache as the TPU kernel's fixed grid does, so a short sequence reads
// only its own rows. CUDA cores, no tensor cores, no TMA: a first kernel
// that is right; wgmma and TMA come later.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF, not -inf

// Stage `nt` cache rows of one head (row r of K at k + r * stride) into
// the shared f32 tiles k_s / v_s (row stride ld), rounded to q's dtype as
// the TPU kernel's `.astype(q.dtype)` does. With vec16 (rows made of
// whole, aligned 16-byte chunks) a thread moves 16 bytes of K and of V
// per step, unrolled so that several loads are in flight: with one block
// per SM, latency, not bandwidth, bounds the scalar copy.
template <typename QT, typename KT>
__device__ __forceinline__ void stage_rows(const KT* __restrict__ k,
                                           const KT* __restrict__ v,
                                           float* k_s, float* v_s, int nt,
                                           size_t stride, int D, int ld,
                                           bool vec16) {
  if (vec16) {
    constexpr int kVec = 16 / sizeof(KT);
    union Chunk {
      uint4 raw;
      KT e[kVec];
    };
    const int cpr = D / kVec;  // chunks per row
#pragma unroll 4
    for (int i = threadIdx.x; i < nt * cpr; i += kThreads) {
      const int t = i / cpr, c = i - t * cpr;
      const size_t off = t * stride + (size_t)c * kVec;
      Chunk kk, vv;
      kk.raw = *reinterpret_cast<const uint4*>(k + off);
      vv.raw = *reinterpret_cast<const uint4*>(v + off);
      float* kd = k_s + t * ld + c * kVec;
      float* vd = v_s + t * ld + c * kVec;
#pragma unroll
      for (int x = 0; x < kVec; ++x) {
        kd[x] = round_to<QT>(to_f(kk.e[x]));
        vd[x] = round_to<QT>(to_f(vv.e[x]));
      }
    }
    return;
  }
  for (int i = threadIdx.x; i < nt * D; i += kThreads) {
    const int t = i / D, dd = i - t * D;
    k_s[t * ld + dd] = round_to<QT>(to_f(k[t * stride + dd]));
    v_s[t * ld + dd] = round_to<QT>(to_f(v[t * stride + dd]));
  }
}

template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const QT* __restrict__ q,
                            const KT* __restrict__ kc,
                            const KT* __restrict__ vc,
                            const int* __restrict__ pos, QT* __restrict__ out,
                            int C, int M, int H, int D, float scale,
                            int tile_k, int q_tile, bool vec16) {
  extern __shared__ float smem[];
  const int b = blockIdx.z, h = blockIdx.y, j0 = blockIdx.x * q_tile;
  const int nq = min(q_tile, C - j0);
  const int ld = D + 1;
  float* q_s = smem;                   // q_tile x ld
  float* k_s = q_s + q_tile * ld;      // tile_k x ld
  float* v_s = k_s + tile_k * ld;      // tile_k x ld
  float* p_s = v_s + tile_k * ld;      // q_tile x tile_k scores, then p
  float* acc = p_s + q_tile * tile_k;  // q_tile x D
  float* m_s = acc + q_tile * D;       // running max
  float* l_s = m_s + q_tile;           // running sum
  float* c_s = l_s + q_tile;           // this tile's correction
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kWarps = kThreads / 32;
  const int p0 = pos[b];

  for (int i = tid; i < nq * D; i += kThreads) {
    const int jj = i / D, dd = i - jj * D;
    q_s[jj * ld + dd] = to_f(q[(((size_t)b * C + j0 + jj) * H + h) * D + dd]);
    acc[i] = 0.f;
  }
  for (int jj = tid; jj < nq; jj += kThreads) {
    m_s[jj] = kNegInf;
    l_s[jj] = 0.f;
  }
  __syncthreads();

  // rows [0, span) hold everything this tile's queries may attend
  const long long last = (long long)p0 + j0 + nq;
  const int span = (int)(last < M ? last : M);
  for (int t0 = 0; t0 < span; t0 += tile_k) {
    const int nt = min(tile_k, span - t0);
    const size_t row0 = (((size_t)b * M + t0) * H + h) * D;
    stage_rows<QT>(kc + row0, vc + row0, k_s, v_s, nt, (size_t)H * D, D, ld,
                   vec16);
    __syncthreads();

    for (int i = tid; i < nq * tile_k; i += kThreads) {
      const int jj = i / tile_k, t = i - jj * tile_k;
      float s = kNegInf;
      if (t < nt && t0 + t <= p0 + j0 + jj) {
        const float* qr = q_s + jj * ld;
        const float* kr = k_s + t * ld;
        float a = 0.f;
        for (int dd = 0; dd < D; ++dd) a = fmaf(qr[dd], kr[dd], a);
        s = a * scale;
      }
      p_s[i] = s;
    }
    __syncthreads();

    for (int jj = warp; jj < nq; jj += kWarps) {
      float* pr = p_s + jj * tile_k;
      float mx = kNegInf;
      for (int t = lane; t < tile_k; t += 32) mx = fmaxf(mx, pr[t]);
      mx = warp_max(mx);
      const float m_prev = m_s[jj];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < tile_k; t += 32) {
        const float p = expf(pr[t] - m_new);
        pr[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        m_s[jj] = m_new;
        l_s[jj] = l_s[jj] * corr + sum;
        c_s[jj] = corr;
      }
    }
    __syncthreads();

    for (int i = tid; i < nq * D; i += kThreads) {
      const int jj = i / D, dd = i - jj * D;
      const float* pr = p_s + jj * tile_k;
      float a = acc[i] * c_s[jj];
      for (int t = 0; t < nt; ++t)
        a = fmaf(round_to<QT>(pr[t]), v_s[t * ld + dd], a);
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < nq * D; i += kThreads) {
    const int jj = i / D, dd = i - jj * D;
    const float l = l_s[jj];
    out[(((size_t)b * C + j0 + jj) * H + h) * D + dd] =
        from_f<QT>(acc[i] / (l == 0.f ? 1.f : l));
  }
}

template <typename QT, typename KT>
int launch(const void* q, const void* k, const void* v, const int* pos,
           void* out, int B, int C, int M, int H, int D, float scale,
           int tile_k, cudaStream_t stream) {
  const int q_tile = C < 16 ? C : 16;
  const size_t smem =
      sizeof(float) * ((size_t)(q_tile + 2 * tile_k) * (D + 1) +
                       (size_t)q_tile * tile_k + (size_t)q_tile * D +
                       3 * (size_t)q_tile);
  auto kernel = decode_attention_kernel<QT, KT>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const bool vec16 = (D * sizeof(KT)) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const dim3 grid((C + q_tile - 1) / q_tile, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), pos, static_cast<QT*>(out), C, M, H, D,
      scale, tile_k, q_tile, vec16);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ff_decode_attention(const void* q, const void* k,
                                   const void* v, const int* pos, void* out,
                                   int B, int C, int M, int H, int D,
                                   float scale, int tile_k, int q_dtype,
                                   int kv_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == FF_F32 && kv_dtype == FF_F32)
    return launch<float, float>(q, k, v, pos, out, B, C, M, H, D, scale,
                                tile_k, s);
  if (q_dtype == FF_F32 && kv_dtype == FF_BF16)
    return launch<float, __nv_bfloat16>(q, k, v, pos, out, B, C, M, H, D,
                                        scale, tile_k, s);
  if (q_dtype == FF_BF16 && kv_dtype == FF_F32)
    return launch<__nv_bfloat16, float>(q, k, v, pos, out, B, C, M, H, D,
                                        scale, tile_k, s);
  if (q_dtype == FF_BF16 && kv_dtype == FF_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, pos, out, B, C, M,
                                                 H, D, scale, tile_k, s);
  return (int)cudaErrorInvalidValue;
}
