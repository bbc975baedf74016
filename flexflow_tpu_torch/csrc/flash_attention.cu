// Flash attention, forward and backward, for Hopper (sm_90a), on q, k, v
// in any layout whose head dim is contiguous: each tensor comes with its
// own batch, row and head strides (in elements), and so do lse and delta.
//
// The C entries ff_flash_fwd and ff_flash_bwd choose the route by dtype:
// bf16 (the training path's dtype, under mixed precision) goes to the
// tensor-core kernels of csrc/flash_attention_tc.cu (`wgmma`, TMA); f32
// stays on the CUDA-core kernels below, because a tensor-core product in
// f32 is TF32 (about three decimal digits), which would miss the f32
// tolerances the card's checks hold (1e-5 + 1e-4 relative).
//
// One kernel serves both TPU kernel families of
// flexflow_tpu/kernels/flash_attention.py:
//  - packed (b, l, heads * d), lse (b, lq, heads): `_flash_fwd_packed`
//    (`_fwd_kernel_packed`) and `_flash_bwd_packed`
//    (`_bwd_dq_kernel_packed`, `_bwd_dkv_kernel_packed`);
//  - head-separated blhd (b, l, h, d) and bhld (b, h, l, d), lse
//    (b, h, lq): `_flash_fwd` (`_fwd_kernel`) and `_flash_bwd`
//    (`_bwd_dq_kernel`, `_bwd_dkv_kernel`), the TP-sharded attention's
//    path.
// Per batch row b and head h, with query i at
// position i and key j at position j (q_offset = Lk - Lq):
//   forward:  s = q_i.k_j * scale (f32); masked s = -1e30 (causal: keep
//             j <= i + q_offset); online softmax over key tiles with f32
//             m / l / acc; p rounded to v's dtype before p.v;
//             o = acc / (l == 0 ? 1 : l) in q's dtype,
//             lse = m + log(l == 0 ? 1 : l) in f32.
//   backward: p = exp(s - lse), masked p = 0, dp = dO_i.v_j (f32),
//             ds = p * (dp - delta_i) with delta = sum_d dO * O (computed
//             by the caller), ds and p rounded to the stored dtype before
//             each product; dq = scale * sum_j ds k_j,
//             dk = scale * sum_i ds q_i, dv = sum_i p dO_i.
//
// Bound on this card, at the training shapes (b 8, l 512, 16 heads of
// 64): the forward does 4 * b * h * l^2 * d flops on 4 * b * l * h * d
// stored elements — 512 flops per bf16 byte; in f32 on CUDA cores (67
// TFLOP/s) operations bound it; the backward (which recomputes s) does
// 10 * b * h * l^2 * d.
//
// Design of the f32 kernels: one block of 256 threads per (query tile,
// head, batch row) for the forward and dq, one per (key tile, head, batch
// row) for dk / dv. Tiles are at most 64 rows and live in shared memory
// as f32 (rows padded to an odd stride: no bank conflicts); each thread
// owns a 4 x 4 block of the 64 x 64 score tile (rows ty + 16 r, columns
// tx + 16 c), so the rows of a query sit in one half-warp and the online
// softmax reduces with four shuffles, with m and l in registers beside
// the thread's rows of the accumulator. The key loop stops at the last
// key a causal tile can attend; dk / dv start at the first query tile
// that attends them. The strides cost nothing at the inner loops: a
// tile's rows are staged once through load_tile, whatever the layout
// (bhld's rows of one head are contiguous, blhd's and packed rows are
// heads * d apart).
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kTile = 64;      // largest query / key tile
constexpr int kSld = kTile + 1;
constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF, not -inf

// element strides of one tensor's batch, head and row (position) axes;
// the head dim itself has stride 1. A row offset takes 32 bits (the
// wrapper checks rows * l < 2^31): with 64-bit row strides the backward
// kernels lost 10-20% on the card, as ptxas unrolled less around them.
struct Layout {
  long long b, h;
  int l;
  __device__ __forceinline__ size_t at(int bi, int hi, int row) const {
    return (size_t)(bi * b + hi * h) + (size_t)(row * l);
  }
};
struct FwdLayouts {
  Layout q, k, v, o, lse;
};
struct BwdLayouts {
  Layout q, k, v, dout, lse, delta, dq, dk, dv;
};

// Stage `nrows` rows of one head (row r at src + r * stride) into dst as
// f32 with row stride ld; rows up to kTile and columns up to ld - 1 past
// the data are zero.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          size_t stride, int nrows, int D,
                                          float* dst, int ld) {
  const int width = ld - 1;
  for (int i = threadIdx.x; i < kTile * width; i += kThreads) {
    const int r = i / width, c = i - r * width;
    dst[r * ld + c] =
        (r < nrows && c < D) ? to_f(src[(size_t)r * stride + c]) : 0.f;
  }
}

// reduce over the 16 lanes of a half-warp (the lanes that share a row)
__device__ __forceinline__ float half_max(float v) {
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float half_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int NC>
constexpr size_t fwd_smem_floats() {
  return 3 * (size_t)kTile * (16 * NC + 1) + (size_t)kTile * kSld;
}
template <int NC>
constexpr size_t dq_smem_floats() {
  return 4 * (size_t)kTile * (16 * NC + 1) + (size_t)kTile * kSld;
}
template <int NC>
constexpr size_t dkv_smem_floats() {
  return 4 * (size_t)kTile * (16 * NC + 1) + 2 * (size_t)kTile * kSld +
         2 * (size_t)kTile;
}

// NC: 16-column groups of the head dim (D <= 16 * NC)
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, FwdLayouts L, int Lq, int Lk,
                     int D, float scale, int causal, int bq, int bk) {
  extern __shared__ float smem[];
  constexpr int ld = 16 * NC + 1;
  float* q_s = smem;
  float* k_s = q_s + kTile * ld;
  float* v_s = k_s + kTile * ld;
  float* p_s = v_s + kTile * ld;  // kTile x kSld
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * bq;
  const int nq = min(bq, Lq - q0);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q_offset = Lk - Lq;

  load_tile(q + L.q.at(b, h, q0), L.q.l, nq, D, q_s, ld);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) acc[r][cc] = 0.f;
  }

  // keys past the last one a row of this tile may attend are skipped; a
  // row that attends no key at all (causal with Lq > Lk) gets the mean of
  // every v, as the TPU kernel's masked softmax gives it, so a tile that
  // holds one reads every key
  const bool row_sees_none = causal && q0 + q_offset < 0;
  const int k_end =
      causal && !row_sees_none ? min(Lk, q0 + nq + q_offset) : Lk;
  for (int k0 = 0; k0 < k_end; k0 += bk) {
    const int nk = min(bk, Lk - k0);
    __syncthreads();  // the previous tile's readers are done
    load_tile(k + L.k.at(b, h, k0), L.k.l, nk, D, k_s, ld);
    load_tile(v + L.v.at(b, h, k0), L.v.l, nk, D, v_s, ld);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
    for (int dd = 0; dd < D; ++dd) {
      float qa[4], kb[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qa[r] = q_s[(ty + 16 * r) * ld + dd];
#pragma unroll
      for (int c = 0; c < 4; ++c) kb[c] = k_s[(tx + 16 * c) * ld + dd];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qa[r], kb[c], s[r][c]);
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qi = q0 + ty + 16 * r;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = k0 + tx + 16 * c;
        float val = s[r][c] * scale;
        if (tx + 16 * c >= nk || (causal && kj > qi + q_offset))
          val = kNegInf;
        s[r][c] = val;
        mx = fmaxf(mx, val);
      }
      mx = half_max(mx);
      const float m_new = fmaxf(m[r], mx);
      const float corr = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        // columns past the tile's keys are not keys at all: p = 0
        const float p = tx + 16 * c < nk ? expf(s[r][c] - m_new) : 0.f;
        sum += p;
        p_s[(ty + 16 * r) * kSld + tx + 16 * c] = round_to<T>(p);
      }
      sum = half_sum(sum);
      l[r] = l[r] * corr + sum;
      m[r] = m_new;
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) acc[r][cc] *= corr;
    }
    __syncthreads();

    for (int j = 0; j < nk; ++j) {
      float pa[4], vb[NC];
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[r] = p_s[(ty + 16 * r) * kSld + j];
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) vb[cc] = v_s[j * ld + tx + 16 * cc];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < NC; ++cc)
          acc[r][cc] = fmaf(pa[r], vb[cc], acc[r][cc]);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ty + 16 * r;
    if (i >= nq) continue;
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int dd = tx + 16 * cc;
      if (dd < D) o[L.o.at(b, h, q0 + i) + dd] = from_f<T>(acc[r][cc] / l_safe);
    }
    if (tx == 0) lse[L.lse.at(b, h, q0 + i)] = m[r] + logf(l_safe);
  }
}

// dq: one block per (query tile, head, batch row), streaming key tiles
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        BwdLayouts L, int Lq, int Lk, int D, float scale,
                        int causal, int bq, int bk) {
  extern __shared__ float smem[];
  constexpr int ld = 16 * NC + 1;
  float* q_s = smem;
  float* do_s = q_s + kTile * ld;
  float* k_s = do_s + kTile * ld;
  float* v_s = k_s + kTile * ld;
  float* ds_s = v_s + kTile * ld;  // kTile x kSld
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * bq;
  const int nq = min(bq, Lq - q0);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q_offset = Lk - Lq;

  load_tile(q + L.q.at(b, h, q0), L.q.l, nq, D, q_s, ld);
  load_tile(dout + L.dout.at(b, h, q0), L.dout.l, nq, D, do_s, ld);
  float lse_r[4], delta_r[4], acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ty + 16 * r;
    lse_r[r] = i < nq ? lse[L.lse.at(b, h, q0 + i)] : 0.f;
    delta_r[r] = i < nq ? delta[L.delta.at(b, h, q0 + i)] : 0.f;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) acc[r][cc] = 0.f;
  }

  const int k_end = causal ? min(Lk, q0 + nq + q_offset) : Lk;
  for (int k0 = 0; k0 < k_end; k0 += bk) {
    const int nk = min(bk, Lk - k0);
    __syncthreads();
    load_tile(k + L.k.at(b, h, k0), L.k.l, nk, D, k_s, ld);
    load_tile(v + L.v.at(b, h, k0), L.v.l, nk, D, v_s, ld);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
    for (int dd = 0; dd < D; ++dd) {
      float qa[4], da[4], kb[4], vb[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        qa[r] = q_s[(ty + 16 * r) * ld + dd];
        da[r] = do_s[(ty + 16 * r) * ld + dd];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        kb[c] = k_s[(tx + 16 * c) * ld + dd];
        vb[c] = v_s[(tx + 16 * c) * ld + dd];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[r][c] = fmaf(qa[r], kb[c], s[r][c]);
          dp[r][c] = fmaf(da[r], vb[c], dp[r][c]);
        }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qi = q0 + ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = tx + 16 * c;
        const bool keep = j < nk && !(causal && k0 + j > qi + q_offset);
        const float p = keep ? expf(s[r][c] * scale - lse_r[r]) : 0.f;
        ds_s[(ty + 16 * r) * kSld + j] =
            round_to<T>(p * (dp[r][c] - delta_r[r]));
      }
    }
    __syncthreads();

    // unrolled by 4: left to itself nvcc unrolls the backward's
    // product loops less here, about 10% slower on the card
#pragma unroll 4
    for (int j = 0; j < nk; ++j) {
      float da[4], kb[NC];
#pragma unroll
      for (int r = 0; r < 4; ++r) da[r] = ds_s[(ty + 16 * r) * kSld + j];
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) kb[cc] = k_s[j * ld + tx + 16 * cc];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < NC; ++cc)
          acc[r][cc] = fmaf(da[r], kb[cc], acc[r][cc]);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ty + 16 * r;
    if (i >= nq) continue;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int dd = tx + 16 * cc;
      if (dd < D) dq[L.dq.at(b, h, q0 + i) + dd] = from_f<T>(acc[r][cc] * scale);
    }
  }
}

// dk, dv: one block per (key tile, head, batch row), streaming query tiles;
// the thread owns key rows ty + 16 r and query columns tx + 16 c of the
// transposed score tile
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, BwdLayouts L, int Lq, int Lk,
                         int D, float scale, int causal, int bq, int bk) {
  extern __shared__ float smem[];
  constexpr int ld = 16 * NC + 1;
  float* k_s = smem;
  float* v_s = k_s + kTile * ld;
  float* q_s = v_s + kTile * ld;
  float* do_s = q_s + kTile * ld;
  float* p_s = do_s + kTile * ld;   // kTile x kSld, [key][query]
  float* ds_s = p_s + kTile * kSld;  // kTile x kSld, [key][query]
  float* lse_s = ds_s + kTile * kSld;
  float* delta_s = lse_s + kTile;
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * bk;
  const int nk = min(bk, Lk - k0);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q_offset = Lk - Lq;

  load_tile(k + L.k.at(b, h, k0), L.k.l, nk, D, k_s, ld);
  load_tile(v + L.v.at(b, h, k0), L.v.l, nk, D, v_s, ld);
  float dk_acc[4][NC], dv_acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) dk_acc[r][cc] = dv_acc[r][cc] = 0.f;

  // queries before the first one that attends key k0 are skipped
  int q_begin = 0;
  if (causal) q_begin = max(0, k0 - q_offset) / bq * bq;
  for (int q0 = q_begin; q0 < Lq; q0 += bq) {
    const int nq = min(bq, Lq - q0);
    __syncthreads();
    load_tile(q + L.q.at(b, h, q0), L.q.l, nq, D, q_s, ld);
    load_tile(dout + L.dout.at(b, h, q0), L.dout.l, nq, D, do_s, ld);
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      lse_s[i] = i < nq ? lse[L.lse.at(b, h, q0 + i)] : 0.f;
      delta_s[i] = i < nq ? delta[L.delta.at(b, h, q0 + i)] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
    for (int dd = 0; dd < D; ++dd) {
      float ka[4], va[4], qb[4], db[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        ka[r] = k_s[(ty + 16 * r) * ld + dd];
        va[r] = v_s[(ty + 16 * r) * ld + dd];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        qb[c] = q_s[(tx + 16 * c) * ld + dd];
        db[c] = do_s[(tx + 16 * c) * ld + dd];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[r][c] = fmaf(ka[r], qb[c], s[r][c]);
          dp[r][c] = fmaf(va[r], db[c], dp[r][c]);
        }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = tx + 16 * c;
        const bool keep = i < nq && j < nk &&
                          !(causal && k0 + j > q0 + i + q_offset);
        const float p = keep ? expf(s[r][c] * scale - lse_s[i]) : 0.f;
        p_s[j * kSld + i] = round_to<T>(p);
        ds_s[j * kSld + i] = round_to<T>(p * (dp[r][c] - delta_s[i]));
      }
    }
    __syncthreads();

    // unrolled by 4: left to itself nvcc unrolls the backward's
    // product loops less here, about 10% slower on the card
#pragma unroll 4
    for (int i = 0; i < nq; ++i) {
      float pa[4], da[4], ob[NC], qb[NC];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[r] = p_s[(ty + 16 * r) * kSld + i];
        da[r] = ds_s[(ty + 16 * r) * kSld + i];
      }
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        ob[cc] = do_s[i * ld + tx + 16 * cc];
        qb[cc] = q_s[i * ld + tx + 16 * cc];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          dv_acc[r][cc] = fmaf(pa[r], ob[cc], dv_acc[r][cc]);
          dk_acc[r][cc] = fmaf(da[r], qb[cc], dk_acc[r][cc]);
        }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = ty + 16 * r;
    if (j >= nk) continue;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int dd = tx + 16 * cc;
      if (dd >= D) continue;
      dk[L.dk.at(b, h, k0 + j) + dd] = from_f<T>(dk_acc[r][cc] * scale);
      dv[L.dv.at(b, h, k0 + j) + dd] = from_f<T>(dv_acc[r][cc]);
    }
  }
}

struct Shape {
  int B, Lq, Lk, H, D, causal, bq, bk;
  float scale;
};

template <typename T, int NC>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               float* lse, const FwdLayouts& L, const Shape& s,
               cudaStream_t stream) {
  const size_t smem = sizeof(float) * fwd_smem_floats<NC>();
  auto kernel = flash_fwd_kernel<T, NC>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s.Lq + s.bq - 1) / s.bq, s.H, s.B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, L, s.Lq, s.Lk, s.D,
      s.scale, s.causal, s.bq, s.bk);
  return (int)cudaGetLastError();
}

template <typename T, int NC>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dq, void* dk,
               void* dv, const BwdLayouts& L, const Shape& s,
               cudaStream_t stream) {
  const size_t smem_dq = sizeof(float) * dq_smem_floats<NC>();
  auto dq_kernel = flash_bwd_dq_kernel<T, NC>;
  cudaError_t err = allow_smem(dq_kernel, smem_dq);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_q((s.Lq + s.bq - 1) / s.bq, s.H, s.B);
  dq_kernel<<<grid_q, kThreads, smem_dq, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), L, s.Lq, s.Lk, s.D, s.scale, s.causal, s.bq,
      s.bk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem_kv = sizeof(float) * dkv_smem_floats<NC>();
  auto dkv_kernel = flash_bwd_dkv_kernel<T, NC>;
  err = allow_smem(dkv_kernel, smem_kv);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_k((s.Lk + s.bk - 1) / s.bk, s.H, s.B);
  dkv_kernel<<<grid_k, kThreads, smem_kv, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), L, s.Lq, s.Lk, s.D, s.scale,
      s.causal, s.bq, s.bk);
  return (int)cudaGetLastError();
}

// the head dim picks the number of 16-column groups each thread carries
template <typename F>
int by_head_dim(int D, F&& f) {
  if (D <= 16) return f(std::integral_constant<int, 1>{});
  if (D <= 32) return f(std::integral_constant<int, 2>{});
  if (D <= 64) return f(std::integral_constant<int, 4>{});
  if (D <= 128) return f(std::integral_constant<int, 8>{});
  return (int)cudaErrorInvalidValue;
}

bool valid(const Shape& s) {
  return s.B > 0 && s.Lq > 0 && s.Lk > 0 && s.H > 0 && s.D > 0 &&
         s.D <= 128 && s.bq > 0 && s.bk > 0;
}

// `n` layouts from 3 * n strides (batch, row, head of each tensor in
// turn); false when a row stride does not fit 32 bits
bool read_layouts(const long long* strides, Layout* out, int n) {
  for (int t = 0; t < n; ++t) {
    const long long row = strides[3 * t + 1];
    if (row < 0 || row > 2147483647LL) return false;
    out[t] = Layout{strides[3 * t], strides[3 * t + 2], (int)row};
  }
  return true;
}

}  // namespace

// the bf16 route (csrc/flash_attention_tc.cu); bq, bk are 64 or 128
int ff_flash_fwd_tc(const void* q, const void* k, const void* v, void* o,
                    float* lse, const long long* strides, int B, int Lq,
                    int Lk, int H, int D, float scale, int causal, int bq,
                    int bk, cudaStream_t stream);
int ff_flash_bwd_tc(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dq, void* dk, void* dv, const long long* strides,
                    int B, int Lq, int Lk, int H, int D, float scale,
                    int causal, int bq, int bk, cudaStream_t stream);

// strides: 15 element strides, (batch, row, head) of q, k, v, o and lse.
// bf16 runs the tensor-core kernels (bq, bk: 64 or 128 rows), f32 the
// CUDA-core ones (bq, bk: at most 64 rows).
extern "C" int ff_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, float* lse, const long long* strides,
                            int B, int Lq, int Lk, int H, int D, float scale,
                            int causal, int bq, int bk, int dtype,
                            void* stream) {
  const Shape s{B, Lq, Lk, H, D, causal, bq, bk, scale};
  if (!valid(s)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == FF_BF16)
    return ff_flash_fwd_tc(q, k, v, o, lse, strides, B, Lq, Lk, H, D, scale,
                           causal, bq, bk, st);
  if (dtype != FF_F32 || bq > kTile || bk > kTile)
    return (int)cudaErrorInvalidValue;
  Layout l[5];
  if (!read_layouts(strides, l, 5)) return (int)cudaErrorInvalidValue;
  const FwdLayouts L{l[0], l[1], l[2], l[3], l[4]};
  return by_head_dim(D, [&](auto nc) {
    return launch_fwd<float, decltype(nc)::value>(q, k, v, o, lse, L, s, st);
  });
}

// strides: 27 element strides, (batch, row, head) of q, k, v, dout, lse,
// delta, dq, dk and dv; routes as ff_flash_fwd
extern "C" int ff_flash_bwd(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dq, void* dk, void* dv,
                            const long long* strides, int B, int Lq, int Lk,
                            int H, int D, float scale, int causal, int bq,
                            int bk, int dtype, void* stream) {
  const Shape s{B, Lq, Lk, H, D, causal, bq, bk, scale};
  if (!valid(s)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == FF_BF16)
    return ff_flash_bwd_tc(q, k, v, dout, lse, delta, dq, dk, dv, strides,
                           B, Lq, Lk, H, D, scale, causal, bq, bk, st);
  if (dtype != FF_F32 || bq > kTile || bk > kTile)
    return (int)cudaErrorInvalidValue;
  Layout l[9];
  if (!read_layouts(strides, l, 9)) return (int)cudaErrorInvalidValue;
  const BwdLayouts L{l[0], l[1], l[2], l[3], l[4], l[5], l[6], l[7], l[8]};
  return by_head_dim(D, [&](auto nc) {
    return launch_bwd<float, decltype(nc)::value>(q, k, v, dout, lse, delta,
                                                  dq, dk, dv, L, s, st);
  });
}
