// LayerNorm and softmax over the trailing axis, forward and backward, for
// Hopper (sm_90a).
//
// layernorm_fwd replaces flexflow_tpu/kernels/pallas/norm.py `_ln_fwd`
// (`_ln_fwd_kernel`): per row, f32 mean, var = mean((x - mean)^2),
// rstd = 1 / sqrt(var + eps), y = (x - mean) * rstd [* gamma + beta] in
// x's dtype, plus the f32 mean and rstd the backward needs.
// softmax_fwd replaces `_softmax_call` with `_softmax_fwd_kernel`: per row,
// f32 max, e = exp(x - max), y = e / sum(e) in x's dtype.
// layernorm_bwd replaces `_ln_bwd` (`_ln_bwd_kernel`): per row, with
// xhat = (x - mean) * rstd and g = dy * gamma (dy without affine),
// dx = (g - mean(g) - xhat * mean(g * xhat)) * rstd in x's dtype; dgamma =
// sum over rows of dy * xhat and dbeta = sum of dy, in f32.
// softmax_bwd replaces `_softmax_call` with `_softmax_bwd_kernel`: per row,
// dx = y * (dy - sum(y * dy)) in y's dtype, the sum in f32.
// rmsnorm_fwd replaces `_rms_fwd` (`_rms_fwd_kernel`): per row, f32
// rstd = 1 / sqrt(mean(x^2) + eps), y = x * rstd [* gamma] in x's dtype,
// plus the f32 rstd the backward needs.
// rmsnorm_bwd replaces `_rms_bwd` (`_rms_bwd_kernel`): per row, with
// xhat = x * rstd and g = dy * gamma (dy without affine),
// dx = (g - xhat * mean(g * xhat)) * rstd in x's dtype; dgamma = sum over
// rows of dy * xhat in f32.
//
// Bound on this card: bytes. Both read each element once and write it
// once with a handful of operations per element.
//
// Softmax forward, RMSNorm forward and LayerNorm forward take a route
// that kernels/norm.py `softmax_plan` / `rmsnorm_plan` /
// `layernorm_fwd_plan` choose from the shape alone (rows, N, dtype); each
// route is a kernel below.
//  - softmax "rows" (N <= 1024: the classifier's N = 2, the tier's 10):
//    a group of 2^k lanes per row (one warp from N = 33), several rows a
//    warp, a grid of a few blocks per SM walking the rows; the row sits
//    in registers, reduced with shuffles only (no shared memory, no
//    barrier); x is read once, exp taken once, y written once.
//  - softmax "block" (wide rows, enough of them to fill the SMs: 128 x
//    30522) and "cluster" (wide rows, few of them: the 8 decode rows and
//    16 prefill-chunk rows over the vocabulary): the row, or its slice
//    on a CTA of a thread-block cluster of 2, 4 or 8, sits in registers
//    as f32 (at most 32 values a thread), read and written with 16-byte
//    vectors; a row of 30522 bf16 is 4 mod 16 bytes long, so each row
//    peels a head of up to 7 elements to the first 16-byte boundary and
//    a tail, handled as scalars. Each CTA takes its (max, sum of e); the
//    CTAs of a cluster exchange them through distributed shared memory
//    and every CTA merges them in rank order (the same bits everywhere,
//    on every run) before it writes its slice: one read of x, one exp.
//  - softmax "loop" (rows wider than a cluster of 8 holds): one block of
//    1024 threads a row, three passes over the row — max, sum, write —
//    the re-reads left to L2 (50 MB).
//  - RMSNorm "warp" (N <= 2048): one warp a row, the row in registers
//    through 16-byte loads (scalar head and tail; the next row's loads
//    issued before this row's sums), gamma in registers
//    loaded once per warp and kept for all its rows while the rows'
//    16-byte phase stays (N * size a multiple of 16: every row), the
//    sum of x^2 in a fixed order (each lane's values in order, then a
//    butterfly of shuffles), a persistent grid walking the rows; y =
//    (x * rstd) * gamma in f32, rounded once, in the plain version's
//    order.
//  - RMSNorm "block" (larger N): one block of 256 threads a row, the row
//    staged in shared memory as it was loaded (16-byte vectors), so
//    device memory is read once; N * size <= 227 KB.
//  - LayerNorm "warp" (N <= 2048: every path's N = 1024): the RMSNorm
//    warp route with the mean — two sums from the registers, sum(x) and
//    then sum((x - mean)^2), each through its own butterfly — and beta
//    kept beside gamma; CTAs of up to 8 warps, fewer where there are few
//    rows (a decode iteration's 8), so the rows spread over the SMs.
//  - LayerNorm "block" (larger N): one block of 256 threads a row, its
//    statistics reduced in f32 with warp shuffles; the row is staged in
//    shared memory as f32 (4N bytes <= 227 KB), so device memory is read
//    once.
// The vector routes need y at the same 16-byte phase as x (the wrapper
// allocates it so).
//
// The backward kernels are bound by bytes too. LayerNorm backward and
// RMSNorm backward take a route that kernels/norm.py `layernorm_bwd_plan`
// / `rmsnorm_bwd_plan` choose from the shape alone:
//  - "warp" (N <= 2048: the training step's (4096, 1024)): one warp a row,
//    x and dy read once as 16-byte vectors (scalar head and tail), gamma
//    in registers for the warp's life, both row sums through one
//    butterfly of shuffles, dx written as 16-byte vectors; each lane sums
//    dgamma and dbeta for its columns over the rows of its warp, a
//    persistent grid of one CTA an SM, so each CTA writes one partial row
//    of each (132 x N x 2 f32 in place of the block route's R / 8); a
//    second kernel, launched as a programmatic dependent, adds them in a
//    fixed order. RMSNorm's "warp" is the same kernel without the mean
//    (kCenter false): xhat = x * rstd, one row sum, no dbeta.
//  - "block" (wider N, up to MAX_BWD_COLS): each block takes kLnBwdRows
//    rows: the row's xhat and g sit in shared memory between the
//    reductions and the dx pass, and each thread sums dgamma (and dbeta)
//    for its own columns over the block's rows; a second launch adds the
//    blocks' partial sums column by column in a fixed order.
// None uses float atomics, so the sums are the same on every run.
//
// Softmax backward (dx = y * (dy - sum(y * dy)), bound by bytes: two
// reads and one write an element; at the classifier's N = 2 by the
// launch) takes a route that kernels/norm.py `softmax_bwd_plan` chooses
// from the shape alone: the forward's routes with a second operand.
//  - "rows" (N <= 512: the classifier's 2, the tier's 10): 2^k lanes a
//    row, several rows a warp, y and dy in registers, the sum by
//    shuffles only; a grid of a few CTAs an SM walking the rows.
//  - "block" (wide rows, enough of them: 128 x 30522, 2048 x 32000,
//    4096 x 1024) and "cluster" (few wide rows: 8 and 16 x 30522, on 8
//    and 4 CTAs): a CTA holds its slice of y and dy as loaded 16-byte
//    vectors (raw: a bf16 vector pair is 8 registers, so 4 pairs a
//    thread stay within the 64 registers a thread of 1024 may have;
//    ptxas reports the counts, tools/norm_bench.py), after the
//    forward's per-row head and tail peel; a cluster's CTAs exchange one
//    partial sum each through distributed shared memory and add them in
//    rank order.
//  - "loop" (rows no cluster of 8 holds: bf16 N > 262144, f32 > 131072):
//    a CTA a row, two passes, the second read left to L2.
// Every product and sum is rounded on its own (__fmul_rn, __fadd_rn, in
// a fixed order), so kernels/norm.py `softmax_bwd_split_plain` gives each
// route's bits in torch; dx is written at y's 16-byte phase, dy read as
// vectors where it shares that phase, else element by element.
#include <cooperative_groups.h>

#include <cstdint>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kLnThreads = 256;
constexpr int kSoftmaxThreads = 1024;  // loop route; most of a regs CTA
constexpr int kSoftmaxMaxPerThread = 32;  // f32 values a regs thread holds
constexpr int kMaxCluster = 8;            // the portable cluster size
constexpr int kRowsThreads = 128;         // softmax rows route
constexpr int kRmsWarpThreads = 256;      // RMSNorm warp route: 8 rows
constexpr int kRmsWarpMaxPerLane = 64;    // f32 values of x a lane holds
constexpr int kLnFwdWarpThreads = 256;    // LayerNorm forward warp route
constexpr int kLnFwdMaxPerLane = 64;      // values of a row a lane takes
constexpr int kLnFwdHoldPerLane = 32;     // up to which gamma, beta stay
constexpr int kLnBwdRows = 8;        // rows per block of layernorm_bwd
constexpr int kLnBwdWarpThreads = 256;   // LayerNorm backward warp route
constexpr int kLnBwdMaxPerLane = 64;     // values of a row a lane takes
constexpr int kLnBwdHoldPerLane = 32;    // up to which x, dy, gamma stay
constexpr int kColSumsThreads = 256;     // warp route's column sums
constexpr int kColSumsBatch = 8;         // loads a lane has in flight
constexpr int kReduceGroups = 16;    // partial-sum groups per column
constexpr int kSoftmaxBwdMaxVecs = 4;     // vector pairs a regs thread holds

// route codes shared with kernels/norm.py SOFTMAX_ROUTES, RMSNORM_ROUTES
enum SoftmaxRoute { kSoftmaxLoop = 0, kSoftmaxRows = 1, kSoftmaxBlock = 2,
                    kSoftmaxCluster = 3 };
enum RmsRoute { kRmsBlock = 0, kRmsWarp = 1 };
// route codes shared with kernels/norm.py LN_FWD_ROUTES
enum LnFwdRoute { kLnFwdBlock = 0, kLnFwdWarp = 1 };
// route codes shared with kernels/norm.py LN_BWD_ROUTES, RMS_BWD_ROUTES
enum LnBwdRoute { kLnBwdBlock = 0, kLnBwdWarp = 1 };

// ---- rows as 16-byte vectors ---------------------------------------------

template <typename T>
constexpr int kVecElems = 16 / static_cast<int>(sizeof(T));

// 16 bytes of T as f32 values (bf16 widens exactly: its bits shifted up)
template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float* f);
template <>
__device__ __forceinline__ void unpack<float>(const uint4& u, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& u,
                                                      float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// f32 values rounded to T (round to nearest even, as from_f) as 16 bytes
template <typename T>
__device__ __forceinline__ uint4 pack(const float* f);
template <>
__device__ __forceinline__ uint4 pack<float>(const float* f) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
template <>
__device__ __forceinline__ uint4 pack<__nv_bfloat16>(const float* f) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = static_cast<uint32_t>(
               __bfloat16_as_ushort(__float2bfloat16(f[2 * i]))) |
           (static_cast<uint32_t>(
                __bfloat16_as_ushort(__float2bfloat16(f[2 * i + 1])))
            << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// A row as `head` elements up to its first 16-byte boundary, `nv` 16-byte
// vectors, then `tail` elements. Rows start wherever R x N puts them (a
// bf16 row of 30522 is 4 mod 16 bytes long), so each row has its own.
struct RowSplit {
  int head, nv, tail;
};

template <typename T>
__device__ __forceinline__ RowSplit row_split(const T* row, int n) {
  constexpr int W = kVecElems<T>;
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(row) & 15);
  const int head = min(mis ? (16 - mis) / static_cast<int>(sizeof(T)) : 0,
                       n);
  const int nv = (n - head) / W;
  return {head, nv, n - head - nv * W};
}

// the head or tail element thread t takes (at most 14 of them), or -1
__device__ __forceinline__ int edge_elem(const RowSplit& s, int n, int t) {
  if (t < s.head) return t;
  if (t < s.head + s.tail) return n - s.tail + (t - s.head);
  return -1;
}

// W (a multiple of 4) f32 values of gamma from p: 16-byte loads where p is
// 16-byte aligned, else one float at a time. A lane's W values sit 4W bytes
// from its neighbour's, so one float a load would touch 8x the bytes it
// uses: L1's rate, not the memory's, then bounds a warp's gather.
template <int W>
__device__ __forceinline__ void load_gamma(const float* p, bool aligned,
                                           float (&g)[W]) {
  if (aligned) {
#pragma unroll
    for (int j = 0; j < W; j += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + j);
      g[j] = q.x;
      g[j + 1] = q.y;
      g[j + 2] = q.z;
      g[j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j) g[j] = p[j];
  }
}

// 16 bytes of T from p: one vector load where `vec` (p 16-byte aligned),
// else single loads assembled into the same bits
template <typename T>
__device__ __forceinline__ uint4 load_vec(const T* p, bool vec) {
  if (vec) return *reinterpret_cast<const uint4*>(p);
  uint32_t w[4];
  if constexpr (sizeof(T) == 4) {
    const uint32_t* q = reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = q[i];
  } else {
    const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = static_cast<uint32_t>(q[2 * i]) |
             (static_cast<uint32_t>(q[2 * i + 1]) << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <typename T>
__global__ void __launch_bounds__(kLnThreads)
    layernorm_fwd_kernel(const T* __restrict__ x,
                         const float* __restrict__ gamma,
                         const float* __restrict__ beta, T* __restrict__ y,
                         float* __restrict__ mean_out,
                         float* __restrict__ rstd_out, int N, float eps) {
  extern __shared__ float row[];
  __shared__ float red[32];
  const size_t r = blockIdx.x;
  const T* xr = x + r * N;
  float s = 0.f;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const float v = to_f(xr[i]);
    row[i] = v;  // each thread rereads only the elements it wrote
    s += v;
  }
  const float mean = block_reduce<false>(s, red) / N;
  float s2 = 0.f;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const float d = row[i] - mean;
    s2 += d * d;
  }
  const float var = block_reduce<false>(s2, red) / N;
  const float rstd = 1.f / sqrtf(var + eps);
  T* yr = y + r * N;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    float v = (row[i] - mean) * rstd;
    if (gamma != nullptr) v = v * gamma[i] + beta[i];
    yr[i] = from_f<T>(v);
  }
  if (threadIdx.x == 0) {
    mean_out[r] = mean;
    rstd_out[r] = rstd;
  }
}

// softmax "rows": LANES lanes a row (32 / LANES rows a warp), K values a
// lane at columns lane + LANES * k; the warp's rows advance together, so
// every shuffle has the full warp.
template <typename T, int LANES, int K>
__global__ void __launch_bounds__(kRowsThreads)
    softmax_rows_kernel(const T* __restrict__ x, T* __restrict__ y, int R,
                        int N) {
  constexpr int kRowsPerWarp = 32 / LANES;
  const int lane = threadIdx.x & 31;
  const int sub = lane / LANES, li = lane % LANES;
  const long warps = static_cast<long>(gridDim.x) * (blockDim.x >> 5);
  for (long base = (static_cast<long>(blockIdx.x) * (blockDim.x >> 5) +
                    (threadIdx.x >> 5)) * kRowsPerWarp;
       base < R; base += warps * kRowsPerWarp) {
    const long r = base + sub;
    const bool live = r < R;
    const T* xr = x + r * N;
    float v[K];
    float m = -CUDART_INF_F;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = li + k * LANES;
      v[k] = live && i < N ? to_f(xr[i]) : -CUDART_INF_F;
      m = fmaxf(m, v[k]);
    }
#pragma unroll
    for (int o = LANES / 2; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      v[k] = expf(v[k] - m);  // 0 past N (a row past R is never written)
      s += v[k];
    }
#pragma unroll
    for (int o = LANES / 2; o > 0; o >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, o);
    if (live) {
      const float inv = 1.f / s;
      T* yr = y + r * N;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int i = li + k * LANES;
        if (i < N) yr[i] = from_f<T>(v[k] * inv);
      }
    }
  }
}

// softmax "block" (a cluster of 1) and "cluster": the CTA of rank c of a
// row's cluster of C holds vectors [c * per, (c + 1) * per) of the row, at
// most VECS a thread, and rank 0 the head and tail elements. It takes its
// max m_c and s_c = sum exp(x - m_c); thread 0 of every CTA merges the
// cluster's (m_c, s_c) in rank order, M = max m_c, S = sum s_c e^(m_c - M),
// and the CTA writes e * (e^(m_c - M) / S), which is e * (1 / s) on one
// CTA: one reciprocal a CTA in place of a division an element (within an
// f32 ulp of e / s; the division's MUFU and refinement cost more than the
// exp at 30 values a thread).
template <typename T, int VECS>
__global__ void __launch_bounds__(kSoftmaxThreads)
    softmax_regs_kernel(const T* __restrict__ x, T* __restrict__ y, int N) {
  constexpr int W = kVecElems<T>;
  __shared__ float red[32];
  __shared__ float2 part;    // this CTA's (m_c, s_c), read by the cluster
  __shared__ float2 merged;  // the row's (M, S)
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const size_t r = blockIdx.x / C;
  const T* xr = x + r * N;
  T* yr = y + r * N;
  const RowSplit rs = row_split(xr, N);
  const int per = (rs.nv + C - 1) / C;
  const int v0 = rank * per, v1 = min(rs.nv, v0 + per);
  const uint4* xv = reinterpret_cast<const uint4*>(xr + rs.head);
  uint4* yv = reinterpret_cast<uint4*>(yr + rs.head);
  float v[VECS][W];
  float m = -CUDART_INF_F;
#pragma unroll
  for (int k = 0; k < VECS; ++k) {
    const int i = v0 + threadIdx.x + k * blockDim.x;
    if (i < v1) {
      unpack<T>(xv[i], v[k]);
#pragma unroll
      for (int j = 0; j < W; ++j) m = fmaxf(m, v[k][j]);
    }
  }
  const int ei = rank == 0 ? edge_elem(rs, N, threadIdx.x) : -1;
  float ev = ei >= 0 ? to_f(xr[ei]) : -CUDART_INF_F;
  m = block_reduce<true>(fmaxf(m, ev), red);
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < VECS; ++k) {
    if (v0 + threadIdx.x + k * blockDim.x < v1) {
#pragma unroll
      for (int j = 0; j < W; ++j) {
        v[k][j] = expf(v[k][j] - m);
        s += v[k][j];
      }
    }
  }
  if (ei >= 0) {
    ev = expf(ev - m);
    s += ev;
  }
  s = block_reduce<false>(s, red);
  float f = 1.f;  // e^(m_c - M)
  if (C > 1) {
    if (threadIdx.x == 0) part = make_float2(m, s);
    cluster.sync();
    if (threadIdx.x == 0) {
      float M = -CUDART_INF_F, S = 0.f;
      for (int c = 0; c < C; ++c)
        M = fmaxf(M, cluster.map_shared_rank(&part, c)->x);
      for (int c = 0; c < C; ++c) {
        const float2 p = *cluster.map_shared_rank(&part, c);
        S += p.y * expf(p.x - M);
      }
      merged = make_float2(M, S);
    }
    // done with the other CTAs' partials; the matching wait, before this
    // CTA exits, keeps its own alive until every CTA has read it
    cluster_arrive();
    __syncthreads();
    f = expf(m - merged.x);
    s = merged.y;
  }
  const float scale = f / s;
#pragma unroll
  for (int k = 0; k < VECS; ++k) {
    const int i = v0 + threadIdx.x + k * blockDim.x;
    if (i < v1) {
      float o[W];
#pragma unroll
      for (int j = 0; j < W; ++j) o[j] = v[k][j] * scale;
      yv[i] = pack<T>(o);
    }
  }
  if (ei >= 0) yr[ei] = from_f<T>(ev * scale);
  if (C > 1) cluster_wait();
}

// softmax "loop": one block a row, three passes over it
template <typename T>
__global__ void __launch_bounds__(kSoftmaxThreads)
    softmax_loop_kernel(const T* __restrict__ x, T* __restrict__ y, int N) {
  __shared__ float red[32];
  const size_t r = blockIdx.x;
  const T* xr = x + r * N;
  float m = -CUDART_INF_F;
  for (int i = threadIdx.x; i < N; i += blockDim.x) m = fmaxf(m, to_f(xr[i]));
  m = block_reduce<true>(m, red);
  float s = 0.f;
  for (int i = threadIdx.x; i < N; i += blockDim.x) s += expf(to_f(xr[i]) - m);
  s = block_reduce<false>(s, red);
  T* yr = y + r * N;
  for (int i = threadIdx.x; i < N; i += blockDim.x)
    yr[i] = from_f<T>(expf(to_f(xr[i]) - m) / s);
}

template <typename T>
__global__ void __launch_bounds__(kLnThreads)
    layernorm_bwd_kernel(const T* __restrict__ x,
                         const float* __restrict__ gamma,
                         const float* __restrict__ mean,
                         const float* __restrict__ rstd,
                         const T* __restrict__ dy, T* __restrict__ dx,
                         float* __restrict__ dg_part,
                         float* __restrict__ db_part, int R, int N) {
  extern __shared__ float sm[];
  float* xhat_s = sm;         // N
  float* g_s = xhat_s + N;    // N
  float* dg_s = g_s + N;      // N, affine only
  float* db_s = dg_s + N;     // N, affine only
  __shared__ float red[32];
  const bool affine = gamma != nullptr;
  // every thread touches only its own columns i = tid + k * blockDim.x of
  // the row buffers and partial sums, so they need no barrier of their own
  if (affine)
    for (int i = threadIdx.x; i < N; i += blockDim.x) dg_s[i] = db_s[i] = 0.f;
  const int r0 = blockIdx.x * kLnBwdRows;
  const int r1 = min(R, r0 + kLnBwdRows);
  for (int r = r0; r < r1; ++r) {
    const T* xr = x + (size_t)r * N;
    const T* dyr = dy + (size_t)r * N;
    const float mu = mean[r], rs = rstd[r];
    float s1 = 0.f, s2 = 0.f;
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
      const float d = to_f(dyr[i]);
      const float xh = (to_f(xr[i]) - mu) * rs;
      const float g = affine ? d * gamma[i] : d;
      xhat_s[i] = xh;
      g_s[i] = g;
      s1 += g;
      s2 += g * xh;
      if (affine) {
        dg_s[i] += d * xh;
        db_s[i] += d;
      }
    }
    const float m1 = block_reduce<false>(s1, red) / N;
    const float m2 = block_reduce<false>(s2, red) / N;
    T* dxr = dx + (size_t)r * N;
    for (int i = threadIdx.x; i < N; i += blockDim.x)
      dxr[i] = from_f<T>((g_s[i] - m1 - xhat_s[i] * m2) * rs);
  }
  if (affine)
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
      dg_part[(size_t)blockIdx.x * N + i] = dg_s[i];
      db_part[(size_t)blockIdx.x * N + i] = db_s[i];
    }
}

// dgamma (and dbeta, when db_part is given): column c sums the P partial
// rows. Group y of the block sums rows y, y + kReduceGroups, ... in order;
// then thread y = 0 adds the groups in order — a fixed order, so every run
// gives the same bits.
__global__ void __launch_bounds__(32 * kReduceGroups)
    column_sums_kernel(const float* __restrict__ dg_part,
                       const float* __restrict__ db_part, int P, int N,
                       float* __restrict__ dg, float* __restrict__ db) {
  __shared__ float sg[kReduceGroups][32], sb[kReduceGroups][32];
  const int c = blockIdx.x * 32 + threadIdx.x;
  const bool two = db_part != nullptr;
  float a = 0.f, b = 0.f;
  if (c < N)
    for (int p = threadIdx.y; p < P; p += kReduceGroups) {
      a += dg_part[(size_t)p * N + c];
      if (two) b += db_part[(size_t)p * N + c];
    }
  sg[threadIdx.y][threadIdx.x] = a;
  sb[threadIdx.y][threadIdx.x] = b;
  __syncthreads();
  if (threadIdx.y == 0 && c < N) {
    float ta = 0.f, tb = 0.f;
    for (int y = 0; y < kReduceGroups; ++y) {
      ta += sg[y][threadIdx.x];
      tb += sb[y][threadIdx.x];
    }
    dg[c] = ta;
    if (two) db[c] = tb;
  }
}

// One row of the LayerNorm backward warp route as a lane holds it: HV
// 16-byte vectors of x and of dy (its vectors lane + 32 * k; none where
// the row is read again in the second pass), the row's mean (kCenter:
// LayerNorm; RMSNorm has none) and rstd, and the lane's head or tail
// element of x and dy.
template <typename T, int HV, bool kCenter>
struct LnBwdRow {
  uint4 xu[HV > 0 ? HV : 1], du[HV > 0 ? HV : 1];
  float mu, rsd, xe, de;

  __device__ __forceinline__ void load(const T* x, const T* dy,
                                       const float* mean, const float* rstd,
                                       long r, int N, const RowSplit& rs,
                                       int ei, int lane, bool dy_vec) {
    constexpr int W = kVecElems<T>;
    const T* xr = x + r * N;
    const T* dyr = dy + r * N;
    const uint4* xv = reinterpret_cast<const uint4*>(xr + rs.head);
#pragma unroll
    for (int k = 0; k < HV; ++k) {
      const int v = lane + 32 * k;
      if (v < rs.nv) {
        xu[k] = xv[v];
        du[k] = load_vec<T>(dyr + rs.head + v * W, dy_vec);
      }
    }
    mu = kCenter ? mean[r] : 0.f;
    rsd = rstd[r];
    xe = ei >= 0 ? to_f(xr[ei]) : 0.f;
    de = ei >= 0 ? to_f(dyr[ei]) : 0.f;
  }
};

// LayerNorm backward "warp": one warp a row, a persistent grid of warps
// striding over the rows. Every row of a warp starts at the 16-byte phase
// of its first (the stride times a row's bytes is a multiple of 16: the
// launcher checks), so lane l takes the same columns of every row: the
// vectors l, l + 32, ... after the row's head, and one head or tail
// element on lanes 0-13. Per row, in f32 with every step rounded on its
// own (no fused multiply-add): xhat = (x - mean) * rstd, g = dy * gamma;
// the lane sums g and g * xhat over its values in order, the two sums
// meet in one butterfly of shuffles (no shared memory, no barrier), m1 =
// sum(g) / N, m2 = sum(g * xhat) / N, and dx = ((g - m1) - xhat * m2) *
// rstd goes out as 16-byte vectors (dx at x's phase; dy read as vectors
// where it shares x's phase, else element by element). Each lane adds
// dy * xhat and dy into dgamma and dbeta for its columns over its warp's
// rows; at the end the CTA adds its warps' sums in warp order through
// shared memory and writes one partial row of each. Up to
// kLnBwdHoldPerLane values a lane (N <= 1024) x, dy and gamma stay in
// registers between the two passes; past it (N <= 2048) the second pass
// reads x, dy and gamma again (from L1), so the dgamma and dbeta sums
// keep the registers. Timed at (4096, 1024) bf16 on an H100 SXM
// (tools/norm_bench.py) against this design: the next row's loads issued
// before this row's sums (as RMSNorm forward) 3% slower; gamma read from
// L1 in place of registers 6%, and with the registers it frees 12 warps
// an SM 10%, 16 (128 registers, spilling) 18% slower.
// kCenter false is RMSNorm's backward (`_rms_bwd_kernel`): no mean, xhat =
// x * rstd, only the sum of g * xhat, dx = (g - xhat * m2) * rstd, and
// dgamma without dbeta.
template <typename T, int VECS, bool kCenter>
__global__ void __launch_bounds__(kLnBwdWarpThreads)
    layernorm_bwd_warp_kernel(const T* __restrict__ x,
                              const float* __restrict__ gamma,
                              const float* __restrict__ mean,
                              const float* __restrict__ rstd,
                              const T* __restrict__ dy, T* __restrict__ dx,
                              float* __restrict__ dg_part,
                              float* __restrict__ db_part, int R, int N,
                              int dy_vec) {
  constexpr int W = kVecElems<T>;
  constexpr bool kHold = VECS * W <= kLnBwdHoldPerLane;
  constexpr int HV = kHold ? VECS : 0;
  extern __shared__ float ln_acc[];  // [warps][N], affine only
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const bool affine = gamma != nullptr;
  const long warps = static_cast<long>(gridDim.x) * nwarps;
  const long r0 = static_cast<long>(blockIdx.x) * nwarps + warp;
  const RowSplit rs = row_split(x + r0 * N, N);
  const int ei = edge_elem(rs, N, lane);
  const float* gr = affine ? gamma + rs.head : nullptr;
  const bool g_aligned = (reinterpret_cast<uintptr_t>(gr) & 15) == 0;
  float gk[kHold ? VECS : 1][W];  // gamma at this lane's columns (hold)
  float ge = 1.f;                 // and at its head or tail element
  float dg[VECS][W], db[kCenter ? VECS : 1][W];
  float dge = 0.f, dbe = 0.f;
#pragma unroll
  for (int k = 0; k < VECS; ++k)
#pragma unroll
    for (int j = 0; j < W; ++j) {
      dg[k][j] = 0.f;
      if constexpr (kCenter) db[k][j] = 0.f;
    }
  if (affine) {
    if constexpr (kHold) {
#pragma unroll
      for (int k = 0; k < VECS; ++k)
        if (lane + 32 * k < rs.nv)
          load_gamma<W>(gr + (lane + 32 * k) * W, g_aligned, gk[k]);
    }
    if (ei >= 0) ge = gamma[ei];
  }
  for (long r = r0; r < R; r += warps) {
    LnBwdRow<T, HV, kCenter> cur;
    cur.load(x, dy, mean, rstd, r, N, rs, ei, lane, dy_vec);
    const float mu = cur.mu, rsd = cur.rsd;
    // xhat of one value: x - mean only where there is a mean
    auto xhat = [&](float v) {
      if constexpr (kCenter) return __fmul_rn(__fsub_rn(v, mu), rsd);
      else return __fmul_rn(v, rsd);
    };
    const uint4* xv = reinterpret_cast<const uint4*>(x + r * N + rs.head);
    const T* dyh = dy + r * N + rs.head;
    // pass 1: the row sums and this lane's dgamma / dbeta terms
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < VECS; ++k) {
      const int v = lane + 32 * k;
      if (v < rs.nv) {
        float xf[W], df[W], gf[W];
        if constexpr (kHold) {
          unpack<T>(cur.xu[k], xf);
          unpack<T>(cur.du[k], df);
        } else {
          unpack<T>(xv[v], xf);
          unpack<T>(load_vec<T>(dyh + v * W, dy_vec), df);
        }
        if (affine) {
          if constexpr (kHold) {
#pragma unroll
            for (int j = 0; j < W; ++j) gf[j] = gk[k][j];
          } else {
            load_gamma<W>(gr + v * W, g_aligned, gf);
          }
        }
#pragma unroll
        for (int j = 0; j < W; ++j) {
          const float xh = xhat(xf[j]);
          const float g = affine ? __fmul_rn(df[j], gf[j]) : df[j];
          if constexpr (kCenter) s1 = __fadd_rn(s1, g);
          s2 = __fadd_rn(s2, __fmul_rn(g, xh));
          if (affine) {
            dg[k][j] = __fadd_rn(dg[k][j], __fmul_rn(df[j], xh));
            if constexpr (kCenter) db[k][j] = __fadd_rn(db[k][j], df[j]);
          }
        }
      }
    }
    const float xhe = xhat(cur.xe);
    const float gv = affine ? __fmul_rn(cur.de, ge) : cur.de;
    if (ei >= 0) {
      if constexpr (kCenter) s1 = __fadd_rn(s1, gv);
      s2 = __fadd_rn(s2, __fmul_rn(gv, xhe));
      if (affine) {
        dge = __fadd_rn(dge, __fmul_rn(cur.de, xhe));
        if constexpr (kCenter) dbe = __fadd_rn(dbe, cur.de);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      if constexpr (kCenter)
        s1 = __fadd_rn(s1, __shfl_xor_sync(0xffffffffu, s1, o));
      s2 = __fadd_rn(s2, __shfl_xor_sync(0xffffffffu, s2, o));
    }
    const float m1 = __fdiv_rn(s1, static_cast<float>(N));
    const float m2 = __fdiv_rn(s2, static_cast<float>(N));
    // dx of one value: ((g - m1) - xhat * m2) * rstd, without m1 for RMSNorm
    auto dx_of = [&](float g, float xh) {
      const float c = kCenter ? __fsub_rn(g, m1) : g;
      return __fmul_rn(__fsub_rn(c, __fmul_rn(xh, m2)), rsd);
    };
    // pass 2: dx
    T* dxr = dx + r * N;
    uint4* dxv = reinterpret_cast<uint4*>(dxr + rs.head);
#pragma unroll
    for (int k = 0; k < VECS; ++k) {
      const int v = lane + 32 * k;
      if (v < rs.nv) {
        float xf[W], df[W], gf[W];
        if constexpr (kHold) {
          unpack<T>(cur.xu[k], xf);
          unpack<T>(cur.du[k], df);
        } else {
          unpack<T>(xv[v], xf);
          unpack<T>(load_vec<T>(dyh + v * W, dy_vec), df);
        }
        if (affine) {
          if constexpr (kHold) {
#pragma unroll
            for (int j = 0; j < W; ++j) gf[j] = gk[k][j];
          } else {
            load_gamma<W>(gr + v * W, g_aligned, gf);
          }
        }
        float o[W];
#pragma unroll
        for (int j = 0; j < W; ++j)
          o[j] = dx_of(affine ? __fmul_rn(df[j], gf[j]) : df[j],
                       xhat(xf[j]));
        dxv[v] = pack<T>(o);
      }
    }
    if (ei >= 0) dxr[ei] = from_f<T>(dx_of(gv, xhe));
  }
  if (!affine) return;
  // the CTA's partial rows: column by column, its warps' sums in warp
  // order (each column has one lane of every warp); dgamma, then dbeta
  float* mine = ln_acc + static_cast<size_t>(warp) * N;
#pragma unroll
  for (int pass = 0; pass < (kCenter ? 2 : 1); ++pass) {
#pragma unroll
    for (int k = 0; k < VECS; ++k) {
      const int v = lane + 32 * k;
      if (v < rs.nv)
#pragma unroll
        for (int j = 0; j < W; ++j)
          mine[rs.head + v * W + j] = pass ? db[kCenter ? k : 0][j]
                                           : dg[k][j];
    }
    if (ei >= 0) mine[ei] = pass ? dbe : dge;
    __syncthreads();
    float* out = (pass ? db_part : dg_part) +
                 static_cast<size_t>(blockIdx.x) * N;
    for (int c = threadIdx.x; c < N; c += blockDim.x) {
      float t = 0.f;
      for (int w = 0; w < nwarps; ++w)
        t = __fadd_rn(t, ln_acc[static_cast<size_t>(w) * N + c]);
      out[c] = t;
    }
    __syncthreads();  // the buffer is rewritten by the next pass
  }
  // the column sums may launch once every CTA has written its partials
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// The warp route's dgamma (blockIdx.y 0) and dbeta (1): a warp a column
// c, lane y summing partial rows y, y + 32, ... in order, then a
// butterfly over the lanes — a fixed order, so every run gives the same
// bits. A lane issues kColSumsBatch loads before it adds them (one at a
// time, each would wait out L2's latency). Launched as a programmatic
// dependent of the row kernel: it waits for the partials before it reads
// them.
__global__ void __launch_bounds__(kColSumsThreads)
    ln_column_sums_kernel(const float* __restrict__ dg_part,
                          const float* __restrict__ db_part, int P, int N,
                          float* __restrict__ dg, float* __restrict__ db) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (c >= N) return;  // whole warps: the shuffles below stay full
  const float* part = blockIdx.y ? db_part : dg_part;
  float s = 0.f;
  for (int p0 = lane; p0 < P; p0 += 32 * kColSumsBatch) {
    float v[kColSumsBatch];
#pragma unroll
    for (int i = 0; i < kColSumsBatch; ++i) {
      const int p = p0 + 32 * i;
      v[i] = p < P ? part[static_cast<size_t>(p) * N + c] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kColSumsBatch; ++i)
      if (p0 + 32 * i < P) s = __fadd_rn(s, v[i]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
  if (lane == 0) (blockIdx.y ? db : dg)[c] = s;
}

// softmax backward "rows": the forward's rows kernel with dy beside y.
// LANES lanes a row (32 / LANES rows a warp), K values of each a lane at
// columns lane + LANES * k; the lane adds its y * dy in k order, then a
// butterfly over the row's lanes.
template <typename T, int LANES, int K>
__global__ void __launch_bounds__(kRowsThreads)
    softmax_bwd_rows_kernel(const T* __restrict__ y,
                            const T* __restrict__ dy, T* __restrict__ dx,
                            int R, int N) {
  constexpr int kRowsPerWarp = 32 / LANES;
  const int lane = threadIdx.x & 31;
  const int sub = lane / LANES, li = lane % LANES;
  const long warps = static_cast<long>(gridDim.x) * (blockDim.x >> 5);
  for (long base = (static_cast<long>(blockIdx.x) * (blockDim.x >> 5) +
                    (threadIdx.x >> 5)) * kRowsPerWarp;
       base < R; base += warps * kRowsPerWarp) {
    const long r = base + sub;
    const bool live = r < R;
    const T* yr = y + r * N;
    const T* dyr = dy + r * N;
    float yv[K], dv[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = li + k * LANES;
      const bool in = live && i < N;
      yv[k] = in ? to_f(yr[i]) : 0.f;
      dv[k] = in ? to_f(dyr[i]) : 0.f;
    }
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) s = __fadd_rn(s, __fmul_rn(yv[k], dv[k]));
#pragma unroll
    for (int o = LANES / 2; o > 0; o >>= 1)
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
    if (live) {
      T* dxr = dx + r * N;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int i = li + k * LANES;
        if (i < N) dxr[i] = from_f<T>(__fmul_rn(yv[k], __fsub_rn(dv[k], s)));
      }
    }
  }
}

// y * dy of one 16-byte vector pair, added to s in element order
template <typename T>
__device__ __forceinline__ float dot_vec(float s, const uint4& uy,
                                         const uint4& ud) {
  constexpr int W = kVecElems<T>;
  float fy[W], fd[W];
  unpack<T>(uy, fy);
  unpack<T>(ud, fd);
#pragma unroll
  for (int j = 0; j < W; ++j) s = __fadd_rn(s, __fmul_rn(fy[j], fd[j]));
  return s;
}

// y * (dy - S) of one 16-byte vector pair, packed
template <typename T>
__device__ __forceinline__ uint4 dx_vec(const uint4& uy, const uint4& ud,
                                        float S) {
  constexpr int W = kVecElems<T>;
  float fy[W], fd[W], o[W];
  unpack<T>(uy, fy);
  unpack<T>(ud, fd);
#pragma unroll
  for (int j = 0; j < W; ++j) o[j] = __fmul_rn(fy[j], __fsub_rn(fd[j], S));
  return pack<T>(o);
}

// softmax backward "block" (a cluster of 1) and "cluster": the CTA of
// rank c of a row's cluster of C holds vectors [c * per, (c + 1) * per) of
// y and dy as loaded, at most VECS of each a thread (vectors t, t +
// blockDim.x, ...), and rank 0 the head and tail elements. Thread t adds
// y * dy over its vectors in order, then its head or tail element;
// block_reduce gives the CTA's sum; with C > 1 thread 0 of every CTA adds
// the cluster's sums in rank order (the same bits on every CTA), and the
// CTA writes its slice of dx.
template <typename T, int VECS>
__global__ void __launch_bounds__(kSoftmaxThreads)
    softmax_bwd_regs_kernel(const T* __restrict__ y, const T* __restrict__ dy,
                            T* __restrict__ dx, int N, int dy_vec) {
  constexpr int W = kVecElems<T>;
  __shared__ float red[32];
  __shared__ float part;    // this CTA's sum, read by the cluster
  __shared__ float merged;  // the row's
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const size_t r = blockIdx.x / C;
  const T* yr = y + r * N;
  const T* dyr = dy + r * N;
  T* dxr = dx + r * N;
  const RowSplit rs = row_split(yr, N);
  const int per = (rs.nv + C - 1) / C;
  const int v0 = rank * per, v1 = min(rs.nv, v0 + per);
  const uint4* yv = reinterpret_cast<const uint4*>(yr + rs.head);
  uint4* dxv = reinterpret_cast<uint4*>(dxr + rs.head);
  uint4 uy[VECS], ud[VECS];
#pragma unroll
  for (int k = 0; k < VECS; ++k) {
    const int i = v0 + threadIdx.x + k * blockDim.x;
    if (i < v1) {
      uy[k] = yv[i];
      ud[k] = load_vec<T>(dyr + rs.head + static_cast<size_t>(i) * W,
                          dy_vec);
    }
  }
  const int ei = rank == 0 ? edge_elem(rs, N, threadIdx.x) : -1;
  const float ye = ei >= 0 ? to_f(yr[ei]) : 0.f;
  const float de = ei >= 0 ? to_f(dyr[ei]) : 0.f;
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < VECS; ++k)
    if (v0 + threadIdx.x + k * blockDim.x < v1) s = dot_vec<T>(s, uy[k], ud[k]);
  if (ei >= 0) s = __fadd_rn(s, __fmul_rn(ye, de));
  s = block_reduce<false>(s, red);
  if (C > 1) {
    if (threadIdx.x == 0) part = s;
    cluster.sync();
    if (threadIdx.x == 0) {
      float S = 0.f;
      for (int c = 0; c < C; ++c)
        S = __fadd_rn(S, *cluster.map_shared_rank(&part, c));
      merged = S;
    }
    // done with the other CTAs' sums; the matching wait, before this CTA
    // exits, keeps its own alive until every CTA has read it
    cluster_arrive();
    __syncthreads();
    s = merged;
  }
#pragma unroll
  for (int k = 0; k < VECS; ++k) {
    const int i = v0 + threadIdx.x + k * blockDim.x;
    if (i < v1) dxv[i] = dx_vec<T>(uy[k], ud[k], s);
  }
  if (ei >= 0) dxr[ei] = from_f<T>(__fmul_rn(ye, __fsub_rn(de, s)));
  if (C > 1) cluster_wait();
}

// softmax backward "loop": a CTA a row, its vectors t, t + blockDim.x, ...
// read twice (the sum, then dx; the second read from L2), the sum in the
// regs kernel's order with no bound on the vectors a thread
template <typename T>
__global__ void __launch_bounds__(kSoftmaxThreads)
    softmax_bwd_loop_kernel(const T* __restrict__ y, const T* __restrict__ dy,
                            T* __restrict__ dx, int N, int dy_vec) {
  constexpr int W = kVecElems<T>;
  __shared__ float red[32];
  const size_t r = blockIdx.x;
  const T* yr = y + r * N;
  const T* dyr = dy + r * N;
  T* dxr = dx + r * N;
  const RowSplit rs = row_split(yr, N);
  const uint4* yv = reinterpret_cast<const uint4*>(yr + rs.head);
  uint4* dxv = reinterpret_cast<uint4*>(dxr + rs.head);
  const T* dyv = dyr + rs.head;
  float s = 0.f;
  for (int i = threadIdx.x; i < rs.nv; i += blockDim.x)
    s = dot_vec<T>(s, yv[i], load_vec<T>(dyv + static_cast<size_t>(i) * W,
                                         dy_vec));
  const int ei = edge_elem(rs, N, threadIdx.x);
  const float ye = ei >= 0 ? to_f(yr[ei]) : 0.f;
  const float de = ei >= 0 ? to_f(dyr[ei]) : 0.f;
  if (ei >= 0) s = __fadd_rn(s, __fmul_rn(ye, de));
  s = block_reduce<false>(s, red);
  for (int i = threadIdx.x; i < rs.nv; i += blockDim.x)
    dxv[i] = dx_vec<T>(yv[i], load_vec<T>(dyv + static_cast<size_t>(i) * W,
                                          dy_vec), s);
  if (ei >= 0) dxr[ei] = from_f<T>(__fmul_rn(ye, __fsub_rn(de, s)));
}

// One row of the RMSNorm warp route as a lane holds it: its split, its
// vectors at indices lane + 32 * k, its head or tail element.
template <typename T, int VECS>
struct WarpRow {
  RowSplit rs;
  int ei;
  float xe;
  uint4 raw[VECS];

  __device__ __forceinline__ void load(const T* x, long r, int N, int lane) {
    const T* xr = x + r * N;
    rs = row_split(xr, N);
    ei = edge_elem(rs, N, lane);
    const uint4* xv = reinterpret_cast<const uint4*>(xr + rs.head);
#pragma unroll
    for (int k = 0; k < VECS; ++k)
      if (lane + 32 * k < rs.nv) raw[k] = xv[lane + 32 * k];
    xe = ei >= 0 ? to_f(xr[ei]) : 0.f;
  }
};

// RMSNorm "warp": one warp a row, the head and tail elements on lanes
// 0-13; the next row's loads are issued before this row's sums, so two
// rows of a warp are in flight.
template <typename T, int VECS>
__global__ void __launch_bounds__(kRmsWarpThreads)
    rmsnorm_warp_kernel(const T* __restrict__ x,
                        const float* __restrict__ gamma, T* __restrict__ y,
                        float* __restrict__ rstd_out, int R, int N,
                        float eps) {
  constexpr int W = kVecElems<T>;
  const int lane = threadIdx.x & 31;
  const bool affine = gamma != nullptr;
  const long warps = static_cast<long>(gridDim.x) * (blockDim.x >> 5);
  float g[VECS][W];  // gamma at this lane's columns for rows of phase ghead
  float ge = 1.f;    // and at its head or tail element
  int ghead = -1;
  long r = static_cast<long>(blockIdx.x) * (blockDim.x >> 5) +
           (threadIdx.x >> 5);
  WarpRow<T, VECS> cur;
  if (r < R) cur.load(x, r, N, lane);
  for (; r < R; r += warps) {
    WarpRow<T, VECS> next;
    if (r + warps < R) next.load(x, r + warps, N, lane);
    const RowSplit& rs = cur.rs;
    const int ei = cur.ei;
    if (affine && rs.head != ghead) {  // the same branch for the whole warp
      const bool aligned =
          (reinterpret_cast<uintptr_t>(gamma + rs.head) & 15) == 0;
#pragma unroll
      for (int k = 0; k < VECS; ++k)
        if (lane + 32 * k < rs.nv)
          load_gamma<W>(gamma + rs.head + (lane + 32 * k) * W, aligned,
                        g[k]);
      ge = ei >= 0 ? gamma[ei] : 1.f;
      ghead = rs.head;
    }
    // sum of x^2: this lane's values in order, no fused multiply-add
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < VECS; ++k) {
      if (lane + 32 * k < rs.nv) {
        float f[W];
        unpack<T>(cur.raw[k], f);
#pragma unroll
        for (int j = 0; j < W; ++j) s = __fadd_rn(s, __fmul_rn(f[j], f[j]));
      }
    }
    if (ei >= 0) s = __fadd_rn(s, __fmul_rn(cur.xe, cur.xe));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
    const float rstd = 1.f / sqrtf(s / N + eps);
    if (lane == 0) rstd_out[r] = rstd;
    T* yr = y + r * N;
    uint4* yv = reinterpret_cast<uint4*>(yr + rs.head);
#pragma unroll
    for (int k = 0; k < VECS; ++k) {
      if (lane + 32 * k < rs.nv) {
        float f[W];
        unpack<T>(cur.raw[k], f);
#pragma unroll
        for (int j = 0; j < W; ++j) {
          f[j] = __fmul_rn(f[j], rstd);
          if (affine) f[j] = __fmul_rn(f[j], g[k][j]);
        }
        yv[lane + 32 * k] = pack<T>(f);
      }
    }
    if (ei >= 0) {
      float o = __fmul_rn(cur.xe, rstd);
      if (affine) o = __fmul_rn(o, ge);
      yr[ei] = from_f<T>(o);
    }
    cur = next;
  }
}

// LayerNorm "warp": the RMSNorm warp route's rows (a warp a row, a
// persistent grid, the next row's loads issued before this row's sums,
// the head and tail elements on lanes 0-13) with `_ln_fwd_kernel`'s
// two-pass statistics taken from the registers: mean = sum(x) / N, then
// var = sum((x - mean)^2) / N, each sum this lane's values in order and
// then a butterfly of shuffles, every step rounded on its own (no fused
// multiply-add); rstd = 1 / sqrt(var + eps), y = ((x - mean) * rstd) *
// gamma + beta rounded once to T. Up to kLnFwdHoldPerLane values a lane
// (N <= 1024) gamma and beta stay in registers while the rows' 16-byte
// phase stays (N * size a multiple of 16: every row); past it they are
// read from L1 for each row, so that the two rows of x keep the
// registers.
template <typename T, int VECS>
__global__ void __launch_bounds__(kLnFwdWarpThreads)
    layernorm_fwd_warp_kernel(const T* __restrict__ x,
                              const float* __restrict__ gamma,
                              const float* __restrict__ beta,
                              T* __restrict__ y, float* __restrict__ mean_out,
                              float* __restrict__ rstd_out, int R, int N,
                              float eps) {
  constexpr int W = kVecElems<T>;
  constexpr bool kHold = VECS * W <= kLnFwdHoldPerLane;
  const int lane = threadIdx.x & 31;
  const bool affine = gamma != nullptr;
  const long warps = static_cast<long>(gridDim.x) * (blockDim.x >> 5);
  // gamma and beta at this lane's columns for rows of phase ghead (hold),
  // and at its head or tail element
  float g[kHold ? VECS : 1][W], b[kHold ? VECS : 1][W];
  float ge = 1.f, be = 0.f;
  int ghead = -1;
  bool g_aligned = false, b_aligned = false;
  long r = static_cast<long>(blockIdx.x) * (blockDim.x >> 5) +
           (threadIdx.x >> 5);
  WarpRow<T, VECS> cur;
  if (r < R) cur.load(x, r, N, lane);
  for (; r < R; r += warps) {
    WarpRow<T, VECS> next;
    if (r + warps < R) next.load(x, r + warps, N, lane);
    const RowSplit& rs = cur.rs;
    const int ei = cur.ei;
    if (affine && rs.head != ghead) {  // the same branch for the whole warp
      g_aligned = (reinterpret_cast<uintptr_t>(gamma + rs.head) & 15) == 0;
      b_aligned = (reinterpret_cast<uintptr_t>(beta + rs.head) & 15) == 0;
      if constexpr (kHold) {
#pragma unroll
        for (int k = 0; k < VECS; ++k) {
          const int v = lane + 32 * k;
          if (v < rs.nv) {
            load_gamma<W>(gamma + rs.head + v * W, g_aligned, g[k]);
            load_gamma<W>(beta + rs.head + v * W, b_aligned, b[k]);
          }
        }
      }
      ge = ei >= 0 ? gamma[ei] : 1.f;
      be = ei >= 0 ? beta[ei] : 0.f;
      ghead = rs.head;
    }
    // mean: this lane's values in order, then the butterfly
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < VECS; ++k) {
      if (lane + 32 * k < rs.nv) {
        float f[W];
        unpack<T>(cur.raw[k], f);
#pragma unroll
        for (int j = 0; j < W; ++j) s = __fadd_rn(s, f[j]);
      }
    }
    if (ei >= 0) s = __fadd_rn(s, cur.xe);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
    const float mean = __fdiv_rn(s, static_cast<float>(N));
    // var: the same order over (x - mean)^2
    float s2 = 0.f;
#pragma unroll
    for (int k = 0; k < VECS; ++k) {
      if (lane + 32 * k < rs.nv) {
        float f[W];
        unpack<T>(cur.raw[k], f);
#pragma unroll
        for (int j = 0; j < W; ++j) {
          const float d = __fsub_rn(f[j], mean);
          s2 = __fadd_rn(s2, __fmul_rn(d, d));
        }
      }
    }
    if (ei >= 0) {
      const float d = __fsub_rn(cur.xe, mean);
      s2 = __fadd_rn(s2, __fmul_rn(d, d));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      s2 = __fadd_rn(s2, __shfl_xor_sync(0xffffffffu, s2, o));
    const float rstd = __frcp_rn(__fsqrt_rn(
        __fadd_rn(__fdiv_rn(s2, static_cast<float>(N)), eps)));
    if (lane == 0) {
      mean_out[r] = mean;
      rstd_out[r] = rstd;
    }
    // y = ((x - mean) * rstd) * gamma + beta
    T* yr = y + r * N;
    uint4* yv = reinterpret_cast<uint4*>(yr + rs.head);
#pragma unroll
    for (int k = 0; k < VECS; ++k) {
      const int v = lane + 32 * k;
      if (v < rs.nv) {
        float f[W], gf[W], bf[W];
        unpack<T>(cur.raw[k], f);
        if (affine) {
          if constexpr (kHold) {
#pragma unroll
            for (int j = 0; j < W; ++j) {
              gf[j] = g[k][j];
              bf[j] = b[k][j];
            }
          } else {
            load_gamma<W>(gamma + rs.head + v * W, g_aligned, gf);
            load_gamma<W>(beta + rs.head + v * W, b_aligned, bf);
          }
        }
#pragma unroll
        for (int j = 0; j < W; ++j) {
          f[j] = __fmul_rn(__fsub_rn(f[j], mean), rstd);
          if (affine) f[j] = __fadd_rn(__fmul_rn(f[j], gf[j]), bf[j]);
        }
        yv[v] = pack<T>(f);
      }
    }
    if (ei >= 0) {
      float o = __fmul_rn(__fsub_rn(cur.xe, mean), rstd);
      if (affine) o = __fadd_rn(__fmul_rn(o, ge), be);
      yr[ei] = from_f<T>(o);
    }
    cur = next;
  }
}

// RMSNorm "block": one block a row, its vectors staged in shared memory as
// loaded (each thread rereads only the vectors it wrote)
template <typename T>
__global__ void __launch_bounds__(kLnThreads)
    rmsnorm_block_kernel(const T* __restrict__ x,
                         const float* __restrict__ gamma, T* __restrict__ y,
                         float* __restrict__ rstd_out, int N, float eps) {
  constexpr int W = kVecElems<T>;
  extern __shared__ uint4 rms_row[];
  __shared__ float red[32];
  const size_t r = blockIdx.x;
  const T* xr = x + r * N;
  const RowSplit rs = row_split(xr, N);
  const int ei = edge_elem(rs, N, threadIdx.x);
  const uint4* xv = reinterpret_cast<const uint4*>(xr + rs.head);
  float s = 0.f;
  for (int i = threadIdx.x; i < rs.nv; i += blockDim.x) {
    const uint4 u = xv[i];
    rms_row[i] = u;
    float f[W];
    unpack<T>(u, f);
#pragma unroll
    for (int j = 0; j < W; ++j) s = __fadd_rn(s, __fmul_rn(f[j], f[j]));
  }
  const float xe = ei >= 0 ? to_f(xr[ei]) : 0.f;
  if (ei >= 0) s = __fadd_rn(s, __fmul_rn(xe, xe));
  const float rstd = 1.f / sqrtf(block_reduce<false>(s, red) / N + eps);
  T* yr = y + r * N;
  uint4* yv = reinterpret_cast<uint4*>(yr + rs.head);
  const float* gr = gamma != nullptr ? gamma + rs.head : nullptr;
  const bool aligned = (reinterpret_cast<uintptr_t>(gr) & 15) == 0;
  for (int i = threadIdx.x; i < rs.nv; i += blockDim.x) {
    float f[W], g[W];
    unpack<T>(rms_row[i], f);
    if (gr != nullptr) load_gamma<W>(gr + i * W, aligned, g);
#pragma unroll
    for (int j = 0; j < W; ++j) {
      f[j] = __fmul_rn(f[j], rstd);
      if (gr != nullptr) f[j] = __fmul_rn(f[j], g[j]);
    }
    yv[i] = pack<T>(f);
  }
  if (ei >= 0) {
    float o = __fmul_rn(xe, rstd);
    if (gamma != nullptr) o = __fmul_rn(o, gamma[ei]);
    yr[ei] = from_f<T>(o);
  }
  if (threadIdx.x == 0) rstd_out[r] = rstd;
}

template <typename T>
__global__ void __launch_bounds__(kLnThreads)
    rmsnorm_bwd_kernel(const T* __restrict__ x,
                       const float* __restrict__ gamma,
                       const float* __restrict__ rstd,
                       const T* __restrict__ dy, T* __restrict__ dx,
                       float* __restrict__ dg_part, int R, int N) {
  extern __shared__ float sm[];
  float* xhat_s = sm;         // N
  float* g_s = xhat_s + N;    // N
  float* dg_s = g_s + N;      // N, affine only
  __shared__ float red[32];
  const bool affine = gamma != nullptr;
  // as in layernorm_bwd_kernel, each thread touches only its own columns
  if (affine)
    for (int i = threadIdx.x; i < N; i += blockDim.x) dg_s[i] = 0.f;
  const int r0 = blockIdx.x * kLnBwdRows;
  const int r1 = min(R, r0 + kLnBwdRows);
  for (int r = r0; r < r1; ++r) {
    const T* xr = x + (size_t)r * N;
    const T* dyr = dy + (size_t)r * N;
    const float rs = rstd[r];
    float s2 = 0.f;
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
      const float d = to_f(dyr[i]);
      const float xh = to_f(xr[i]) * rs;
      const float g = affine ? d * gamma[i] : d;
      xhat_s[i] = xh;
      g_s[i] = g;
      s2 += g * xh;
      if (affine) dg_s[i] += d * xh;
    }
    const float m2 = block_reduce<false>(s2, red) / N;
    T* dxr = dx + (size_t)r * N;
    for (int i = threadIdx.x; i < N; i += blockDim.x)
      dxr[i] = from_f<T>((g_s[i] - xhat_s[i] * m2) * rs);
  }
  if (affine)
    for (int i = threadIdx.x; i < N; i += blockDim.x)
      dg_part[(size_t)blockIdx.x * N + i] = dg_s[i];
}

template <typename T>
using RmsWarpFn = void (*)(const T*, const float*, T*, float*, int, int,
                           float);

template <typename T, int V>
RmsWarpFn<T> rms_warp_if_fits() {
  if constexpr (V * kVecElems<T> <= kRmsWarpMaxPerLane)
    return rmsnorm_warp_kernel<T, V>;
  else
    return nullptr;
}

template <typename T>
RmsWarpFn<T> rms_warp_for(int vecs) {
  switch (vecs) {
    case 1: return rms_warp_if_fits<T, 1>();
    case 2: return rms_warp_if_fits<T, 2>();
    case 4: return rms_warp_if_fits<T, 4>();
    case 8: return rms_warp_if_fits<T, 8>();
    case 16: return rms_warp_if_fits<T, 16>();
    default: return nullptr;
  }
}

template <typename T>
int launch_rmsnorm(const void* x, const float* gamma, void* y, float* rstd,
                   int R, int N, float eps, int route, int threads,
                   int blocks, int vecs, cudaStream_t stream) {
  constexpr int W = kVecElems<T>;
  // both routes read and write a row with the same 16-byte vectors
  if ((reinterpret_cast<uintptr_t>(x) ^ reinterpret_cast<uintptr_t>(y)) & 15)
    return (int)cudaErrorMisalignedAddress;
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (route == kRmsWarp) {
    RmsWarpFn<T> kernel = rms_warp_for<T>(vecs);
    if (kernel == nullptr || (N + W - 1) / W > 32 * vecs || blocks < 1 ||
        threads % 32 != 0 || threads > kRmsWarpThreads)
      return (int)cudaErrorInvalidValue;
    kernel<<<blocks, threads, 0, stream>>>(xt, gamma, yt, rstd, R, N, eps);
    return (int)cudaGetLastError();
  }
  if (route != kRmsBlock) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(uint4) * (size_t)(N / W);
  auto kernel = rmsnorm_block_kernel<T>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<R, kLnThreads, smem, stream>>>(xt, gamma, yt, rstd, N, eps);
  return (int)cudaGetLastError();
}

template <typename T>
using LnFwdWarpFn = void (*)(const T*, const float*, const float*, T*,
                             float*, float*, int, int, float);

template <typename T, int V>
LnFwdWarpFn<T> ln_fwd_warp_if_fits() {
  if constexpr (V * kVecElems<T> <= kLnFwdMaxPerLane)
    return layernorm_fwd_warp_kernel<T, V>;
  else
    return nullptr;
}

template <typename T>
LnFwdWarpFn<T> ln_fwd_warp_for(int vecs) {
  switch (vecs) {
    case 1: return ln_fwd_warp_if_fits<T, 1>();
    case 2: return ln_fwd_warp_if_fits<T, 2>();
    case 4: return ln_fwd_warp_if_fits<T, 4>();
    case 8: return ln_fwd_warp_if_fits<T, 8>();
    case 16: return ln_fwd_warp_if_fits<T, 16>();
    default: return nullptr;
  }
}

template <typename T>
int launch_layernorm(const void* x, const float* gamma, const float* beta,
                     void* y, float* mean, float* rstd, int R, int N,
                     float eps, int route, int threads, int blocks, int vecs,
                     cudaStream_t stream) {
  constexpr int W = kVecElems<T>;
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (route == kLnFwdWarp) {
    LnFwdWarpFn<T> kernel = ln_fwd_warp_for<T>(vecs);
    if (kernel == nullptr || (N + W - 1) / W > 32 * vecs || blocks < 1 ||
        threads < 32 || threads % 32 != 0 || threads > kLnFwdWarpThreads)
      return (int)cudaErrorInvalidValue;
    // y is written with x's 16-byte vectors
    if ((reinterpret_cast<uintptr_t>(x) ^ reinterpret_cast<uintptr_t>(y)) &
        15)
      return (int)cudaErrorMisalignedAddress;
    kernel<<<blocks, threads, 0, stream>>>(xt, gamma, beta, yt, mean, rstd,
                                           R, N, eps);
    return (int)cudaGetLastError();
  }
  if (route != kLnFwdBlock || threads != kLnThreads || blocks != R)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)N;
  auto kernel = layernorm_fwd_kernel<T>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<R, kLnThreads, smem, stream>>>(xt, gamma, beta, yt, mean, rstd, N,
                                          eps);
  return (int)cudaGetLastError();
}

template <typename T>
using SoftmaxRegsFn = void (*)(const T*, T*, int);

template <typename T, int V>
SoftmaxRegsFn<T> regs_if_fits() {
  if constexpr (V * kVecElems<T> <= kSoftmaxMaxPerThread)
    return softmax_regs_kernel<T, V>;
  else
    return nullptr;
}

template <typename T>
SoftmaxRegsFn<T> softmax_regs_for(int vecs) {
  switch (vecs) {
    case 1: return regs_if_fits<T, 1>();
    case 2: return regs_if_fits<T, 2>();
    case 3: return regs_if_fits<T, 3>();
    case 4: return regs_if_fits<T, 4>();
    case 5: return regs_if_fits<T, 5>();
    case 6: return regs_if_fits<T, 6>();
    case 7: return regs_if_fits<T, 7>();
    case 8: return regs_if_fits<T, 8>();
    default: return nullptr;
  }
}

// a launch of R rows on clusters of `cluster` CTAs (attr: one attribute)
inline cudaLaunchConfig_t regs_config(int R, int threads, int cluster,
                                      cudaStream_t stream,
                                      cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(R) * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  return cfg;
}

template <typename T>
int launch_softmax_regs(const T* x, T* y, int R, int N, int threads,
                        int vecs, int cluster, cudaStream_t stream) {
  constexpr int W = kVecElems<T>;
  SoftmaxRegsFn<T> kernel = softmax_regs_for<T>(vecs);
  if (kernel == nullptr || threads < 32 || threads > kSoftmaxThreads ||
      cluster < 1 || cluster > kMaxCluster ||
      ((N + W - 1) / W + cluster - 1) / cluster > threads * vecs)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) ^ reinterpret_cast<uintptr_t>(y)) & 15)
    return (int)cudaErrorMisalignedAddress;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = regs_config(R, threads, cluster, stream,
                                             &attr);
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, x, y, N);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, int LANES, int K>
int launch_rows(const T* x, T* y, int R, int N, int threads, int blocks,
                cudaStream_t stream) {
  softmax_rows_kernel<T, LANES, K><<<blocks, threads, 0, stream>>>(x, y, R,
                                                                   N);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_softmax_rows(const T* x, T* y, int R, int N, int threads,
                        int blocks, int lanes, int k, cudaStream_t stream) {
  if (lanes * k < N || blocks < 1 || threads % 32 != 0 ||
      threads > kRowsThreads)
    return (int)cudaErrorInvalidValue;
  if (k == 1) {
    switch (lanes) {
      case 1: return launch_rows<T, 1, 1>(x, y, R, N, threads, blocks, stream);
      case 2: return launch_rows<T, 2, 1>(x, y, R, N, threads, blocks, stream);
      case 4: return launch_rows<T, 4, 1>(x, y, R, N, threads, blocks, stream);
      case 8: return launch_rows<T, 8, 1>(x, y, R, N, threads, blocks, stream);
      case 16:
        return launch_rows<T, 16, 1>(x, y, R, N, threads, blocks, stream);
      case 32:
        return launch_rows<T, 32, 1>(x, y, R, N, threads, blocks, stream);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (lanes != 32) return (int)cudaErrorInvalidValue;
  switch (k) {
    case 2: return launch_rows<T, 32, 2>(x, y, R, N, threads, blocks, stream);
    case 4: return launch_rows<T, 32, 4>(x, y, R, N, threads, blocks, stream);
    case 8: return launch_rows<T, 32, 8>(x, y, R, N, threads, blocks, stream);
    case 16:
      return launch_rows<T, 32, 16>(x, y, R, N, threads, blocks, stream);
    case 32:
      return launch_rows<T, 32, 32>(x, y, R, N, threads, blocks, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_softmax(const void* x, void* y, int R, int N, int route,
                   int threads, int blocks, int per_thread, int lanes,
                   int cluster, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  switch (route) {
    case kSoftmaxRows:
      return launch_softmax_rows<T>(xt, yt, R, N, threads, blocks, lanes,
                                    per_thread, stream);
    case kSoftmaxBlock:
      return launch_softmax_regs<T>(xt, yt, R, N, threads, per_thread, 1,
                                    stream);
    case kSoftmaxCluster:
      return launch_softmax_regs<T>(xt, yt, R, N, threads, per_thread,
                                    cluster, stream);
    case kSoftmaxLoop:
      softmax_loop_kernel<T><<<R, kSoftmaxThreads, 0, stream>>>(xt, yt, N);
      return (int)cudaGetLastError();
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int max_active_clusters(int threads, int vecs, int cluster) {
  SoftmaxRegsFn<T> kernel = softmax_regs_for<T>(vecs);
  if (kernel == nullptr || cluster < 1 || cluster > kMaxCluster)
    return -(int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = regs_config(1, threads, cluster, nullptr, &attr);
  cfg.numAttrs = 1;
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

template <typename T>
using LnBwdWarpFn = void (*)(const T*, const float*, const float*,
                             const float*, const T*, T*, float*, float*, int,
                             int, int);

template <typename T, int V, bool kCenter>
LnBwdWarpFn<T> ln_bwd_warp_if_fits() {
  if constexpr (V * kVecElems<T> <= kLnBwdMaxPerLane)
    return layernorm_bwd_warp_kernel<T, V, kCenter>;
  else
    return nullptr;
}

template <typename T, bool kCenter>
LnBwdWarpFn<T> ln_bwd_warp_for(int vecs) {
  switch (vecs) {
    case 1: return ln_bwd_warp_if_fits<T, 1, kCenter>();
    case 2: return ln_bwd_warp_if_fits<T, 2, kCenter>();
    case 4: return ln_bwd_warp_if_fits<T, 4, kCenter>();
    case 8: return ln_bwd_warp_if_fits<T, 8, kCenter>();
    case 16: return ln_bwd_warp_if_fits<T, 16, kCenter>();
    default: return nullptr;
  }
}

// LayerNorm backward's warp route (kCenter) and RMSNorm's (no mean, mean
// and db_part / db null): the rows, then the column sums of dgamma (and
// dbeta) as a programmatic dependent
template <typename T, bool kCenter>
int launch_layernorm_bwd_warp(const T* x, const float* gamma,
                              const float* mean, const float* rstd,
                              const T* dy, T* dx, float* dg_part,
                              float* db_part, float* dg, float* db, int R,
                              int N, int threads, int blocks, int vecs,
                              cudaStream_t stream) {
  constexpr int W = kVecElems<T>;
  LnBwdWarpFn<T> kernel = ln_bwd_warp_for<T, kCenter>(vecs);
  const long long warps = static_cast<long long>(blocks) * (threads / 32);
  // a warp's rows must share one 16-byte phase: the stride between them,
  // warps rows, a multiple of 16 bytes
  if (kernel == nullptr || (N + W - 1) / W > 32 * vecs || blocks < 1 ||
      threads < 32 || threads % 32 != 0 || threads > kLnBwdWarpThreads ||
      (warps * N * static_cast<long long>(sizeof(T))) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  // dx is written with x's 16-byte vectors
  if ((reinterpret_cast<uintptr_t>(x) ^ reinterpret_cast<uintptr_t>(dx)) &
      15)
    return (int)cudaErrorMisalignedAddress;
  const int dy_vec =
      ((reinterpret_cast<uintptr_t>(x) ^ reinterpret_cast<uintptr_t>(dy)) &
       15) == 0;
  const size_t smem =
      gamma != nullptr ? sizeof(float) * (size_t)(threads / 32) * N : 0;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, threads, smem, stream>>>(x, gamma, mean, rstd, dy, dx,
                                            dg_part, db_part, R, N, dy_vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || gamma == nullptr) return (int)err;
  // programmatic dependent launch: the column sums are scheduled as the
  // row kernel's CTAs finish, hiding a launch's latency
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  constexpr int cols = kColSumsThreads / 32;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + cols - 1) / cols, kCenter ? 2 : 1);
  cfg.blockDim = dim3(kColSumsThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ln_column_sums_kernel,
                           static_cast<const float*>(dg_part),
                           static_cast<const float*>(db_part), blocks, N, dg,
                           db);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_layernorm_bwd(const void* x, const float* gamma, const float* mean,
                         const float* rstd, const void* dy, void* dx,
                         float* dg_part, float* db_part, float* dg, float* db,
                         int R, int N, int route, int threads, int blocks,
                         int vecs, cudaStream_t stream) {
  if (route == kLnBwdWarp)
    return launch_layernorm_bwd_warp<T, true>(
        static_cast<const T*>(x), gamma, mean, rstd,
        static_cast<const T*>(dy), static_cast<T*>(dx), dg_part, db_part, dg,
        db, R, N, threads, blocks, vecs, stream);
  if (route != kLnBwdBlock || threads != kLnThreads ||
      blocks != (R + kLnBwdRows - 1) / kLnBwdRows)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)N * (gamma != nullptr ? 4 : 2);
  auto kernel = layernorm_bwd_kernel<T>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, kLnThreads, smem, stream>>>(
      static_cast<const T*>(x), gamma, mean, rstd, static_cast<const T*>(dy),
      static_cast<T*>(dx), dg_part, db_part, R, N);
  err = cudaGetLastError();
  if (err != cudaSuccess || gamma == nullptr) return (int)err;
  column_sums_kernel<<<(N + 31) / 32, dim3(32, kReduceGroups), 0, stream>>>(
      dg_part, db_part, blocks, N, dg, db);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rmsnorm_bwd(const void* x, const float* gamma, const float* rstd,
                       const void* dy, void* dx, float* dg_part, float* dg,
                       int R, int N, int route, int threads, int blocks,
                       int vecs, cudaStream_t stream) {
  if (route == kLnBwdWarp)
    return launch_layernorm_bwd_warp<T, false>(
        static_cast<const T*>(x), gamma, nullptr, rstd,
        static_cast<const T*>(dy), static_cast<T*>(dx), dg_part, nullptr, dg,
        nullptr, R, N, threads, blocks, vecs, stream);
  if (route != kLnBwdBlock || threads != kLnThreads ||
      blocks != (R + kLnBwdRows - 1) / kLnBwdRows)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)N * (gamma != nullptr ? 3 : 2);
  auto kernel = rmsnorm_bwd_kernel<T>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, kLnThreads, smem, stream>>>(
      static_cast<const T*>(x), gamma, rstd, static_cast<const T*>(dy),
      static_cast<T*>(dx), dg_part, R, N);
  err = cudaGetLastError();
  if (err != cudaSuccess || gamma == nullptr) return (int)err;
  column_sums_kernel<<<(N + 31) / 32, dim3(32, kReduceGroups), 0, stream>>>(
      dg_part, nullptr, blocks, N, dg, nullptr);
  return (int)cudaGetLastError();
}

template <typename T, int LANES, int K>
int launch_bwd_rows(const T* y, const T* dy, T* dx, int R, int N,
                    int threads, int blocks, cudaStream_t stream) {
  softmax_bwd_rows_kernel<T, LANES, K><<<blocks, threads, 0, stream>>>(
      y, dy, dx, R, N);
  return (int)cudaGetLastError();
}

template <typename T, int LANES>
int launch_bwd_rows_k(const T* y, const T* dy, T* dx, int R, int N,
                      int threads, int blocks, int k, cudaStream_t stream) {
  switch (k) {
    case 1: return launch_bwd_rows<T, LANES, 1>(y, dy, dx, R, N, threads,
                                                blocks, stream);
    case 2: return launch_bwd_rows<T, LANES, 2>(y, dy, dx, R, N, threads,
                                                blocks, stream);
    case 4: return launch_bwd_rows<T, LANES, 4>(y, dy, dx, R, N, threads,
                                                blocks, stream);
    case 8: return launch_bwd_rows<T, LANES, 8>(y, dy, dx, R, N, threads,
                                                blocks, stream);
    case 16: return launch_bwd_rows<T, LANES, 16>(y, dy, dx, R, N, threads,
                                                  blocks, stream);
    case 32: return launch_bwd_rows<T, LANES, 32>(y, dy, dx, R, N, threads,
                                                  blocks, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_softmax_bwd_rows(const T* y, const T* dy, T* dx, int R, int N,
                            int threads, int blocks, int lanes, int k,
                            cudaStream_t stream) {
  if (lanes * k < N || blocks < 1 || threads < 32 || threads % 32 != 0 ||
      threads > kRowsThreads)
    return (int)cudaErrorInvalidValue;
  switch (lanes) {
    case 1: return launch_bwd_rows_k<T, 1>(y, dy, dx, R, N, threads, blocks,
                                           k, stream);
    case 2: return launch_bwd_rows_k<T, 2>(y, dy, dx, R, N, threads, blocks,
                                           k, stream);
    case 4: return launch_bwd_rows_k<T, 4>(y, dy, dx, R, N, threads, blocks,
                                           k, stream);
    case 8: return launch_bwd_rows_k<T, 8>(y, dy, dx, R, N, threads, blocks,
                                           k, stream);
    case 16: return launch_bwd_rows_k<T, 16>(y, dy, dx, R, N, threads,
                                             blocks, k, stream);
    case 32: return launch_bwd_rows_k<T, 32>(y, dy, dx, R, N, threads,
                                             blocks, k, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
using SoftmaxBwdRegsFn = void (*)(const T*, const T*, T*, int, int);

template <typename T>
SoftmaxBwdRegsFn<T> softmax_bwd_regs_for(int vecs) {
  static_assert(kSoftmaxBwdMaxVecs == 4, "instantiate 1..kSoftmaxBwdMaxVecs");
  switch (vecs) {
    case 1: return softmax_bwd_regs_kernel<T, 1>;
    case 2: return softmax_bwd_regs_kernel<T, 2>;
    case 3: return softmax_bwd_regs_kernel<T, 3>;
    case 4: return softmax_bwd_regs_kernel<T, 4>;
    default: return nullptr;
  }
}

template <typename T>
int launch_softmax_bwd(const void* y, const void* dy, void* dx, int R, int N,
                       int route, int threads, int blocks, int per_thread,
                       int lanes, int cluster, cudaStream_t stream) {
  constexpr int W = kVecElems<T>;
  const T* yt = static_cast<const T*>(y);
  const T* dyt = static_cast<const T*>(dy);
  T* dxt = static_cast<T*>(dx);
  if (route == kSoftmaxRows)
    return launch_softmax_bwd_rows<T>(yt, dyt, dxt, R, N, threads, blocks,
                                      lanes, per_thread, stream);
  // the vector routes write dx with y's 16-byte vectors; dy is read as
  // vectors where it shares y's phase, else element by element
  if ((reinterpret_cast<uintptr_t>(y) ^ reinterpret_cast<uintptr_t>(dx)) &
      15)
    return (int)cudaErrorMisalignedAddress;
  const int dy_vec =
      ((reinterpret_cast<uintptr_t>(y) ^ reinterpret_cast<uintptr_t>(dy)) &
       15) == 0;
  if (route == kSoftmaxLoop) {
    if (threads != kSoftmaxThreads || blocks != R)
      return (int)cudaErrorInvalidValue;
    softmax_bwd_loop_kernel<T><<<R, kSoftmaxThreads, 0, stream>>>(
        yt, dyt, dxt, N, dy_vec);
    return (int)cudaGetLastError();
  }
  if (route != kSoftmaxBlock && route != kSoftmaxCluster)
    return (int)cudaErrorInvalidValue;
  if (route == kSoftmaxBlock) cluster = 1;
  SoftmaxBwdRegsFn<T> kernel = softmax_bwd_regs_for<T>(per_thread);
  if (kernel == nullptr || threads < 32 || threads > kSoftmaxThreads ||
      threads % 32 != 0 || cluster < 1 || cluster > kMaxCluster ||
      blocks != R * cluster ||
      ((N + W - 1) / W + cluster - 1) / cluster > threads * per_thread)
    return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = regs_config(R, threads, cluster, stream,
                                             &attr);
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, yt, dyt, dxt, N, dy_vec);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// the plan's arguments (kernels/norm.py LnBwdPlan) follow the stream:
// route, threads a block, blocks (the partial rows of dgamma / dbeta),
// 16-byte vectors a lane (warp route); dg_part / db_part hold `blocks`
// rows of N
extern "C" int ff_layernorm_bwd(const void* x, const float* gamma,
                                const float* mean, const float* rstd,
                                const void* dy, void* dx, float* dg_part,
                                float* db_part, float* dg, float* db, int R,
                                int N, int dtype, void* stream, int route,
                                int threads, int blocks, int vecs) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == FF_F32)
    return launch_layernorm_bwd<float>(x, gamma, mean, rstd, dy, dx, dg_part,
                                       db_part, dg, db, R, N, route, threads,
                                       blocks, vecs, s);
  if (dtype == FF_BF16)
    return launch_layernorm_bwd<__nv_bfloat16>(
        x, gamma, mean, rstd, dy, dx, dg_part, db_part, dg, db, R, N, route,
        threads, blocks, vecs, s);
  return (int)cudaErrorInvalidValue;
}

// the plan's arguments (kernels/norm.py SoftmaxPlan, from
// softmax_bwd_plan) follow the stream, as ff_softmax_fwd's
extern "C" int ff_softmax_bwd(const void* y, const void* dy, void* dx, int R,
                              int N, int dtype, void* stream, int route,
                              int threads, int blocks, int per_thread,
                              int lanes, int cluster) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == FF_F32)
    return launch_softmax_bwd<float>(y, dy, dx, R, N, route, threads, blocks,
                                     per_thread, lanes, cluster, s);
  if (dtype == FF_BF16)
    return launch_softmax_bwd<__nv_bfloat16>(y, dy, dx, R, N, route, threads,
                                             blocks, per_thread, lanes,
                                             cluster, s);
  return (int)cudaErrorInvalidValue;
}

// the plan's arguments (kernels/norm.py LnFwdPlan) follow the stream:
// route, threads a block, blocks, 16-byte vectors a lane (warp route)
extern "C" int ff_layernorm_fwd(const void* x, const float* gamma,
                                const float* beta, void* y, float* mean,
                                float* rstd, int R, int N, float eps,
                                int dtype, void* stream, int route,
                                int threads, int blocks, int vecs) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == FF_F32)
    return launch_layernorm<float>(x, gamma, beta, y, mean, rstd, R, N, eps,
                                   route, threads, blocks, vecs, s);
  if (dtype == FF_BF16)
    return launch_layernorm<__nv_bfloat16>(x, gamma, beta, y, mean, rstd, R,
                                           N, eps, route, threads, blocks,
                                           vecs, s);
  return (int)cudaErrorInvalidValue;
}

// the plan's arguments (kernels/norm.py SoftmaxPlan) follow the stream:
// route, threads a block, blocks (rows route), values a thread (rows: K;
// block and cluster: 16-byte vectors), lanes a row (rows), cluster size
extern "C" int ff_softmax_fwd(const void* x, void* y, int R, int N, int dtype,
                              void* stream, int route, int threads,
                              int blocks, int per_thread, int lanes,
                              int cluster) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == FF_F32)
    return launch_softmax<float>(x, y, R, N, route, threads, blocks,
                                 per_thread, lanes, cluster, s);
  if (dtype == FF_BF16)
    return launch_softmax<__nv_bfloat16>(x, y, R, N, route, threads, blocks,
                                         per_thread, lanes, cluster, s);
  return (int)cudaErrorInvalidValue;
}

// clusters of the block / cluster route's kernel that fit on the card at
// once (cudaOccupancyMaxActiveClusters), or minus a CUDA error
extern "C" int ff_softmax_max_active_clusters(int threads, int vecs,
                                              int cluster, int dtype) {
  if (dtype == FF_F32) return max_active_clusters<float>(threads, vecs,
                                                         cluster);
  if (dtype == FF_BF16)
    return max_active_clusters<__nv_bfloat16>(threads, vecs, cluster);
  return -(int)cudaErrorInvalidValue;
}

// the plan's arguments (kernels/norm.py RmsNormPlan) follow the stream:
// route, threads a block, blocks (warp route), 16-byte vectors a lane
extern "C" int ff_rmsnorm_fwd(const void* x, const float* gamma, void* y,
                              float* rstd, int R, int N, float eps, int dtype,
                              void* stream, int route, int threads,
                              int blocks, int vecs) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == FF_F32)
    return launch_rmsnorm<float>(x, gamma, y, rstd, R, N, eps, route,
                                 threads, blocks, vecs, s);
  if (dtype == FF_BF16)
    return launch_rmsnorm<__nv_bfloat16>(x, gamma, y, rstd, R, N, eps, route,
                                         threads, blocks, vecs, s);
  return (int)cudaErrorInvalidValue;
}

// the plan's arguments (kernels/norm.py RmsBwdPlan) follow the stream:
// route, threads a block, blocks (the partial rows of dgamma), 16-byte
// vectors a lane (warp route); dg_part holds `blocks` rows of N
extern "C" int ff_rmsnorm_bwd(const void* x, const float* gamma,
                              const float* rstd, const void* dy, void* dx,
                              float* dg_part, float* dg, int R, int N,
                              int dtype, void* stream, int route, int threads,
                              int blocks, int vecs) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == FF_F32)
    return launch_rmsnorm_bwd<float>(x, gamma, rstd, dy, dx, dg_part, dg, R,
                                     N, route, threads, blocks, vecs, s);
  if (dtype == FF_BF16)
    return launch_rmsnorm_bwd<__nv_bfloat16>(x, gamma, rstd, dy, dx, dg_part,
                                             dg, R, N, route, threads, blocks,
                                             vecs, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ff_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
