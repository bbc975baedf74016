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
// Design: one block per row, all statistics reduced in f32 with warp
// shuffles. LayerNorm stages its row in shared memory as f32 (N = 1024 on
// the serving path: 4 KB), so device memory is read once. Softmax rows are
// the vocabulary (30522 wide): it loops over the row three times — max,
// sum, write — and relies on L2 (50 MB) for the second and third reads
// instead of holding the row in shared memory. Plain loads and stores;
// vectorised and multi-row variants are later work.
//
// The backward kernels are bound by bytes too. LayerNorm backward gives
// each block kLnBwdRows rows: the row's xhat and g sit in shared memory
// between the two reductions and the dx pass, and each thread sums dgamma
// and dbeta for its own columns over the block's rows; a second launch
// adds the blocks' partial sums column by column in a fixed order — no
// float atomics, so the sums are the same on every run. Softmax backward
// gives each row one warp: at the classifier's N = 2 it is bound by launch
// latency, not by bytes. RMSNorm is LayerNorm without the mean: its
// forward holds the row in shared memory like layernorm_fwd, and its
// backward takes layernorm_bwd's shape (kLnBwdRows rows a block, column
// partials of dgamma, a second launch summing them in a fixed order).
#include "common.cuh"

namespace {

constexpr int kLnThreads = 256;
constexpr int kSoftmaxThreads = 1024;
constexpr int kLnBwdRows = 8;        // rows per block of layernorm_bwd
constexpr int kReduceGroups = 16;    // partial-sum groups per column
constexpr int kSoftmaxBwdThreads = 256;  // 8 rows per block, a warp each

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

template <typename T>
__global__ void __launch_bounds__(kSoftmaxThreads)
    softmax_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, int N) {
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

template <typename T>
__global__ void __launch_bounds__(kSoftmaxBwdThreads)
    softmax_bwd_kernel(const T* __restrict__ y, const T* __restrict__ dy,
                       T* __restrict__ dx, int R, int N) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= R) return;  // whole warps: the shuffles below stay full
  const T* yr = y + (size_t)row * N;
  const T* dyr = dy + (size_t)row * N;
  float s = 0.f;
  for (int i = lane; i < N; i += 32) s += to_f(yr[i]) * to_f(dyr[i]);
  s = warp_sum(s);
  T* dxr = dx + (size_t)row * N;
  for (int i = lane; i < N; i += 32)
    dxr[i] = from_f<T>(to_f(yr[i]) * (to_f(dyr[i]) - s));
}

template <typename T>
__global__ void __launch_bounds__(kLnThreads)
    rmsnorm_fwd_kernel(const T* __restrict__ x,
                       const float* __restrict__ gamma, T* __restrict__ y,
                       float* __restrict__ rstd_out, int N, float eps) {
  extern __shared__ float row[];
  __shared__ float red[32];
  const size_t r = blockIdx.x;
  const T* xr = x + r * N;
  float s = 0.f;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const float v = to_f(xr[i]);
    row[i] = v;  // each thread rereads only the elements it wrote
    s += v * v;
  }
  const float ms = block_reduce<false>(s, red) / N;
  const float rstd = 1.f / sqrtf(ms + eps);
  T* yr = y + r * N;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    float v = row[i] * rstd;
    if (gamma != nullptr) v *= gamma[i];
    yr[i] = from_f<T>(v);
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
int launch_rmsnorm(const void* x, const float* gamma, void* y, float* rstd,
                   int R, int N, float eps, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)N;
  auto kernel = rmsnorm_fwd_kernel<T>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<R, kLnThreads, smem, stream>>>(static_cast<const T*>(x), gamma,
                                          static_cast<T*>(y), rstd, N, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rmsnorm_bwd(const void* x, const float* gamma, const float* rstd,
                       const void* dy, void* dx, float* dg_part, float* dg,
                       int R, int N, cudaStream_t stream) {
  const int blocks = (R + kLnBwdRows - 1) / kLnBwdRows;
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

template <typename T>
int launch_layernorm(const void* x, const float* gamma, const float* beta,
                     void* y, float* mean, float* rstd, int R, int N,
                     float eps, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)N;
  auto kernel = layernorm_fwd_kernel<T>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<R, kLnThreads, smem, stream>>>(static_cast<const T*>(x), gamma,
                                          beta, static_cast<T*>(y), mean,
                                          rstd, N, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_softmax(const void* x, void* y, int R, int N, cudaStream_t stream) {
  softmax_fwd_kernel<T><<<R, kSoftmaxThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), N);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_layernorm_bwd(const void* x, const float* gamma, const float* mean,
                         const float* rstd, const void* dy, void* dx,
                         float* dg_part, float* db_part, float* dg, float* db,
                         int R, int N, cudaStream_t stream) {
  const int blocks = (R + kLnBwdRows - 1) / kLnBwdRows;
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
int launch_softmax_bwd(const void* y, const void* dy, void* dx, int R, int N,
                       cudaStream_t stream) {
  constexpr int rows_per_block = kSoftmaxBwdThreads / 32;
  softmax_bwd_kernel<T>
      <<<(R + rows_per_block - 1) / rows_per_block, kSoftmaxBwdThreads, 0,
         stream>>>(static_cast<const T*>(y), static_cast<const T*>(dy),
                   static_cast<T*>(dx), R, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ff_layernorm_bwd_rows_per_block() { return kLnBwdRows; }

extern "C" int ff_layernorm_bwd(const void* x, const float* gamma,
                                const float* mean, const float* rstd,
                                const void* dy, void* dx, float* dg_part,
                                float* db_part, float* dg, float* db, int R,
                                int N, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == FF_F32)
    return launch_layernorm_bwd<float>(x, gamma, mean, rstd, dy, dx, dg_part,
                                       db_part, dg, db, R, N, s);
  if (dtype == FF_BF16)
    return launch_layernorm_bwd<__nv_bfloat16>(x, gamma, mean, rstd, dy, dx,
                                               dg_part, db_part, dg, db, R,
                                               N, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int ff_softmax_bwd(const void* y, const void* dy, void* dx, int R,
                              int N, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == FF_F32) return launch_softmax_bwd<float>(y, dy, dx, R, N, s);
  if (dtype == FF_BF16)
    return launch_softmax_bwd<__nv_bfloat16>(y, dy, dx, R, N, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int ff_layernorm_fwd(const void* x, const float* gamma,
                                const float* beta, void* y, float* mean,
                                float* rstd, int R, int N, float eps,
                                int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == FF_F32)
    return launch_layernorm<float>(x, gamma, beta, y, mean, rstd, R, N, eps,
                                   s);
  if (dtype == FF_BF16)
    return launch_layernorm<__nv_bfloat16>(x, gamma, beta, y, mean, rstd, R,
                                           N, eps, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int ff_softmax_fwd(const void* x, void* y, int R, int N, int dtype,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == FF_F32) return launch_softmax<float>(x, y, R, N, s);
  if (dtype == FF_BF16) return launch_softmax<__nv_bfloat16>(x, y, R, N, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int ff_rmsnorm_fwd(const void* x, const float* gamma, void* y,
                              float* rstd, int R, int N, float eps, int dtype,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == FF_F32)
    return launch_rmsnorm<float>(x, gamma, y, rstd, R, N, eps, s);
  if (dtype == FF_BF16)
    return launch_rmsnorm<__nv_bfloat16>(x, gamma, y, rstd, R, N, eps, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int ff_rmsnorm_bwd(const void* x, const float* gamma,
                              const float* rstd, const void* dy, void* dx,
                              float* dg_part, float* dg, int R, int N,
                              int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == FF_F32)
    return launch_rmsnorm_bwd<float>(x, gamma, rstd, dy, dx, dg_part, dg, R,
                                     N, s);
  if (dtype == FF_BF16)
    return launch_rmsnorm_bwd<__nv_bfloat16>(x, gamma, rstd, dy, dx, dg_part,
                                             dg, R, N, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ff_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
