// LayerNorm forward and softmax forward over the trailing axis, for Hopper
// (sm_90a).
//
// layernorm_fwd replaces flexflow_tpu/kernels/pallas/norm.py `_ln_fwd`
// (`_ln_fwd_kernel`): per row, f32 mean, var = mean((x - mean)^2),
// rstd = 1 / sqrt(var + eps), y = (x - mean) * rstd [* gamma + beta] in
// x's dtype, plus the f32 mean and rstd the backward needs.
// softmax_fwd replaces `_softmax_call` with `_softmax_fwd_kernel`: per row,
// f32 max, e = exp(x - max), y = e / sum(e) in x's dtype.
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
#include "common.cuh"

namespace {

constexpr int kLnThreads = 256;
constexpr int kSoftmaxThreads = 1024;

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

}  // namespace

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

extern "C" const char* ff_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
