// Scalar sum, mean or max of a whole array, for Hopper (sm_90a).
//
// Replaces flexflow_tpu/kernels/pallas/reduction.py `_reduce_sum_or_max`
// (`_reduce_kernel`, through `fused_reduce`): x of any shape, f32 or bf16,
// read in its stored dtype and accumulated in f32; one f32 scalar out.
// mean is sum / max(1, n); an empty x gives 0 for sum and mean and -inf
// for max. max propagates NaN, as jnp.max does.
//
// Bound on this card: bytes (one read of x, one operation an element).
//
// Design: the TPU kernel streams x through one persistent f32 accumulator
// over a sequential grid. Blocks on Hopper run in no order, so this is two
// launches and no atomics: a streaming pass where each of G blocks (G a
// function of n only, at most kMaxBlocks) walks x grid-strided with
// 16-byte loads where x is 16-byte aligned, keeps four f32 accumulators a
// thread and reduces them over the block, writing one partial; then one
// block adds the G partials. Every launch configuration and every order
// of addition is fixed by n, so a loss is the same bits on every run, as
// the TPU kernel's sequential grid makes it.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;
constexpr int kFinishThreads = 1024;
// elements a block of the streaming pass takes before a second block is
// worth launching
constexpr long long kBlockElems = 16LL * kThreads;

enum ReduceKind { kSum = 0, kMean = 1, kMax = 2 };

template <bool kIsMax>
__device__ __forceinline__ float combine(float a, float b) {
  if (kIsMax) return (a != a || a > b) ? a : b;  // NaN wins, as jnp.max
  return a + b;
}

// v combined over the block (blockDim.x a multiple of 32); thread 0 gets
// the result. Butterfly shuffles in a fixed pattern: a fixed order.
template <bool kIsMax>
__device__ __forceinline__ float block_combine(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int o = 16; o > 0; o >>= 1)
    v = combine<kIsMax>(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = lane < nwarps ? red[lane] : (kIsMax ? -CUDART_INF_F : 0.f);
  for (int o = 16; o > 0; o >>= 1)
    r = combine<kIsMax>(r, __shfl_xor_sync(0xffffffffu, r, o));
  return r;
}

// 16 bytes of x as f32 values: 4 of f32, 8 of bf16
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    out[2 * k] = f.x;
    out[2 * k + 1] = f.y;
  }
}

template <typename T, bool kIsMax>
__global__ void __launch_bounds__(kThreads)
    reduce_partial_kernel(const T* __restrict__ x, long long n, int vec,
                          float* __restrict__ part) {
  __shared__ float red[32];
  constexpr int kVec = 16 / sizeof(T);
  const float id = kIsMax ? -CUDART_INF_F : 0.f;
  float acc[4] = {id, id, id, id};
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long head = 0;
  if (vec) {
    const long long nv = n / kVec;
    float v[kVec];
    for (long long i = tid; i < nv; i += stride) {
      load16(x + i * kVec, v);
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        acc[j & 3] = combine<kIsMax>(acc[j & 3], v[j]);
    }
    head = nv * kVec;
  }
  for (long long i = head + tid; i < n; i += stride)
    acc[0] = combine<kIsMax>(acc[0], to_f(x[i]));
  float s = combine<kIsMax>(combine<kIsMax>(acc[0], acc[1]),
                            combine<kIsMax>(acc[2], acc[3]));
  s = block_combine<kIsMax>(s, red);
  if (threadIdx.x == 0) part[blockIdx.x] = s;
}

template <bool kIsMax>
__global__ void __launch_bounds__(kFinishThreads)
    reduce_finish_kernel(const float* __restrict__ part, int P, float denom,
                         float* __restrict__ out) {
  __shared__ float red[32];
  float s = kIsMax ? -CUDART_INF_F : 0.f;
  for (int i = threadIdx.x; i < P; i += blockDim.x)
    s = combine<kIsMax>(s, part[i]);
  s = block_combine<kIsMax>(s, red);
  if (threadIdx.x == 0) out[0] = kIsMax ? s : s / denom;
}

int blocks_for(long long n) {
  long long g = (n + kBlockElems - 1) / kBlockElems;
  if (g < 1) g = 1;
  if (g > kMaxBlocks) g = kMaxBlocks;
  return (int)g;
}

template <typename T, bool kIsMax>
int launch_reduce(const void* x, long long n, int vec, float* part,
                  float* out, float denom, cudaStream_t stream) {
  const int blocks = blocks_for(n);
  reduce_partial_kernel<T, kIsMax><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), n, vec, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_finish_kernel<kIsMax><<<1, kFinishThreads, 0, stream>>>(
      part, blocks, denom, out);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_kind(const void* x, long long n, int vec, int kind, float* part,
                  float* out, cudaStream_t stream) {
  // mean divides by max(1, n), as `s / max(1, x.size)`
  const float denom = kind == kMean ? (float)(n > 1 ? n : 1) : 1.f;
  if (kind == kMax)
    return launch_reduce<T, true>(x, n, vec, part, out, denom, stream);
  if (kind == kSum || kind == kMean)
    return launch_reduce<T, false>(x, n, vec, part, out, denom, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int ff_reduce_blocks(long long n) { return blocks_for(n); }

// x: n contiguous elements; vec: x is 16-byte aligned; part: room for
// ff_reduce_blocks(n) floats; out: one float
extern "C" int ff_reduce(const void* x, long long n, int vec, int kind,
                         float* part, float* out, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == FF_F32)
    return dispatch_kind<float>(x, n, vec, kind, part, out, s);
  if (dtype == FF_BF16)
    return dispatch_kind<__nv_bfloat16>(x, n, vec, kind, part, out, s);
  return (int)cudaErrorInvalidValue;
}
