// Scalar sum, mean or max of a whole array, and the inclusive scan along
// the trailing axis, for Hopper (sm_90a).
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
//
// The scan (cumsum) replaces `_cumsum_call` (`_cumsum_kernel`, through
// `fused_cumsum`): x viewed as (R, N), each row's inclusive prefix sum,
// read in x's dtype, accumulated in f32 and written in x's dtype;
// `reverse` scans from the row's end (the VJP, which the TPU package
// computes by the same kernel on flipped rows). Bound on this card:
// bytes (one read and one write of x, one add an element).
//
// Design: the TPU kernel holds whole rows in VMEM and calls jnp.cumsum
// on them. Here one block of 256 threads owns a row and walks it in
// tiles of 1024 elements in scan order: a coalesced load into shared
// memory as f32, each thread's sequential scan of 4 consecutive
// elements, a warp scan of the thread totals with __shfl_up_sync, the
// 8 warp totals scanned by one warp in shared memory, then an f32
// carry across tiles. Shared memory is padded one float per 32, so
// the 4-apart reads of the per-thread scans hit 32 distinct banks.
// Rows run in parallel; one row's tiles run in order, so a single long
// row (R = 1) uses one SM: a look-back scan across blocks is later work.
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

constexpr int kScanThreads = 256;
constexpr int kScanItems = 4;
constexpr int kScanTile = kScanThreads * kScanItems;
constexpr int kScanWarps = kScanThreads / 32;

__device__ __forceinline__ int scan_pad(int i) { return i + (i >> 5); }

template <typename T>
__global__ void __launch_bounds__(kScanThreads)
    cumsum_kernel(const T* __restrict__ x, T* __restrict__ out, long long N,
                  int reverse) {
  __shared__ float tile[kScanTile + kScanTile / 32];
  __shared__ float warp_tot[kScanWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* xr = x + (size_t)blockIdx.x * N;
  T* outr = out + (size_t)blockIdx.x * N;
  float carry = 0.f;
  for (long long t0 = 0; t0 < N; t0 += kScanTile) {
    const int n = (int)(N - t0 < kScanTile ? N - t0 : kScanTile);
    // element i of the tile is the (t0 + i)-th of the row in scan order
    for (int i = threadIdx.x; i < kScanTile; i += kScanThreads) {
      float v = 0.f;
      if (i < n) v = to_f(xr[reverse ? N - 1 - (t0 + i) : t0 + i]);
      tile[scan_pad(i)] = v;
    }
    __syncthreads();
    float part[kScanItems];
    float run = 0.f;
#pragma unroll
    for (int j = 0; j < kScanItems; ++j) {
      run += tile[scan_pad(threadIdx.x * kScanItems + j)];
      part[j] = run;
    }
    // inclusive scan of the thread totals over the warp
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.f;
    if (lane == 31) warp_tot[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      float w = lane < kScanWarps ? warp_tot[lane] : 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += y;
      }
      if (lane < kScanWarps) warp_tot[lane] = w;
    }
    __syncthreads();
    const float before =
        carry + (warp > 0 ? warp_tot[warp - 1] : 0.f) + excl;
#pragma unroll
    for (int j = 0; j < kScanItems; ++j)
      tile[scan_pad(threadIdx.x * kScanItems + j)] = before + part[j];
    carry += warp_tot[kScanWarps - 1];
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += kScanThreads)
      outr[reverse ? N - 1 - (t0 + i) : t0 + i] =
          from_f<T>(tile[scan_pad(i)]);
    __syncthreads();  // the tile and warp_tot are rewritten next
  }
}

template <typename T>
int launch_cumsum(const void* x, void* out, long long R, long long N,
                  int reverse, cudaStream_t stream) {
  cumsum_kernel<T><<<(unsigned)R, kScanThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), N, reverse);
  return (int)cudaGetLastError();
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

// x, out: R rows of N contiguous elements (R <= 2^31 - 1, R, N >= 1)
extern "C" int ff_cumsum(const void* x, void* out, long long R, long long N,
                         int reverse, int dtype, void* stream) {
  if (R < 1 || N < 1 || R > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == FF_F32)
    return launch_cumsum<float>(x, out, R, N, reverse, s);
  if (dtype == FF_BF16)
    return launch_cumsum<__nv_bfloat16>(x, out, R, N, reverse, s);
  return (int)cudaErrorInvalidValue;
}
