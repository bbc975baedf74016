// Scalar sum, mean or max of a whole array, and the inclusive scan along
// the trailing axis, for Hopper (sm_90a).
//
// Replaces flexflow_tpu/kernels/pallas/reduction.py `_reduce_sum_or_max`
// (`_reduce_kernel`, through `fused_reduce`): x of any shape, f32 or bf16,
// read in its stored dtype and accumulated in f32; one f32 scalar out.
// mean is sum / max(1, n); an empty x gives 0 for sum and mean and -inf
// for max. max propagates NaN, as jnp.max does.
//
// Bound on this card: bytes (one read of x, one operation an element); at
// the loss's 4096 elements (16 KB) the launch itself.
//
// Design: the TPU kernel streams x through one persistent f32 accumulator
// over a sequential grid. Here kernels/reduction.py `reduce_plan` picks a
// route from n and the dtype alone:
//  - "cta" (x up to REDUCE_CTA_MAX_BYTES: the loss's and the accuracy's
//    4096 f32): ONE launch of one CTA of up to 1024 threads that holds the
//    whole of x. Each thread issues all its 16-byte loads (VECS vectors at
//    t, t + threads, ...; a head to x's first 16-byte boundary and a tail
//    as single elements on threads 0-13) before its first add, combines
//    them in a fixed order, and one block_combine gives the scalar, which
//    thread 0 writes finished: no partials, no second launch.
//  - "grid" (larger x): G blocks (G a function of n only, at most
//    kMaxBlocks) walk x grid-strided with 16-byte loads where x is 16-byte
//    aligned, keep four f32 accumulators a thread and reduce them over the
//    block, writing one partial; then one block adds the G partials. That
//    finishing block is a programmatic dependent launch: it is scheduled
//    as the streaming blocks retire and waits (griddepcontrol.wait) for
//    their partials, so the second launch's latency hides under the
//    first's tail. The partials live in the caller's buffer, written
//    before they are read: no counter, no memset, and two streams never
//    share state.
// Blocks on Hopper run in no order, so no route uses atomics: every launch
// configuration and every order of addition is fixed by n (and x's
// 16-byte phase), so a loss is the same bits on every run, as the TPU
// kernel's sequential grid makes it.
//
// The scan (cumsum) replaces `_cumsum_call` (`_cumsum_kernel`, through
// `fused_cumsum`): x viewed as (R, N), each row's inclusive prefix sum,
// read in x's dtype, accumulated in f32 and written in x's dtype;
// `reverse` scans from the row's end (the VJP, which the TPU package
// computes by the same kernel on flipped rows). Bound on this card:
// bytes (one read and one write of x, one add an element).
//
// Design: the TPU kernel holds whole rows in VMEM and calls jnp.cumsum
// on them. Here a block of 256 threads scans a span of a row in tiles of
// 1024 elements in scan order: a coalesced load into shared memory as
// f32 (the next tile's loads issued into registers before this tile is
// scanned), each thread's sequential scan of 4 consecutive elements, a
// warp scan of the thread totals with __shfl_up_sync, the 8 warp totals
// scanned by one warp in shared memory, then an f32 carry across tiles.
// Shared memory is padded one float per 32, so the 4-apart reads of the
// per-thread scans hit 32 distinct banks. kernels/reduction.py
// `cumsum_plan` picks the spans from the shape alone:
//  - "row" (the rows alone fill the card, or they are at most 4 tiles):
//    one block a row, the span the whole row, from a carry of 0.
//  - "split" (few long rows: (3, 1000003), (1, 2^24)): each row cut into
//    chunks of whole tiles, rows x chunks blocks (about 8 an SM). A first
//    launch writes each chunk's f32 total (thread t adds elements
//    t + 256 k from the chunk's end, then a block reduction); the scan,
//    launched as a programmatic dependent, loads its first tile, waits
//    for the totals, adds those before its chunk in a fixed order
//    (thread t the totals t, t + 256, ..., then the block's butterflies)
//    and scans its chunk from that carry. x is read twice: while the
//    rows fit in L2 (50 MB) the second read hits it, and past it the
//    chunks' starts, which the totals read last. No atomics and no look-back: every
//    carry is a sum in a fixed order, so every call gives the same bits.
// kernels/reduction.py `cumsum_split_plain` repeats both routes' adds in
// torch, to the bit.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;  // of the grid route's streaming pass
constexpr int kFinishThreads = 1024;
constexpr int kCtaMaxThreads = 1024;

enum ReduceKind { kSum = 0, kMean = 1, kMax = 2 };
// route codes shared with kernels/reduction.py REDUCE_ROUTES
enum ReduceRoute { kRouteGrid = 0, kRouteCta = 1 };

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

// 16 loaded bytes as f32 values, as load16 converts them: a "cta" thread
// holds its vectors as loaded (bf16 at 2 bytes a value: 8 vectors in 32
// registers, within the 64 a thread of 1024 may have)
__device__ __forceinline__ void widen(const uint4& u, const float*,
                                      float* out) {
  out[0] = __uint_as_float(u.x);
  out[1] = __uint_as_float(u.y);
  out[2] = __uint_as_float(u.z);
  out[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void widen(const uint4& u, const __nv_bfloat16*,
                                      float* out) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);  // bf16 widens exactly
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
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
  // the finishing block may launch once every block has written its part
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

template <bool kIsMax>
__global__ void __launch_bounds__(kFinishThreads)
    reduce_finish_kernel(const float* __restrict__ part, int P, float denom,
                         float* __restrict__ out) {
  __shared__ float red[32];
  // launched early (programmatic dependent launch): wait until the
  // streaming pass has finished and its partials are visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  float s = kIsMax ? -CUDART_INF_F : 0.f;
  for (int i = threadIdx.x; i < P; i += blockDim.x)
    s = combine<kIsMax>(s, part[i]);
  s = block_combine<kIsMax>(s, red);
  if (threadIdx.x == 0) out[0] = kIsMax ? s : s / denom;
}

// "cta": one block holds x, VECS 16-byte vectors a thread (at t, t +
// blockDim.x, ...) after a head of single elements up to x's first 16-byte
// boundary, and the tail; thread t < head + tail also takes one of those.
// Every load is issued before the first combine; each thread combines its
// values in order (vectors, then its single element), then block_combine.
template <typename T, bool kIsMax, int VECS>
__global__ void __launch_bounds__(kCtaMaxThreads)
    reduce_cta_kernel(const T* __restrict__ x, int n, float denom,
                      float* __restrict__ out) {
  __shared__ float red[32];
  constexpr int W = 16 / sizeof(T);
  const int t = threadIdx.x;
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(x) & 15);
  const int head = min(mis ? (16 - mis) / static_cast<int>(sizeof(T)) : 0,
                       n);
  const int nv = (n - head) / W;
  const int tail = n - head - nv * W;
  const uint4* xv = reinterpret_cast<const uint4*>(x + head);
  uint4 raw[VECS];
#pragma unroll
  for (int k = 0; k < VECS; ++k)
    if (t + k * blockDim.x < nv) raw[k] = xv[t + k * blockDim.x];
  const int ei = t < head ? t : (t < head + tail ? n - tail + (t - head)
                                                 : -1);
  const float xe = ei >= 0 ? to_f(x[ei]) : 0.f;
  float s = kIsMax ? -CUDART_INF_F : 0.f;
#pragma unroll
  for (int k = 0; k < VECS; ++k) {
    if (t + k * blockDim.x < nv) {
      float v[W];
      widen(raw[k], x, v);
#pragma unroll
      for (int j = 0; j < W; ++j) s = combine<kIsMax>(s, v[j]);
    }
  }
  if (ei >= 0) s = combine<kIsMax>(s, xe);
  s = block_combine<kIsMax>(s, red);
  if (t == 0) out[0] = kIsMax ? s : s / denom;
}

template <typename T, bool kIsMax>
int launch_grid(const void* x, long long n, int vec, int blocks, float* part,
                float* out, float denom, cudaStream_t stream) {
  if (blocks < 1 || blocks > kMaxBlocks) return (int)cudaErrorInvalidValue;
  reduce_partial_kernel<T, kIsMax><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), n, vec, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // programmatic dependent launch: the finishing block is scheduled while
  // the streaming pass's last blocks run, hiding a launch's latency
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1);
  cfg.blockDim = dim3(kFinishThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, reduce_finish_kernel<kIsMax>,
                           static_cast<const float*>(part), blocks, denom,
                           out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, bool kIsMax, int VECS>
int launch_cta_vecs(const void* x, int n, int threads, float* out,
                    float denom, cudaStream_t stream) {
  reduce_cta_kernel<T, kIsMax, VECS><<<1, threads, 0, stream>>>(
      static_cast<const T*>(x), n, denom, out);
  return (int)cudaGetLastError();
}

template <typename T, bool kIsMax>
int launch_cta(const void* x, long long n, int threads, int vecs,
               float* out, float denom, cudaStream_t stream) {
  constexpr int W = 16 / sizeof(T);
  // every vector of x on some thread, the head and tail (at most 2W - 2
  // elements) on threads of their own
  if (threads < 32 || threads > kCtaMaxThreads || threads % 32 != 0 ||
      n > (long long)threads * vecs * W)
    return (int)cudaErrorInvalidValue;
  const int ni = static_cast<int>(n);
  switch (vecs) {
    case 1: return launch_cta_vecs<T, kIsMax, 1>(x, ni, threads, out, denom,
                                                 stream);
    case 2: return launch_cta_vecs<T, kIsMax, 2>(x, ni, threads, out, denom,
                                                 stream);
    case 4: return launch_cta_vecs<T, kIsMax, 4>(x, ni, threads, out, denom,
                                                 stream);
    case 8: return launch_cta_vecs<T, kIsMax, 8>(x, ni, threads, out, denom,
                                                 stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, bool kIsMax>
int launch_route(const void* x, long long n, int vec, int route,
                 int threads, int blocks, int vecs, float* part, float* out,
                 float denom, cudaStream_t stream) {
  if (route == kRouteCta)
    return launch_cta<T, kIsMax>(x, n, threads, vecs, out, denom, stream);
  if (route == kRouteGrid)
    return launch_grid<T, kIsMax>(x, n, vec, blocks, part, out, denom,
                                  stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch_kind(const void* x, long long n, int vec, int kind, int route,
                  int threads, int blocks, int vecs, float* part, float* out,
                  cudaStream_t stream) {
  // mean divides by max(1, n), as `s / max(1, x.size)`
  const float denom = kind == kMean ? (float)(n > 1 ? n : 1) : 1.f;
  if (kind == kMax)
    return launch_route<T, true>(x, n, vec, route, threads, blocks, vecs,
                                 part, out, denom, stream);
  if (kind == kSum || kind == kMean)
    return launch_route<T, false>(x, n, vec, route, threads, blocks, vecs,
                                  part, out, denom, stream);
  return (int)cudaErrorInvalidValue;
}

constexpr int kScanThreads = 256;
constexpr int kScanItems = 4;
constexpr int kScanTile = kScanThreads * kScanItems;
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kMaxChunks = kScanThreads * 4;  // totals a scan block adds
constexpr int kTotalBatch = 8;                // loads a thread has in flight

// route codes shared with kernels/reduction.py CUMSUM_ROUTES
enum ScanRoute { kScanRow = 0, kScanSplit = 1 };

__device__ __forceinline__ int scan_pad(int i) { return i + (i >> 5); }

// The row's element at scan position g (from its end when reversed)
__device__ __forceinline__ long long scan_at(long long N, long long g,
                                             int reverse) {
  return reverse ? N - 1 - g : g;
}

// this thread's elements of the tile at scan position g0 (n of them
// valid; zeros past them)
template <typename T>
__device__ __forceinline__ void scan_load(const T* __restrict__ xr,
                                          long long N, long long g0, int n,
                                          int reverse,
                                          float (&v)[kScanItems]) {
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    const int i = threadIdx.x + k * kScanThreads;
    v[k] = i < n ? to_f(xr[scan_at(N, g0 + i, reverse)]) : 0.f;
  }
}

// Scan `len` elements of a row from scan position g0 and carry, `v` this
// thread's elements of the first tile, loaded
template <typename T>
__device__ __forceinline__ void scan_span(const T* __restrict__ xr,
                                          T* __restrict__ outr, long long N,
                                          long long g0, long long len,
                                          int reverse, float carry,
                                          float (&v)[kScanItems],
                                          float* tile, float* warp_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (long long t0 = 0; t0 < len; t0 += kScanTile) {
    const int n = (int)(len - t0 < kScanTile ? len - t0 : kScanTile);
    // element i of the tile is the (g0 + t0 + i)-th of the row in scan
    // order
#pragma unroll
    for (int k = 0; k < kScanItems; ++k)
      tile[scan_pad(threadIdx.x + k * kScanThreads)] = v[k];
    __syncthreads();
    if (t0 + kScanTile < len) {  // the next tile's loads, in flight
      const long long rest = len - t0 - kScanTile;
      scan_load(xr, N, g0 + t0 + kScanTile,
                (int)(rest < kScanTile ? rest : kScanTile), reverse, v);
    }
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
      outr[scan_at(N, g0 + t0 + i, reverse)] = from_f<T>(tile[scan_pad(i)]);
    __syncthreads();  // the tile and warp_tot are rewritten next
  }
}

// "row": one block a row, the whole row from a carry of 0; 8 blocks an
// SM (32 registers: the next tile's loads took bf16 from 26 to 35, 7
// blocks an SM, 3% slower at (4096, 1024) on an H100)
template <typename T>
__global__ void __launch_bounds__(kScanThreads, 8)
    cumsum_kernel(const T* __restrict__ x, T* __restrict__ out, long long N,
                  int reverse) {
  __shared__ float tile[kScanTile + kScanTile / 32];
  __shared__ float warp_tot[kScanWarps];
  const T* xr = x + (size_t)blockIdx.x * N;
  T* outr = out + (size_t)blockIdx.x * N;
  float v[kScanItems];
  scan_load(xr, N, 0, (int)(N < kScanTile ? N : kScanTile), reverse, v);
  scan_span(xr, outr, N, 0, N, reverse, 0.f, v, tile, warp_tot);
}

// "split", first launch: block b = row * chunks + j writes chunk j's
// total, thread t adding elements t + 256 k of it from the last k down to
// k = 0 (loads kTotalBatch at a time), then block_combine. From the end:
// a row past L2 (50 MB) then leaves each chunk's start in L2, where the
// scan reads it first
template <typename T>
__global__ void __launch_bounds__(kScanThreads)
    cumsum_totals_kernel(const T* __restrict__ x, long long N,
                         long long chunk, int chunks, int reverse,
                         float* __restrict__ totals) {
  __shared__ float red[32];
  const long long row = blockIdx.x / chunks;
  const long long g0 = (blockIdx.x % chunks) * chunk;
  const long long len = N - g0 < chunk ? N - g0 : chunk;
  const T* xr = x + row * N;
  float s = 0.f;
  for (long long k0 = (len - 1) / kScanThreads; k0 >= 0; k0 -= kTotalBatch) {
    float v[kTotalBatch];
#pragma unroll
    for (int b = 0; b < kTotalBatch; ++b) {
      const long long i = threadIdx.x + (k0 - b) * kScanThreads;
      v[b] = k0 - b >= 0 && i < len
                 ? to_f(xr[scan_at(N, g0 + i, reverse)]) : 0.f;
    }
#pragma unroll
    for (int b = 0; b < kTotalBatch; ++b) s += v[b];  // + 0 past the ends
  }
  s = block_combine<false>(s, red);
  if (threadIdx.x == 0) totals[blockIdx.x] = s;
  // the scan may launch once every block has written its total
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// "split", second launch (a programmatic dependent of the first): the
// chunk's carry, the sum of the totals before it in a fixed order, then
// the chunk's scan (loading two tiles ahead spilled under 32 registers:
// this kernel 16% slower at (1, 2^24) on an H100)
template <typename T>
__global__ void __launch_bounds__(kScanThreads)
    cumsum_chunk_kernel(const T* __restrict__ x, T* __restrict__ out,
                        long long N, long long chunk, int chunks,
                        int reverse, const float* __restrict__ totals) {
  __shared__ float tile[kScanTile + kScanTile / 32];
  __shared__ float warp_tot[kScanWarps];
  __shared__ float red[32];
  const long long row = blockIdx.x / chunks;
  const int j = blockIdx.x % chunks;
  const long long g0 = (long long)j * chunk;
  const long long len = N - g0 < chunk ? N - g0 : chunk;
  const T* xr = x + row * N;
  T* outr = out + row * N;
  // x is no output of the first launch: the first tile's loads go out
  // before the wait
  float v[kScanItems];
  scan_load(xr, N, g0, (int)(len < kScanTile ? len : kScanTile), reverse, v);
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const float* tr = totals + row * chunks;
  float t[kMaxChunks / kScanThreads];
#pragma unroll
  for (int b = 0; b < kMaxChunks / kScanThreads; ++b) {
    const int i = threadIdx.x + b * kScanThreads;
    t[b] = i < j ? tr[i] : 0.f;
  }
  float c = 0.f;
#pragma unroll
  for (int b = 0; b < kMaxChunks / kScanThreads; ++b) c += t[b];
  c = block_combine<false>(c, red);
  if (threadIdx.x == 0) red[0] = c;  // block_combine's last read is done
  __syncthreads();
  c = red[0];
  scan_span(xr, outr, N, g0, len, reverse, c, v, tile, warp_tot);
}

template <typename T>
int launch_cumsum(const void* x, void* out, long long R, long long N,
                  int reverse, int route, long long chunk, int chunks,
                  float* totals, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (route == kScanRow) {
    cumsum_kernel<T><<<(unsigned)R, kScanThreads, 0, stream>>>(xt, ot, N,
                                                               reverse);
    return (int)cudaGetLastError();
  }
  // whole tiles, every element in a chunk, at most kMaxChunks a row
  if (route != kScanSplit || totals == nullptr || chunks < 2 ||
      chunks > kMaxChunks || chunk < 1 || chunk % kScanTile != 0 ||
      (chunks - 1) * chunk >= N || chunks * chunk < N ||
      R * chunks > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)(R * chunks);
  cumsum_totals_kernel<T><<<grid, kScanThreads, 0, stream>>>(
      xt, N, chunk, chunks, reverse, totals);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // programmatic dependent launch: the scan's blocks are scheduled as the
  // totals' blocks finish, and load their first tile before they wait
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kScanThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, cumsum_chunk_kernel<T>, xt, ot, N, chunk,
                           chunks, reverse,
                           static_cast<const float*>(totals));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// x: n contiguous elements; vec: x is 16-byte aligned (grid route); part:
// room for `blocks` floats (grid route; unused on "cta"); out: one float.
// The plan's arguments (kernels/reduction.py ReducePlan) follow the
// stream: route, threads a block (cta), blocks (grid), 16-byte vectors a
// thread (cta).
extern "C" int ff_reduce(const void* x, long long n, int vec, int kind,
                         float* part, float* out, int dtype, void* stream,
                         int route, int threads, int blocks, int vecs) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == FF_F32)
    return dispatch_kind<float>(x, n, vec, kind, route, threads, blocks,
                                vecs, part, out, s);
  if (dtype == FF_BF16)
    return dispatch_kind<__nv_bfloat16>(x, n, vec, kind, route, threads,
                                        blocks, vecs, part, out, s);
  return (int)cudaErrorInvalidValue;
}

// x, out: R rows of N contiguous elements (R <= 2^31 - 1, R, N >= 1).
// The plan's arguments (kernels/reduction.py CumsumPlan) follow the
// stream: route, chunk (elements a block scans), chunks (blocks a row);
// totals: room for R x chunks floats ("split"; unused on "row").
extern "C" int ff_cumsum(const void* x, void* out, long long R, long long N,
                         int reverse, int dtype, void* stream, int route,
                         long long chunk, int chunks, float* totals) {
  if (R < 1 || N < 1 || R > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == FF_F32)
    return launch_cumsum<float>(x, out, R, N, reverse, route, chunk, chunks,
                                totals, s);
  if (dtype == FF_BF16)
    return launch_cumsum<__nv_bfloat16>(x, out, R, N, reverse, route, chunk,
                                        chunks, totals, s);
  return (int)cudaErrorInvalidValue;
}
