// The optimizer update over a whole list of weight tensors in one launch,
// for Hopper (sm_90a): Adam and SGD (plain, momentum, nesterov), each
// with weight decay.
//
// Counterpart of flexflow_tpu/runtime/optimizers.py `AdamOptimizer.update`
// and `SGDOptimizer.update`, which the JAX package maps over the weight
// tree inside its jitted step, fused by XLA into a few HBM passes. It has
// no Pallas kernel. Its plain version is kernels/optimizer.py
// `adam_plain` / `sgd_plain`, a per-tensor loop of torch ops.
//
// Bound on this card: bytes. Adam reads w, g, m, v and writes w, m, v:
// 20 bytes an element with bf16 moments, 28 with f32 ones; a few dozen
// flops an element.
//
// Design: one launch covers up to kMaxTensors tensors. Their pointers and
// sizes travel BY VALUE in the kernel's argument struct (CUDA 12.1 allows
// 32 KB of kernel parameters), so no pointer table is copied from host
// memory: the launch is capturable in a CUDA graph, and new gradient
// tensors each eager step cost nothing but the argument block. The grid
// runs over (tensor, chunk) pairs: block b finds its tensor by a binary
// search of the chunk prefix sums in the struct, then walks its chunk of
// kChunk elements with 16-byte vectors (4 elements; 8 bytes for bf16
// moments), kIlp vectors of each operand in flight a thread, where every
// pointer of the tensor is aligned, and element by element where one is
// not (a view at an odd offset); the tail past the last whole vector is
// scalar.
//
// step and lr are device scalars (int32 and f32) read by every block, so
// a captured update follows a schedule's lr and the step count without a
// capture of its own: alpha_t = lr * sqrt(1 - b2^t) / (1 - b1^t), t =
// step + 1, in f32, computed once a block. The kernel never writes step;
// the caller advances it after the launch (a CTA must not write it while
// others still read it).
//
// Rounding: all math in f32 in the plain version's order, every product,
// sum, quotient and square root rounded on its own (__fmul_rn, __fadd_rn,
// __fdiv_rn, __fsqrt_rn: nvcc would contract a*b+c into an FMA), m and v
// stored round-to-nearest. So the kernel gives the plain version's bits
// on the card.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;                                // elements a vector
constexpr int kIlp = 4;                                // vectors in flight
constexpr int kStride = kThreads * kVec * kIlp;        // 4096 elements
constexpr long long kChunk = 2LL * kStride;            // a block's share

// kernel parameters past 4 KB need CUDA 12.1 (the port builds with 12.1+)
constexpr int kMaxTensors = 256;

struct TensorList {
  int count;
  int chunk_start[kMaxTensors + 1];  // prefix sums of chunks a tensor
  long long n[kMaxTensors];
  float* w[kMaxTensors];
  const float* g[kMaxTensors];
  void* m[kMaxTensors];  // Adam's m; SGD's momentum buffer
  void* v[kMaxTensors];  // Adam's v
};
static_assert(sizeof(TensorList) <= 32764, "kernel parameters over 32 KB");

struct Hyper {
  float b1, b2, omb1, omb2, eps, wd, momentum;
  const int* step;
  const float* lr;
};

__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  o[0] = t.x; o[1] = t.y; o[2] = t.z; o[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&o)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
  o[0] = __low2float(a); o[1] = __high2float(a);
  o[2] = __low2float(b); o[3] = __high2float(b);
}
__device__ __forceinline__ void store4(float* p, const float (&o)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p,
                                      const float (&o)[4]) {
  uint2 t;
  *reinterpret_cast<__nv_bfloat162*>(&t.x) =
      __halves2bfloat162(__float2bfloat16_rn(o[0]),
                         __float2bfloat16_rn(o[1]));
  *reinterpret_cast<__nv_bfloat162*>(&t.y) =
      __halves2bfloat162(__float2bfloat16_rn(o[2]),
                         __float2bfloat16_rn(o[3]));
  *reinterpret_cast<uint2*>(p) = t;
}
__device__ __forceinline__ float ld1(const float* p) { return *p; }
__device__ __forceinline__ float ld1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st1(float* p, float x) { *p = x; }
__device__ __forceinline__ void st1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// One element of Adam, in the plain version's order.
__device__ __forceinline__ void adam_elem(float& w, float g, float& m,
                                          float& v, const Hyper& h,
                                          float alpha_t) {
  if (h.wd != 0.f) g = __fadd_rn(g, __fmul_rn(h.wd, w));
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.omb2, g), g));
  w = __fsub_rn(w, __fdiv_rn(__fmul_rn(alpha_t, m),
                             __fadd_rn(__fsqrt_rn(v), h.eps)));
}

// One element of SGD: v = momentum * v + g_t; w -= lr * (nesterov ? g_t +
// momentum * v : v), or w -= lr * g_t without momentum; g_t = g + wd * w.
template <bool kMomentum, bool kNesterov>
__device__ __forceinline__ void sgd_elem(float& w, float g, float& v,
                                         const Hyper& h, float lr) {
  if (h.wd != 0.f) g = __fadd_rn(g, __fmul_rn(h.wd, w));
  float d = g;
  if (kMomentum) {
    v = __fadd_rn(__fmul_rn(h.momentum, v), g);
    d = kNesterov ? __fadd_rn(g, __fmul_rn(h.momentum, v)) : v;
  }
  w = __fsub_rn(w, __fmul_rn(lr, d));
}

// kOpt: 0 Adam, 1 SGD, 2 SGD with momentum, 3 SGD nesterov. M: the
// moments' storage type (SGD: float).
template <int kOpt, typename M>
__global__ void __launch_bounds__(kThreads)
    update_kernel(const __grid_constant__ TensorList list, const Hyper h) {
  // the tensor of this block: the last t with chunk_start[t] <= block
  const int b = blockIdx.x;
  int lo = 0, hi = list.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (list.chunk_start[mid] <= b) lo = mid; else hi = mid - 1;
  }
  const int t = lo;
  const long long n = list.n[t];
  const long long c0 = (long long)(b - list.chunk_start[t]) * kChunk;
  const long long c1 = c0 + kChunk < n ? c0 + kChunk : n;
  float* __restrict__ w = list.w[t];
  const float* __restrict__ g = list.g[t];
  M* __restrict__ m = static_cast<M*>(list.m[t]);
  M* __restrict__ v = static_cast<M*>(list.v[t]);

  __shared__ float s_scalar;
  if (threadIdx.x == 0) {
    const float lr = *h.lr;
    if (kOpt == 0) {
      const float tt = static_cast<float>(*h.step + 1);
      s_scalar = __fdiv_rn(
          __fmul_rn(lr, __fsqrt_rn(__fsub_rn(1.f, powf(h.b2, tt)))),
          __fsub_rn(1.f, powf(h.b1, tt)));
    } else {
      s_scalar = lr;
    }
  }
  __syncthreads();
  const float scalar = s_scalar;  // alpha_t (Adam) or lr (SGD)

  auto elem = [&](float& wi, float gi, float& mi, float& vi) {
    if (kOpt == 0) adam_elem(wi, gi, mi, vi, h, scalar);
    else sgd_elem<(kOpt >= 2), (kOpt == 3)>(wi, gi, mi, h, scalar);
  };
  constexpr bool kHasM = kOpt == 0 || kOpt >= 2;
  constexpr bool kHasV = kOpt == 0;

  const uintptr_t msz = sizeof(M);
  const bool vec =
      ((reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(g)) %
           16 == 0) &&
      (!kHasM || reinterpret_cast<uintptr_t>(m) % (kVec * msz) == 0) &&
      (!kHasV || reinterpret_cast<uintptr_t>(v) % (kVec * msz) == 0);
  long long scalar_from = c0;
  if (vec) {
    const long long vend = c0 + ((c1 - c0) / kVec) * kVec;
    for (long long base = c0 + threadIdx.x * kVec; base < vend;
         base += kStride) {
      float wr[kIlp][4], gr[kIlp][4], mr[kIlp][4], vr[kIlp][4];
#pragma unroll
      for (int u = 0; u < kIlp; ++u) {
        const long long i = base + (long long)u * kThreads * kVec;
        if (i < vend) {
          load4(w + i, wr[u]);
          load4(g + i, gr[u]);
          if (kHasM) load4(m + i, mr[u]);
          if (kHasV) load4(v + i, vr[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kIlp; ++u) {
        const long long i = base + (long long)u * kThreads * kVec;
        if (i < vend) {
#pragma unroll
          for (int e = 0; e < 4; ++e) elem(wr[u][e], gr[u][e], mr[u][e],
                                           vr[u][e]);
          store4(w + i, wr[u]);
          if (kHasM) store4(m + i, mr[u]);
          if (kHasV) store4(v + i, vr[u]);
        }
      }
    }
    scalar_from = vend;
  }
  for (long long i = scalar_from + threadIdx.x; i < c1; i += kThreads) {
    float wi = w[i], mi = 0.f, vi = 0.f;
    if (kHasM) mi = ld1(m + i);
    if (kHasV) vi = ld1(v + i);
    elem(wi, g[i], mi, vi);
    w[i] = wi;
    if (kHasM) st1(m + i, mi);
    if (kHasV) st1(v + i, vi);
  }
}

// Fill the list from the caller's arrays; returns the number of blocks.
int fill(TensorList& list, int count, float* const* w,
         const float* const* g, void* const* m, void* const* v,
         const long long* n) {
  list.count = count;
  int blocks = 0;
  for (int i = 0; i < count; ++i) {
    list.chunk_start[i] = blocks;
    list.n[i] = n[i];
    list.w[i] = w[i];
    list.g[i] = g[i];
    list.m[i] = m ? m[i] : nullptr;
    list.v[i] = v ? v[i] : nullptr;
    blocks += static_cast<int>((n[i] + kChunk - 1) / kChunk);
  }
  list.chunk_start[count] = blocks;
  return blocks;
}

bool valid(int count, const long long* n) {
  if (count < 1 || count > kMaxTensors) return false;
  long long chunks = 0;
  for (int i = 0; i < count; ++i) {
    if (n[i] < 1) return false;
    chunks += (n[i] + kChunk - 1) / kChunk;
  }
  return chunks <= 2147483647LL;
}

}  // namespace

// Tensors one launch takes (kernels/optimizer.py splits longer lists).
extern "C" int ff_optimizer_max_tensors() { return kMaxTensors; }

// Adam over `count` tensors: w[i], g[i] f32, m[i], v[i] in `moment_dtype`
// (FFDtype), n[i] >= 1 elements each, contiguous. step (int32) and lr
// (f32) are device scalars; step is read, not advanced.
extern "C" int ff_adam(float* const* w, const float* const* g,
                       void* const* m, void* const* v, const long long* n,
                       int count, const int* step, const float* lr,
                       float b1, float b2, float omb1, float omb2, float eps,
                       float wd, int moment_dtype, void* stream) {
  if (!valid(count, n)) return (int)cudaErrorInvalidValue;
  TensorList list;
  const int blocks = fill(list, count, w, g, m, v, n);
  const Hyper h{b1, b2, omb1, omb2, eps, wd, 0.f, step, lr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (moment_dtype == FF_F32)
    update_kernel<0, float><<<blocks, kThreads, 0, s>>>(list, h);
  else if (moment_dtype == FF_BF16)
    update_kernel<0, __nv_bfloat16><<<blocks, kThreads, 0, s>>>(list, h);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// SGD over `count` tensors (all f32): buf[i] the momentum buffers (null
// when momentum == 0); lr a device f32 scalar.
extern "C" int ff_sgd(float* const* w, const float* const* g,
                      void* const* buf, const long long* n, int count,
                      const float* lr, float momentum, int nesterov,
                      float wd, void* stream) {
  if (!valid(count, n)) return (int)cudaErrorInvalidValue;
  if ((momentum != 0.f) != (buf != nullptr)) return (int)cudaErrorInvalidValue;
  TensorList list;
  const int blocks = fill(list, count, w, g, buf, nullptr, n);
  const Hyper h{0.f, 0.f, 0.f, 0.f, 0.f, wd, momentum, nullptr, lr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (momentum == 0.f)
    update_kernel<1, float><<<blocks, kThreads, 0, s>>>(list, h);
  else if (nesterov)
    update_kernel<3, float><<<blocks, kThreads, 0, s>>>(list, h);
  else
    update_kernel<2, float><<<blocks, kThreads, 0, s>>>(list, h);
  return (int)cudaGetLastError();
}
