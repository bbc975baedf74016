// Decode attention over the slot-dense KV cache, for Hopper (sm_90a).
//
// Replaces flexflow_tpu/kernels/pallas/decode.py `_call_decode` (both
// entries: fused_decode_attention, C = 1, and
// fused_multiquery_decode_attention, C >= 1). Per slot b and head h, query
// j sits at position pos[b] + j and attends cache rows
// k_pos < M && k_pos <= pos[b] + j:
//     s = q.k * scale (f32), masked s = -1e30, softmax over the span with
//     f32 m / l / acc, out in q's dtype, the l == 0 -> 1 guard kept.
// Two op orders, as in the TPU kernel:
//   - "single" (M <= block_k, the TPU kernel's one cache block): the
//     row's final max and sum first, then (p / l) rounded to q's dtype
//     before p.v — the einsum chain's order, so greedy decode stays
//     token-identical to it;
//   - split (M > block_k): an online softmax, the unnormalised p rounded
//     to q's dtype before p.v, acc / l at the end.
//
// Bound on this card: bytes. Each (b, h) reads the cache rows its queries
// may attend once, 2 * rows * d * sizeof(stored) bytes, against 2 * C *
// rows * d multiply-adds: 0.25 operations per byte at C = 1 and 4 at
// C = 16, far below the ~295 at which bf16 tensor cores become the
// limit. So the design is about bytes in flight on every SM.
//
// Design. The plan (kernels/decode.py `decode_plan`, from shapes and
// dtypes alone: it never reads pos) cuts the cache into `splits` spans of
// `split_rows` rows. The grid is (query tiles x splits, heads, slots); a
// block takes 16 queries (one m16 tile) of one (slot, head) over one
// span, stops at the last row its queries may attend (pos[b] + j0 + nq -
// 1), and writes f32 partials (m, l, acc) to a scratch the wrapper
// allocates; a split that starts past that row writes m = -1e30, l = 0
// and returns. A second launch, a block per few query rows of one (query
// tile, head, slot), merges the partials:
//     out = sum e^(m_s - m*) acc_s / sum e^(m_s - m*) l_s.
// With one split (single, or M <= split_rows) the block writes out itself
// and there is no second launch. Two routes, chosen by the plan:
//   - tc (q and both caches bf16, d a multiple of 8 up to 256, base
//     addresses 16-byte aligned): 4 warps, each owning 16 cache rows of
//     every 64-row tile. Q, then K and V tiles arrive in bf16 through
//     `cp.async.cg` 16-byte copies into a ring of up to 3 stages (rows
//     padded by 16 bytes so that `ldmatrix` is free of bank conflicts;
//     rows past the span zero-filled); the next tile's copy is issued
//     before the current tile's arithmetic. S = Q Kᵀ and O += P V
//     are `mma.sync.m16n8k16` (bf16 in, f32 accumulate): Q and K through
//     `ldmatrix`, V through `ldmatrix.trans`, P taken from the S
//     accumulators and packed to bf16 pairs as the A fragment. The online
//     softmax stays in registers (row max and sum across the quad by
//     `__shfl_xor_sync`, exp2f on scores pre-scaled by log2 e); each warp
//     keeps its own (m, l, acc), merged through shared memory at the end.
//     At C = 1 the m16 tile has 15 zero rows: free, the kernel waits on
//     memory. `wgmma` is not used: its 64-row tiles would be 3/4 (C = 16)
//     or 63/64 (C = 1) empty, and the work sits ~70x below the ridge.
//   - cc (everything else, f32 operands included: tensor-core f32 is TF32,
//     short of the f32 tolerances): 128 threads stage f32 tiles of
//     `tile_k` rows through shared memory and run f32 FMA in the TPU
//     kernel's order, on the same split grid and combine.
// Single in both routes: a first pass over the span takes each row's max
// and sum (K only), a second computes (p / l) and p.v.
//
// Tuned on an H100 80GB HBM3 (700 W) with flexflow_tpu_torch/tools/
// decode_bench.py --sweep (bf16, 16 heads of 64, M = 1024): split_rows =
// M / 8 rounded up to a multiple of 64 (at least 64), so M = 1024 gives 8
// splits of 128 rows (128 blocks for the B = 1, C = 16 prefill chunk, 1024
// at B = 8). 16 splits of 64 rows took 5-11% longer, splits of 32 rows
// 33-62% longer, 4 of 256 rows 5% longer on the chunk (4% shorter on the
// B = 8, C = 16 batch). Ring stages: min(3, tiles per split). The combine
// is launched as a programmatic dependent of the split kernel (3-7% of a
// call), so its blocks are scheduled while the split kernel's last blocks
// run.
// ptxas (sm_90a, CUDA 12.8), registers per thread, no stack or spills:
// decode_tc_kernel<16>, <32> 64, <64> 80, <128> 128, <256> 237;
// decode_cc_kernel 62-64; decode_combine_kernel 40. Dynamic shared memory:
// tc 32 (kDP + 8) bytes of queries, 256 (kDP + 8) per ring stage, 512 of
// row stats (39 KB at d = 64 with 2 stages); cc 4 ((q_tile + 2 tile_k)
// (d + 1) + q_tile (tile_k + d + 3)) bytes (45 KB at d = 64, C = 16);
// combine 4 rpb (splits + 1) bytes.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kQTile = 16;         // queries per block; rows per partial
constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF, not -inf
constexpr float kLog2e = 1.4426950408889634f;

// Per-block partial results of the split path, f32:
//   ml  [part][2][kQTile]: the row max m, then the row sum l;
//   acc [part][kQTile][D]: the unnormalised p.v;
// part = ((b * H + h) * q_tiles + query tile) * splits + split.
struct Partials {
  float* ml;
  float* acc;
};

// rows [0, span) hold everything a query tile may attend
__device__ __forceinline__ int attended_span(int p0, int j0, int nq, int M) {
  const long long last = (long long)p0 + j0 + nq;
  return (int)(last < 0 ? 0 : (last < M ? last : M));
}

// A block with no row to read: an empty partial (m = -1e30, l = 0) where
// a combine follows, else zero output rows (a span of no rows, which only
// a negative position gives).
template <typename QT>
__device__ void finish_empty(Partials part, size_t part_id, QT* out,
                             size_t out_row0, size_t out_row_stride,
                             int nq, int D, int splits) {
  if (splits > 1) {
    for (int r = threadIdx.x; r < nq; r += kThreads) {
      part.ml[part_id * 2 * kQTile + r] = kNegInf;
      part.ml[part_id * 2 * kQTile + kQTile + r] = 0.f;
    }
    return;
  }
  for (int i = threadIdx.x; i < nq * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    out[out_row0 + r * out_row_stride + c] = from_f<QT>(0.f);
  }
}

// =========================================================================
// tc route: bf16 on the tensor cores
// =========================================================================
namespace tc {

constexpr int kTileK = 64;  // cache rows per ring stage, 16 per warp
constexpr int kMaxStages = 3;
using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices; lane i gives the row address of matrix i / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared, zero-filled when !valid (src must still be a
// mapped address)
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n (0..kMaxStages - 1) groups are in flight
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n <= 0)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else if (n == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo: the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Shared memory of one block: the query tile, the ring (rows contiguous
// with the query tile's), then the per-warp row stats of the single path.
// Rows are kDP + 8 bf16: 16 bytes of pad put the 8 rows an `ldmatrix`
// reads on 8 distinct 4-bank groups.
template <int kDP>
struct Layout {
  static constexpr int kLd = kDP + 8;
  static constexpr int kTileElems = kTileK * kLd;  // one K or V stage
  static constexpr size_t kQBytes = sizeof(bf16) * kQTile * kLd;
  static constexpr size_t kStatBytes = sizeof(float) * 2 * kWarps * kQTile;
  static constexpr size_t kStageBytes = sizeof(bf16) * 2 * kTileElems;
  static size_t bytes(int stages) {
    return kQBytes + kStatBytes + (size_t)stages * kStageBytes;
  }
  // the end-of-block merge (per-warp m, l and acc) reuses stage 0
  static_assert(sizeof(float) * (2 * kWarps * kQTile +
                                 kWarps * kQTile * kDP) <= kStageBytes,
                "the merge area must fit one ring stage");
};

// kDP: the head dim padded up to a power of two >= 16 (columns past D are
// zero in Q and in the ring, so they add nothing to q.k)
template <int kDP>
__global__ void __launch_bounds__(kThreads)
    decode_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kc,
                     const bf16* __restrict__ vc, const int* __restrict__ pos,
                     bf16* __restrict__ out, Partials part, int C, int M,
                     int H, int D, float scale, int split_rows, int splits,
                     int stages, int single) {
  using L = Layout<kDP>;
  constexpr int kLd = L::kLd;
  constexpr int kN = kDP / 8;  // n8 tiles of the output row
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* ring = reinterpret_cast<bf16*>(smem_raw + L::kQBytes);
  float* stat = reinterpret_cast<float*>(smem_raw + L::kQBytes +
                                         (size_t)stages * L::kStageBytes);

  // the combine may launch once every block of this grid has started
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int q_tiles = gridDim.x / splits;
  const int qt = blockIdx.x / splits, s = blockIdx.x - qt * splits;
  const int h = blockIdx.y, b = blockIdx.z;
  const int j0 = qt * kQTile, nq = min(kQTile, C - j0);
  const int p0 = pos[b];
  const int span = attended_span(p0, j0, nq, M);
  const int begin = s * split_rows;
  const int end = min(begin + split_rows, span);
  const size_t part_id = (((size_t)b * H + h) * q_tiles + qt) * splits + s;
  const size_t out_row0 = (((size_t)b * C + j0) * H + h) * D;
  const size_t out_stride = (size_t)H * D;
  if (begin >= end) {
    finish_empty(part, part_id, out, out_row0, out_stride, nq, D, splits);
    return;
  }
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;

  // the query tile: 16-byte copies that join the first ring group, so
  // they are in flight with the first cache tile (rows past nq
  // zero-filled); columns past D zero, in Q and in the ring, where no copy
  // writes. The first tile's barrier orders all of it before any read.
  const int cpr = D / 8;  // 16-byte chunks per row
  for (int i = tid; i < kQTile * cpr; i += kThreads) {
    const int r = i / cpr, c = i - r * cpr;
    const bool ok = r < nq;
    cp_async16(q_s + r * kLd + c * 8,
               q + out_row0 + (ok ? r : 0) * out_stride + c * 8, ok);
  }
  if (D < kDP) {
    const int pad = kDP - D;
    for (int i = tid; i < (kQTile + stages * 2 * kTileK) * pad;
         i += kThreads)  // q_s and the ring are contiguous rows of kLd
      q_s[(i / pad) * kLd + D + i % pad] = __float2bfloat16(0.f);
  }

  const size_t row_stride = (size_t)H * D;
  const bf16* kbase = kc + (size_t)b * M * row_stride + (size_t)h * D;
  const bf16* vbase = vc + (size_t)b * M * row_stride + (size_t)h * D;

  // stage rows [t0, t0 + kTileK) of K (and V); rows past `end` zero-filled
  auto load_tile = [&](int t0, int st, bool with_v) {
    const int nvalid = min(kTileK, end - t0);
    bf16* ks = ring + (size_t)st * 2 * L::kTileElems;
    bf16* vs = ks + L::kTileElems;
    for (int i = tid; i < kTileK * cpr; i += kThreads) {
      const int r = i / cpr, c = i - r * cpr;
      const bool ok = r < nvalid;
      const size_t off = (size_t)(ok ? t0 + r : t0) * row_stride + c * 8;
      cp_async16(ks + r * kLd + c * 8, kbase + off, ok);
      if (with_v) cp_async16(vs + r * kLd + c * 8, vbase + off, ok);
    }
  };

  // stream the tiles of [begin, end) through the ring, calling
  // body(t0, stage) on each; the next tiles' copies are in flight while
  // the body runs
  auto stream = [&](bool with_v, auto&& body) {
    const int ntiles = (end - begin + kTileK - 1) / kTileK;
    const int nst = min(stages, ntiles);
    for (int i = 0; i + 1 < nst; ++i) {
      load_tile(begin + i * kTileK, i, with_v);
      cp_async_commit();
    }
    for (int t = 0; t < ntiles; ++t) {
      const int nxt = t + nst - 1;
      if (nxt < ntiles) load_tile(begin + nxt * kTileK, nxt % nst, with_v);
      cp_async_commit();
      cp_async_wait(nst - 1);
      __syncthreads();
      body(begin + t * kTileK, t % nst);
      __syncthreads();
    }
  };

  // this warp's scores on a staged tile, scaled by `sc` and masked:
  // x[nt][e] is query row g + 8 * (e / 2), cache row t0 + 16 * warp +
  // 8 * nt + 2 * tig + e % 2 (the m16n8 accumulator layout)
  auto scores = [&](int t0, int st, float sc, float (&x)[2][4]) {
    const bf16* ks = ring + (size_t)st * 2 * L::kTileElems + warp * 16 * kLd;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDP; kk += 16) {
      uint32_t a[4], kb[4];
      ldsm_x4(a, q_s + ((lane & 7) + ((lane >> 3) & 1) * 8) * kLd + kk +
                     (lane >> 4) * 8);
      ldsm_x4(kb, ks + ((lane & 7) + (lane >> 4) * 8) * kLd + kk +
                      ((lane >> 3) & 1) * 8);
      mma(x[0], a, kb[0], kb[1]);
      mma(x[1], a, kb[2], kb[3]);
    }
    const long long lim = (long long)p0 + j0 + g;  // row g's last key
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = t0 + warp * 16 + nt * 8 + 2 * tig + (e & 1);
        const bool ok = key < end && key <= lim + (e >> 1) * 8;
        x[nt][e] = ok ? x[nt][e] * sc : kNegInf;
      }
  };

  // acc += P V over this warp's 16 staged rows; p packed as the A fragment
  auto pv = [&](int st, const float (&p)[2][4], float (&acc)[kN][4]) {
    const uint32_t a[4] = {pack_bf16(p[0][0], p[0][1]),
                           pack_bf16(p[0][2], p[0][3]),
                           pack_bf16(p[1][0], p[1][1]),
                           pack_bf16(p[1][2], p[1][3])};
    const bf16* vs = ring + (size_t)st * 2 * L::kTileElems + L::kTileElems +
                     warp * 16 * kLd;
#pragma unroll
    for (int n0 = 0; n0 < kDP; n0 += 16) {
      uint32_t vb[4];
      ldsm_x4_t(vb, vs + ((lane & 7) + ((lane >> 3) & 1) * 8) * kLd + n0 +
                        (lane >> 4) * 8);
      mma(acc[n0 / 8], a, vb[0], vb[1]);
      mma(acc[n0 / 8 + 1], a, vb[2], vb[3]);
    }
  };

  float acc[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  // online softmax step for row i (0: g, 1: g + 8) of this warp's tile
  // slice, in the exp `ex` domain; returns the correction of old sums
  auto online = [&](float (&x)[2][4], int i, auto ex) {
    float mx = fmaxf(fmaxf(x[0][2 * i], x[0][2 * i + 1]),
                     fmaxf(x[1][2 * i], x[1][2 * i + 1]));
    mx = quad_max(mx);
    const float m_new = fmaxf(m[i], mx);
    // a row with every key masked so far keeps p = 0 (not e^0)
    const float m_use = m_new == kNegInf ? 0.f : m_new;
    const float corr = ex(m[i] - m_use);
    m[i] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 2 * i; e < 2 * i + 2; ++e) {
        x[nt][e] = ex(x[nt][e] - m_use);
        sum += x[nt][e];
      }
    l[i] = l[i] * corr + sum;  // this thread's share; the quad sums at end
    return corr;
  };
  auto exp2_ = [](float v) { return exp2f(v); };
  auto exp_ = [](float v) { return expf(v); };

  if (!single) {
    stream(true, [&](int t0, int st) {
      float x[2][4];
      scores(t0, st, scale * kLog2e, x);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float corr = online(x, i, exp2_);
#pragma unroll
        for (int n = 0; n < kN; ++n) {
          acc[n][2 * i] *= corr;
          acc[n][2 * i + 1] *= corr;
        }
      }
      pv(st, x, acc);  // the unnormalised p, rounded to bf16
    });
  } else {
    // pass 1: the rows' max and sum over the whole span (K only)
    stream(false, [&](int t0, int st) {
      float x[2][4];
      scores(t0, st, scale, x);
      online(x, 0, exp_);
      online(x, 1, exp_);
    });
    if (tig == 0) {
      stat[warp * kQTile + g] = m[0];
      stat[warp * kQTile + g + 8] = m[1];
    }
    const float lq[2] = {quad_sum(l[0]), quad_sum(l[1])};
    if (tig == 0) {
      stat[(kWarps + warp) * kQTile + g] = lq[0];
      stat[(kWarps + warp) * kQTile + g + 8] = lq[1];
    }
    __syncthreads();
    float mrow[2], inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = g + 8 * i;
      float mx = kNegInf;
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, stat[w * kQTile + r]);
      const float mu = mx == kNegInf ? 0.f : mx;
      float sum = 0.f;
      for (int w = 0; w < kWarps; ++w)
        sum += expf(stat[w * kQTile + r] - mu) *
               stat[(kWarps + w) * kQTile + r];
      mrow[i] = mu;
      inv[i] = sum == 0.f ? 1.f : sum;  // the l == 0 -> 1 guard
    }
    // pass 2: (p / l) rounded to bf16, then p.v
    stream(true, [&](int t0, int st) {
      float x[2][4];
      scores(t0, st, scale, x);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x[nt][e] = expf(x[nt][e] - mrow[e >> 1]) / inv[e >> 1];
      pv(st, x, acc);
    });
  }

  // merge the 4 warps' (m, l, acc) through shared memory (ring stage 0;
  // the groups still open are empty, and the last body ended in a barrier)
  cp_async_wait(0);
  float* mw = reinterpret_cast<float*>(ring);  // [kWarps][kQTile]
  float* lw = mw + kWarps * kQTile;            // [kWarps][kQTile]
  float* aw = lw + kWarps * kQTile;            // [kWarps][kQTile][kDP]
  const float lq[2] = {quad_sum(l[0]), quad_sum(l[1])};
  if (tig == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mw[warp * kQTile + g + 8 * i] = m[i];
      lw[warp * kQTile + g + 8 * i] = lq[i];
    }
  }
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      aw[(warp * kQTile + g + 8 * (e >> 1)) * kDP + n * 8 + 2 * tig +
         (e & 1)] = acc[n][e];
  __syncthreads();
  for (int i = tid; i < nq * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    float a = 0.f;
    if (single) {  // every warp used the row's final max and sum
      for (int w = 0; w < kWarps; ++w) a += aw[(w * kQTile + r) * kDP + c];
      out[out_row0 + r * out_stride + c] = __float2bfloat16(a);
      continue;
    }
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, mw[w * kQTile + r]);
    const float mu = mx == kNegInf ? 0.f : mx;
    float sum = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float wt = exp2f(mw[w * kQTile + r] - mu);
      sum += wt * lw[w * kQTile + r];
      a += wt * aw[(w * kQTile + r) * kDP + c];
    }
    if (splits == 1) {
      out[out_row0 + r * out_stride + c] =
          __float2bfloat16(a / (sum == 0.f ? 1.f : sum));
      continue;
    }
    part.acc[(part_id * kQTile + r) * D + c] = a;
    if (c == 0) {
      part.ml[part_id * 2 * kQTile + r] = mx;
      part.ml[part_id * 2 * kQTile + kQTile + r] = sum;
    }
  }
}

template <int kDP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* pos, void* out, Partials part, int B, int C,
                   int M, int H, int D, float scale, int split_rows,
                   int splits, int single, cudaStream_t stream) {
  const int tiles = (split_rows + kTileK - 1) / kTileK;
  const int stages = tiles < kMaxStages ? tiles : kMaxStages;
  const size_t smem = Layout<kDP>::bytes(stages);
  auto kernel = decode_tc_kernel<kDP>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int q_tiles = (C + kQTile - 1) / kQTile;
  const dim3 grid(q_tiles * splits, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), pos, static_cast<bf16*>(out), part, C, M,
      H, D, scale, split_rows, splits, stages, single);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const int* pos, void* out, Partials part, int B, int C,
                     int M, int H, int D, float scale, int split_rows,
                     int splits, int single, cudaStream_t s) {
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (!aligned(q) || !aligned(k) || !aligned(v) || D % 8 != 0 || D < 8 ||
      D > 256)
    return cudaErrorInvalidValue;
  if (D <= 16)
    return launch<16>(q, k, v, pos, out, part, B, C, M, H, D, scale,
                      split_rows, splits, single, s);
  if (D <= 32)
    return launch<32>(q, k, v, pos, out, part, B, C, M, H, D, scale,
                      split_rows, splits, single, s);
  if (D <= 64)
    return launch<64>(q, k, v, pos, out, part, B, C, M, H, D, scale,
                      split_rows, splits, single, s);
  if (D <= 128)
    return launch<128>(q, k, v, pos, out, part, B, C, M, H, D, scale,
                       split_rows, splits, single, s);
  return launch<256>(q, k, v, pos, out, part, B, C, M, H, D, scale,
                     split_rows, splits, single, s);
}

}  // namespace tc

// =========================================================================
// cc route: f32 FMA through shared memory (any dtype pair, any d)
// =========================================================================
namespace cc {

// Stage `nt` cache rows of one head (row r of K at k + r * stride) into
// the shared f32 tiles k_s / v_s (row stride ld; v_s skipped when null),
// rounded to q's dtype as the TPU kernel's `.astype(q.dtype)` does. With
// vec16 (rows made of whole, aligned 16-byte chunks) a thread moves 16
// bytes per step, unrolled so that several loads are in flight.
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
      Chunk kk;
      kk.raw = *reinterpret_cast<const uint4*>(k + off);
      float* kd = k_s + t * ld + c * kVec;
#pragma unroll
      for (int x = 0; x < kVec; ++x) kd[x] = round_to<QT>(to_f(kk.e[x]));
      if (v_s == nullptr) continue;
      Chunk vv;
      vv.raw = *reinterpret_cast<const uint4*>(v + off);
      float* vd = v_s + t * ld + c * kVec;
#pragma unroll
      for (int x = 0; x < kVec; ++x) vd[x] = round_to<QT>(to_f(vv.e[x]));
    }
    return;
  }
  for (int i = threadIdx.x; i < nt * D; i += kThreads) {
    const int t = i / D, dd = i - t * D;
    k_s[t * ld + dd] = round_to<QT>(to_f(k[t * stride + dd]));
    if (v_s != nullptr)
      v_s[t * ld + dd] = round_to<QT>(to_f(v[t * stride + dd]));
  }
}

template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads)
    decode_cc_kernel(const QT* __restrict__ q, const KT* __restrict__ kc,
                     const KT* __restrict__ vc, const int* __restrict__ pos,
                     QT* __restrict__ out, Partials part, int C, int M,
                     int H, int D, float scale, int tile_k, int q_tile,
                     int split_rows, int splits, int single, bool vec16) {
  extern __shared__ float smem[];
  // the combine may launch once every block of this grid has started
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int q_tiles = gridDim.x / splits;
  const int qt = blockIdx.x / splits, s = blockIdx.x - qt * splits;
  const int h = blockIdx.y, b = blockIdx.z, j0 = qt * q_tile;
  const int nq = min(q_tile, C - j0);
  const int p0 = pos[b];
  const int span = attended_span(p0, j0, nq, M);
  const int begin = s * split_rows;
  const int end = min(begin + split_rows, span);
  const size_t part_id = (((size_t)b * H + h) * q_tiles + qt) * splits + s;
  const size_t out_row0 = (((size_t)b * C + j0) * H + h) * D;
  const size_t out_stride = (size_t)H * D;
  if (begin >= end) {
    finish_empty(part, part_id, out, out_row0, out_stride, nq, D, splits);
    return;
  }
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

  for (int i = tid; i < nq * D; i += kThreads) {
    const int jj = i / D, dd = i - jj * D;
    q_s[jj * ld + dd] = to_f(q[out_row0 + jj * out_stride + dd]);
    acc[i] = 0.f;
  }
  for (int jj = tid; jj < nq; jj += kThreads) {
    m_s[jj] = kNegInf;
    l_s[jj] = 0.f;
  }
  __syncthreads();

  // split: one pass, online softmax and p.v per tile. single: a first
  // pass over the span for the rows' max and sum (K only), then a second
  // that normalises p before p.v
  const size_t stride = (size_t)H * D;
  const size_t base = (((size_t)b * M) * H + h) * D;
  for (int pass = single ? 0 : 1; pass < 2; ++pass) {
    for (int t0 = begin; t0 < end; t0 += tile_k) {
      const int nt = min(tile_k, end - t0);
      stage_rows<QT>(kc + base + t0 * stride, vc + base + t0 * stride, k_s,
                     pass ? v_s : (float*)nullptr, nt, stride, D, ld, vec16);
      __syncthreads();

      // scores of the staged rows, masked at -1e30
      for (int i = tid; i < nq * tile_k; i += kThreads) {
        const int jj = i / tile_k, t = i - jj * tile_k;
        float sc = kNegInf;
        if (t < nt && t0 + t <= (long long)p0 + j0 + jj) {
          const float* qr = q_s + jj * ld;
          const float* kr = k_s + t * ld;
          float a = 0.f;
          for (int dd = 0; dd < D; ++dd) a = fmaf(qr[dd], kr[dd], a);
          sc = a * scale;
        }
        p_s[i] = sc;
      }
      __syncthreads();

      if (single && pass) {  // (p / l) with the rows' final max and sum
        for (int i = tid; i < nq * tile_k; i += kThreads) {
          const int jj = i / tile_k;
          const float mu = m_s[jj] == kNegInf ? 0.f : m_s[jj];
          const float l = l_s[jj];
          p_s[i] = expf(p_s[i] - mu) / (l == 0.f ? 1.f : l);
        }
      } else {  // online softmax, one warp per row; c_s: the correction
        for (int jj = warp; jj < nq; jj += kWarps) {
          float* pr = p_s + jj * tile_k;
          float mx = kNegInf;
          for (int t = lane; t < tile_k; t += 32) mx = fmaxf(mx, pr[t]);
          mx = warp_max(mx);
          const float m_prev = m_s[jj];
          const float m_new = fmaxf(m_prev, mx);
          // a row with every key masked so far keeps p = 0 (not e^0)
          const float m_use = m_new == kNegInf ? 0.f : m_new;
          float sum = 0.f;
          for (int t = lane; t < tile_k; t += 32) {
            const float p = expf(pr[t] - m_use);
            pr[t] = p;
            sum += p;
          }
          sum = warp_sum(sum);
          if (lane == 0) {
            const float corr = expf(m_prev - m_use);
            m_s[jj] = m_new;
            l_s[jj] = l_s[jj] * corr + sum;
            c_s[jj] = corr;
          }
        }
      }
      __syncthreads();
      if (!pass) continue;

      // acc = acc * correction + round(p) . v (no correction when single)
      for (int i = tid; i < nq * D; i += kThreads) {
        const int jj = i / D, dd = i - jj * D;
        const float* pr = p_s + jj * tile_k;
        float a = single ? acc[i] : acc[i] * c_s[jj];
        for (int t = 0; t < nt; ++t)
          a = fmaf(round_to<QT>(pr[t]), v_s[t * ld + dd], a);
        acc[i] = a;
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < nq * D; i += kThreads) {
    const int jj = i / D, dd = i - jj * D;
    const float l = l_s[jj];
    if (single) {
      out[out_row0 + jj * out_stride + dd] = from_f<QT>(acc[i]);
    } else if (splits == 1) {
      out[out_row0 + jj * out_stride + dd] =
          from_f<QT>(acc[i] / (l == 0.f ? 1.f : l));
    } else {
      part.acc[(part_id * kQTile + jj) * D + dd] = acc[i];
      if (dd == 0) {
        part.ml[part_id * 2 * kQTile + jj] = m_s[jj];
        part.ml[part_id * 2 * kQTile + kQTile + jj] = l;
      }
    }
  }
}

template <typename QT, typename KT>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* pos, void* out, Partials part, int B, int C,
                   int M, int H, int D, float scale, int tile_k,
                   int split_rows, int splits, int single,
                   cudaStream_t stream) {
  const int q_tile = C < kQTile ? C : kQTile;
  const size_t smem =
      sizeof(float) * ((size_t)(q_tile + 2 * tile_k) * (D + 1) +
                       (size_t)q_tile * tile_k + (size_t)q_tile * D +
                       3 * (size_t)q_tile);
  auto kernel = decode_cc_kernel<QT, KT>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const bool vec16 = (D * sizeof(KT)) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const int q_tiles = (C + q_tile - 1) / q_tile;
  const dim3 grid(q_tiles * splits, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), pos, static_cast<QT*>(out), part, C, M, H,
      D, scale, tile_k, q_tile, split_rows, splits, single, vec16);
  return cudaGetLastError();
}

}  // namespace cc

// =========================================================================
// combine: the splits' partials -> out. A block takes `rpb` rows of one
// (query tile, head, slot), one thread per output element, and issues its
// loads over the splits in unrolled batches, so that they are in flight
// together: one load at a time per split would wait out the latency of
// each. `log2`: the partials' m is in the exp2 domain (tc) or exp (cc).
// =========================================================================
constexpr int kCombineBatch = 8;

template <typename QT>
__global__ void __launch_bounds__(kThreads)
    decode_combine_kernel(Partials part, QT* __restrict__ out, int C, int H,
                          int D, int q_tiles, int rpb, int splits, int log2) {
  extern __shared__ float w_s[];  // [rpb][splits] m, then weights; [rpb] l
  float* sum_s = w_s + rpb * splits;
  // launched early (programmatic dependent launch): wait until the split
  // kernel has finished and its partials are visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int row_blocks = (kQTile + rpb - 1) / rpb;
  const int qt = blockIdx.x / row_blocks;
  const int r0 = (blockIdx.x - qt * row_blocks) * rpb;
  const int h = blockIdx.y, b = blockIdx.z;
  const int j0 = qt * kQTile;
  const int nr = min(rpb, min(kQTile, C - j0) - r0);  // rows of this block
  if (nr <= 0) return;
  const size_t base = (((size_t)b * H + h) * q_tiles + qt) * splits;
  // each (row, split): m, or -1e30 where the split attended nothing
  for (int i = threadIdx.x; i < nr * splits; i += kThreads) {
    const int rr = i / splits, s = i - rr * splits;
    const float* ml = part.ml + (base + s) * 2 * kQTile + r0 + rr;
    w_s[i] = ml[kQTile] > 0.f ? ml[0] : kNegInf;
  }
  __syncthreads();
  for (int rr = threadIdx.x; rr < nr; rr += kThreads) {
    float* w = w_s + rr * splits;
    float mx = kNegInf;
    for (int s = 0; s < splits; ++s) mx = fmaxf(mx, w[s]);
    const float mu = mx == kNegInf ? 0.f : mx;
    float sum = 0.f;
    for (int s = 0; s < splits; ++s) {
      // a split with no attended row (l == 0) wrote no acc: weight 0
      const float wt = w[s] == kNegInf ? 0.f
                       : log2          ? exp2f(w[s] - mu)
                                       : expf(w[s] - mu);
      sum += wt * part.ml[(base + s) * 2 * kQTile + kQTile + r0 + rr];
      w[s] = wt;
    }
    sum_s[rr] = sum == 0.f ? 1.f : sum;  // the l == 0 -> 1 guard
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nr * D; i += kThreads) {
    const int rr = i / D, c = i - rr * D;
    const float* w = w_s + rr * splits;
    const float* acc = part.acc + (base * kQTile + r0 + rr) * D + c;
    const size_t step = (size_t)kQTile * D;  // one split's acc
    float a = 0.f;
    for (int s0 = 0; s0 < splits; s0 += kCombineBatch) {
      float v[kCombineBatch];
#pragma unroll
      for (int u = 0; u < kCombineBatch; ++u) {
        const int s = s0 + u;
        v[u] = (s < splits && w[s] != 0.f) ? acc[s * step] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kCombineBatch; ++u)
        if (s0 + u < splits) a += w[s0 + u] * v[u];
    }
    out[(((size_t)b * C + j0 + r0 + rr) * H + h) * D + c] =
        from_f<QT>(a / sum_s[rr]);
  }
}

template <typename QT>
cudaError_t combine(Partials part, void* out, int B, int C, int H, int D,
                    int splits, int log2, cudaStream_t stream) {
  const int rpb = D >= kThreads ? 1 : kThreads / D;
  const size_t smem = sizeof(float) * rpb * (splits + 1);
  auto kernel = decode_combine_kernel<QT>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int q_tiles = (C + kQTile - 1) / kQTile;
  const int row_blocks = (kQTile + rpb - 1) / rpb;
  // programmatic dependent launch: the combine's blocks are scheduled
  // while the split kernel's last blocks run, hiding a launch's latency
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(q_tiles * row_blocks, H, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, part, static_cast<QT*>(out), C, H,
                            D, q_tiles, rpb, splits, log2);
}

enum Route { kRouteCC = 0, kRouteTC = 1 };

}  // namespace

// One call of either entry of `_call_decode`, on the plan that
// kernels/decode.py `decode_plan` made: `route` (0 cc, 1 tc), `split_rows`
// cache rows per split, `splits` of them (the grid's split axis), `single`
// (the TPU kernel's one-block op order), `tile_k` the cc route's staged
// rows. `part` (f32, B * H * ceil(C / 16) * splits * 16 * (D + 2) floats)
// is the scratch of the partials, used only when splits > 1; then a
// second launch merges them. Returns the first CUDA error, else 0.
extern "C" int ff_decode_attention(const void* q, const void* k,
                                   const void* v, const int* pos, void* out,
                                   void* part, int B, int C, int M, int H,
                                   int D, float scale, int tile_k,
                                   int split_rows, int splits, int single,
                                   int route, int q_dtype, int kv_dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (splits < 1 || split_rows < 1 || (splits > 1 && part == nullptr) ||
      (single && splits != 1))
    return (int)cudaErrorInvalidValue;
  const size_t n_parts =
      (size_t)B * H * ((C + kQTile - 1) / kQTile) * splits;
  Partials p{static_cast<float*>(part),
             static_cast<float*>(part) + n_parts * 2 * kQTile};
  if (part == nullptr) p = Partials{nullptr, nullptr};
  cudaError_t err = cudaErrorInvalidValue;
  if (route == kRouteTC) {
    if (q_dtype != FF_BF16 || kv_dtype != FF_BF16)
      return (int)cudaErrorInvalidValue;
    err = tc::dispatch(q, k, v, pos, out, p, B, C, M, H, D, scale,
                       split_rows, splits, single, s);
  } else if (q_dtype == FF_F32 && kv_dtype == FF_F32) {
    err = cc::launch<float, float>(q, k, v, pos, out, p, B, C, M, H, D, scale,
                                   tile_k, split_rows, splits, single, s);
  } else if (q_dtype == FF_F32 && kv_dtype == FF_BF16) {
    err = cc::launch<float, __nv_bfloat16>(q, k, v, pos, out, p, B, C, M, H,
                                           D, scale, tile_k, split_rows,
                                           splits, single, s);
  } else if (q_dtype == FF_BF16 && kv_dtype == FF_F32) {
    err = cc::launch<__nv_bfloat16, float>(q, k, v, pos, out, p, B, C, M, H,
                                           D, scale, tile_k, split_rows,
                                           splits, single, s);
  } else if (q_dtype == FF_BF16 && kv_dtype == FF_BF16) {
    err = cc::launch<__nv_bfloat16, __nv_bfloat16>(
        q, k, v, pos, out, p, B, C, M, H, D, scale, tile_k, split_rows,
        splits, single, s);
  }
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int log2 = route == kRouteTC;
  if (q_dtype == FF_F32)
    return (int)combine<float>(p, out, B, C, H, D, splits, log2, s);
  return (int)combine<__nv_bfloat16>(p, out, B, C, H, D, splits, log2, s);
}
