// Flash attention, forward and backward, in bf16 on Hopper's tensor cores
// (sm_90a): `wgmma` on 64-row warpgroup tiles, fed by TMA through rings of
// shared-memory stages with mbarrier completion. The bf16 route of
// csrc/flash_attention.cu's C entries (ff_flash_fwd, ff_flash_bwd); f32
// stays on that file's CUDA-core kernels (a tensor-core product in f32 is
// TF32, about three decimal digits).
//
// Replaces, for bf16, the TPU kernels of flexflow_tpu/kernels/
// flash_attention.py: `_flash_fwd_packed` (`_fwd_kernel_packed`) and
// `_flash_fwd` (`_fwd_kernel`) by flash_fwd_tc; `_flash_bwd_packed` and
// `_flash_bwd` (their dq and dk/dv kernels) by flash_bwd_dq_tc and
// flash_bwd_dkv_tc. The semantics are the plain versions' (kernels/
// flash_attention.py `_fwd_math`, `_bwd_math`): s = q.k * scale in f32
// from bf16 operands; a masked score is -1e30 (causal keeps key j for
// query i when j <= i + Lk - Lq), so a row that attends no key averages
// every v; p rounded to bf16 before p.v; o = acc / (l == 0 ? 1 : l), lse
// = m + log(l == 0 ? 1 : l) in f32; backward p = exp(s - lse) (masked p
// = 0), ds = p (dp - delta), p and ds rounded to bf16 before each
// product, dq and dk scaled once at the end.
//
// Bound at the training shape (b 8, l 512, 16 heads of 64): the forward
// moves 33.8 MB (0.0101 ms at 3.35 TB/s) for 8.6 GFLOP (0.0087 ms at 989
// TFLOP/s): bytes; the backward does 10 b h l^2 d = 21.5 GFLOP (0.0217
// ms): operations.
//
// Design. Every operand tile is one or two TMA boxes of 64 head-dim
// columns (128 bytes, the 128-byte swizzle span) by up to 128 rows, from
// a 4-D tensor map (d, l, h, b) built per launch from the tensor's
// strides, so one code path reads packed, blhd and bhld in place; the
// head dim pads to 64 or 128 (DP) through TMA's zero fill past d, and a
// ragged last tile through its zero fill past l (l stays its own dim:
// never another batch row's rows). Blocks have one producer warpgroup
// (one thread issues the loads; `setmaxnreg` drops it to 40 registers)
// and CW = 1 or 2 consumer warpgroups (232 registers), each owning 64
// rows: the `wgmma` M. The producer keeps a ring of kStages stages full;
// a consumer waits on a stage's "full" mbarrier (TMA completes its
// transaction bytes) and arrives on its "empty" one after its last
// product read it.
//  - forward: one block per (64 CW queries, head, batch row); Q loaded
//    once, K and V tiles of BK keys streamed. S = Q K^T is `wgmma` with
//    both operands K-major in shared memory; the online softmax runs on
//    the f32 accumulator fragment (a thread holds two rows, reduced over
//    its quad with two shuffles; m, l and the correction in registers,
//    base-2 exponents); P, rounded to bf16 and packed in pairs, is the
//    register A fragment of O += P V, whose B (V, keys down the rows) is
//    the MN-major operand (the instruction's transpose bit: no copy).
//  - dk / dv: one block per (64 CW keys, head, batch row); K and V
//    loaded once; Q and dO tiles of 64 queries streamed. S^T = K Q^T and
//    dP^T = V dO^T from shared memory, P^T and dS^T built on the
//    accumulators, then dV += P^T dO and dK += dS^T Q with P^T and dS^T
//    as register A and dO, Q MN-major. lse and delta (per-row f32, h
//    floats apart: too narrow for a TMA box) come by plain loads.
//  - dq: one block per (64 CW queries, head, batch row); Q and dO loaded
//    once; K and V tiles of 64 keys streamed; S = Q K^T, dP = dO V^T,
//    dQ += dS K with dS as register A and K MN-major.
//  Two launches, no atomics: a rerun gives the same bits.
//  Results are written from the accumulator fragments (bf16 pairs).
//  Each tile's second product runs on while the next tile's first is
//  issued. The backward keeps every rounded p and ds the plain
//  version's (see "the plain version's rounding" below).
// Tuned on the card at the training shapes: 3 stages (2 to 4 measured
// alike), forward key tiles of 128 at d 64 (64 at d 128), blocks of two
// consumer warpgroups. ptxas at d 64: 168 registers at entry (setmaxnreg
// 40 / 232), no spills; at d 128 with one consumer warpgroup dk / dv
// spills 4 bytes.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kStages = 3;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// the TPU kernels' masked score, -1e30 (not -inf), in base-2 units
constexpr float kMasked2 = -1e30f * kLog2e;
constexpr uint32_t kRowBytes = 128;  // one box row: 64 bf16
constexpr uint32_t kGroupBytes = 1024;  // 8 swizzled rows

// element strides of one tensor's batch, head and row axes (head dim 1)
struct Stride3 {
  long long b, h, l;
  __device__ __forceinline__ long long at(int bi, int hi, int row) const {
    return bi * b + hi * h + row * l;
  }
};

struct FwdArgs {
  __nv_bfloat16* o;
  float* lse;
  Stride3 so, slse;
  int Lq, Lk, D, causal;
  float scale_log2;  // scale * log2(e)
};

struct BwdArgs {
  const __nv_bfloat16 *q, *k, *v, *dout;
  const float* lse;
  const float* delta;
  __nv_bfloat16 *dq, *dk, *dv;
  Stride3 sq, sk, sv, sdo, slse, sdelta, sdq, sdk, sdv;
  int Lq, Lk, D, causal;
  float scale;
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
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

// The m64nN f32 accumulator fragment: element i of a thread sits at row
// (warp 16 + lane / 4) + 8 frag_hi(i) of the warpgroup's 64, column
// 8 (i / 4) + 2 (lane % 4) + (i % 2). Its 16-column block kk, packed in
// bf16 pairs (i = 8 kk .. 8 kk + 7), is exactly the m64k16 register A
// fragment of the next product.
template <int N>
__device__ __forceinline__ void to_a_frag(const float (&acc)[N / 2],
                                          uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      a[kk][x] = pack_bf16(acc[8 * kk + 2 * x], acc[8 * kk + 2 * x + 1]);
}

// store a 64 x DP fragment (rows < nrows, columns < D), times `mul`, as
// bf16 pairs; row r of the fragment goes to out + at(row0 + r)
template <int DP>
__device__ __forceinline__ void store_frag(const float (&acc)[DP / 2],
                                           __nv_bfloat16* out, Stride3 st,
                                           int bi, int hi, int row0,
                                           int nrows, int D, float mul0,
                                           float mul1) {
  const int t = threadIdx.x & 127;
  const int r = (t >> 5) * 16 + ((t & 31) >> 2), c = (t & 3) * 2;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (r + 8 * rr >= nrows) continue;
    const float mul = rr ? mul1 : mul0;
    __nv_bfloat16* row = out + st.at(bi, hi, row0 + r + 8 * rr);
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + c;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(row + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * rr] * mul,
                                  acc[4 * j + 2 * rr + 1] * mul);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) a[i] = 0.f;
}

// ---- the plain version's rounding of p and ds -----------------------------
// The backward rounds p and ds to bf16 before its products, as the plain
// version does. The plain version's s = q.k and dp = dO.v are f32 GEMMs
// that sum the head dim in order, one fma per term (cuBLAS's f32 GEMM);
// the tensor cores sum k16 blocks with their own rounding. The two differ
// in the last bits, and where p or ds sits near a bf16 rounding midpoint
// that flips the rounded value: one bf16 ulp of a large ds moves dq or dk
// by several bf16 ulps. So each p and ds is held against a bound on how
// far the fast value may sit from the plain version's, and where the
// midpoint lies within it the element is recomputed as the plain version
// computes it: both dots by fmaf in order from the shared-memory tiles, p
// = expf(s * scale - lse), ds = p * (dp - delta), each operation rounded
// once. The fast path computes the plain version's exponent x = s scale
// - lse with the same two roundings, then p = 2^(x log2(e)). The
// bound, relative to p: kDotErr |q| |k| scale for the dots (by
// Cauchy-Schwarz on the row norms), kRound (3 |x| + 2 |lse|) for the
// roundings of s scale and s scale - lse, which may go the other way
// where s differs, and of x log2(e); kExp for ex2's and expf's own
// errors. On ds besides: |p| (kDotErr |v| |dO| + kRound |dp|) for dp,
// kRound 2 for dp - delta and the product. (dq takes the key-side norms
// as their largest over the tile: one fewer term per element.) The fast p flushes values
// below 2^-126 to zero, the one place it may differ from the plain
// version's rounding; such a p moves no gradient by more than 2^-126
// times |dO| or |q|.
constexpr float kDotErr = 1.0f / (1 << 24);
constexpr float kRound = 1.0f / (1 << 24);
constexpr float kExp = 1.0f / (1 << 21);

// 2^x by the special-function unit (within 2 ulps; results below 2^-126
// flush to zero)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the midpoint between the two bf16 values around x (bf16 rounding of x
// flips where x crosses it)
__device__ __forceinline__ float bf16_midpoint(float x) {
  return __uint_as_float((__float_as_uint(x) & 0xFFFF0000u) | 0x8000u);
}
// true when x and every value within err of it may not round to one bf16
__device__ __forceinline__ bool near_midpoint(float x, float err) {
  return fabsf(x - bf16_midpoint(x)) <= err;
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}

// The plain version's dot of row ra of tile a and row rb of tile b (both
// as TMA wrote them: 64-column boxes a_box / b_box bytes apart, 128-byte
// swizzle): fmaf over the head dim in order, from 0.
__device__ __forceinline__ float plain_dot(const uint8_t* a, uint32_t a_box,
                                           int ra, const uint8_t* b,
                                           uint32_t b_box, int rb, int D) {
  float acc = 0.f;
  for (int c8 = 0; c8 < D / 8; ++c8) {
    const uint32_t box = c8 >> 3, ch = c8 & 7;
    const uint4 va = *reinterpret_cast<const uint4*>(
        a + box * a_box + ra * kRowBytes + ((ch ^ (ra & 7)) << 4));
    const uint4 vb = *reinterpret_cast<const uint4*>(
        b + box * b_box + rb * kRowBytes + ((ch ^ (rb & 7)) << 4));
    const uint32_t wa[4] = {va.x, va.y, va.z, va.w};
    const uint32_t wb[4] = {vb.x, vb.y, vb.z, vb.w};
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      acc = fmaf(bf16_lo(wa[w]), bf16_lo(wb[w]), acc);
      acc = fmaf(bf16_hi(wa[w]), bf16_hi(wb[w]), acc);
    }
  }
  return acc;
}

// the euclidean norm of row r of a tile as TMA wrote it (64-column boxes
// box bytes apart; the chunks in any order: the 128-byte swizzle's)
__device__ __forceinline__ float tile_row_norm(const uint8_t* tile,
                                               uint32_t box, int r, int D) {
  float acc = 0.f;
  for (int c8 = 0; c8 < D / 8; ++c8) {
    const uint4 v = *reinterpret_cast<const uint4*>(
        tile + (c8 >> 3) * box + r * kRowBytes + (((c8 & 7) ^ (r & 7)) << 4));
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      acc = fmaf(bf16_lo(w[x]), bf16_lo(w[x]), acc);
      acc = fmaf(bf16_hi(w[x]), bf16_hi(w[x]), acc);
    }
  }
  return sqrtf(acc);
}

// the largest of the warp's non-negative x (their bits order as ints)
__device__ __forceinline__ float warp_max_nonneg(float x) {
  return __uint_as_float(__reduce_max_sync(0xffffffffu, __float_as_uint(x)));
}

// barrier over the 128 threads of one consumer warpgroup (ids from 1:
// 0 is __syncthreads')
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// the euclidean norm of a bf16 row in device memory (D a multiple of 8,
// the row 16-byte aligned: TMA's rules)
__device__ __forceinline__ float row_norm(const __nv_bfloat16* row, int D) {
  float acc = 0.f;
  for (int c8 = 0; c8 < D / 8; ++c8) {
    const uint4 v = *reinterpret_cast<const uint4*>(row + 8 * c8);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      acc = fmaf(bf16_lo(w[x]), bf16_lo(w[x]), acc);
      acc = fmaf(bf16_hi(w[x]), bf16_hi(w[x]), acc);
    }
  }
  return sqrtf(acc);
}

// ---- forward ------------------------------------------------------------

template <int DP, int BK, int CW>
struct FwdSmem {
  static constexpr int kBoxes = DP / 64, kBQ = 64 * CW;
  static constexpr uint32_t kQBox = kBQ * kRowBytes, kQ = kBoxes * kQBox;
  static constexpr uint32_t kKBox = BK * kRowBytes, kK = kBoxes * kKBox;
  static constexpr uint32_t kBars = kQ + 2 * kStages * kK;
  static constexpr size_t kBytes = 1024 + kBars + 8 * (1 + 3 * kStages);
  static_assert(kBytes <= 232448, "over a block's shared memory");
};

template <int DP, int BK, int CW>
__global__ void __launch_bounds__(128 * (CW + 1), 1)
    flash_fwd_tc(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const FwdArgs a) {
  using S = FwdSmem<DP, BK, CW>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = align1024(smem_raw);
  uint8_t* k_s = q_s + S::kQ;             // stage s at k_s + s kK
  uint8_t* v_s = k_s + kStages * S::kK;   // stage s at v_s + s kK
  uint64_t* q_full = reinterpret_cast<uint64_t*>(q_s + S::kBars);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * S::kBQ;
  const int Lq = a.Lq, Lk = a.Lk, q_offset = Lk - Lq;
  const int nq = min(S::kBQ, Lq - q0);
  // keys past the last one a row of this tile may attend are skipped; a
  // row that attends no key (causal, Lq > Lk) averages every v, so a tile
  // that holds one reads every key
  const bool row_sees_none = a.causal && q0 + q_offset < 0;
  const int k_end =
      a.causal && !row_sees_none ? min(Lk, q0 + nq + q_offset) : Lk;
  const int n_tiles = (k_end + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 128 * CW);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup
    if constexpr (CW == 2) regs_dealloc<40>();
    if (threadIdx.x == 0) {
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      mbar_arrive_expect_tx(q_full, S::kQ);
      for (int x = 0; x < S::kBoxes; ++x)
        tma_load_4d(q_s + x * S::kQBox, &tq, q_full, 64 * x, q0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&k_full[s], S::kK);
        for (int x = 0; x < S::kBoxes; ++x)
          tma_load_4d(k_s + s * S::kK + x * S::kKBox, &tk, &k_full[s],
                      64 * x, it * BK, h, b);
        mbar_arrive_expect_tx(&v_full[s], S::kK);
        for (int x = 0; x < S::kBoxes; ++x)
          tma_load_4d(v_s + s * S::kK + x * S::kKBox, &tv, &v_full[s],
                      64 * x, it * BK, h, b);
      }
    }
  } else {  // consumer warpgroups: 64 query rows each
    if constexpr (CW == 2) regs_alloc<232>();
    const int cw = threadIdx.x / 128 - 1;
    const int t = threadIdx.x & 127, lane = t & 31;
    const int r_in = (t >> 5) * 16 + (lane >> 2), c_in = (lane & 3) * 2;
    const int qi0 = q0 + 64 * cw + r_in;  // fragment rows qi0, qi0 + 8
    const uint8_t* q_wg = q_s + 64 * cw * kRowBytes;
    float o_acc[DP / 2];
    zero(o_acc);
    float m_r[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_r[2] = {0.f, 0.f};

    // P of the tile before, the register A of its P V, which runs on
    // while this tile's S is issued
    uint32_t p_frag[BK / 16][4];
    mbar_wait(q_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      const uint32_t ph = (it / kStages) & 1;
      const int k0 = it * BK;
      const uint8_t* kt = k_s + s * S::kK;
      const uint8_t* vt = v_s + s * S::kK;

      float s_acc[BK / 2];  // written by the first product (kk = 0)
      mbar_wait(&k_full[s], ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss<0>(s_acc,
                    desc_sw128(q_wg + (kk / 4) * S::kQBox + (kk % 4) * 32,
                               16, kGroupBytes),
                    desc_sw128(kt + (kk / 4) * S::kKBox + (kk % 4) * 32, 16,
                               kGroupBytes),
                    kk > 0);
      wgmma_commit();
      wgmma_wait<0>();  // this tile's S and the tile before's P V
      fence_regs(s_acc);
      fence_regs(o_acc);
      fence_regs(p_frag);
      if (it > 0) mbar_arrive(&empty[(it - 1) % kStages]);

      // online softmax on the fragment, base 2
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int qi = qi0 + 8 * rr;
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int i = 4 * j + 2 * rr + c, kj = k0 + 8 * j + c_in + c;
            float x = s_acc[i] * a.scale_log2;
            if (kj >= Lk)
              x = -CUDART_INF_F;  // not a key at all: p = 0
            else if (a.causal && kj > qi + q_offset)
              x = kMasked2;
            s_acc[i] = x;
            mx = fmaxf(mx, x);
          }
        const float m_new = fmaxf(m_r[rr], quad_max(mx));
        const float corr = ex2(m_r[rr] - m_new);
        m_r[rr] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int i = 4 * j + 2 * rr + c;
            s_acc[i] = ex2(s_acc[i] - m_new);
            sum += s_acc[i];
          }
        l_r[rr] = l_r[rr] * corr + sum;  // this thread's columns only
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
          o_acc[4 * j + 2 * rr] *= corr;
          o_acc[4 * j + 2 * rr + 1] *= corr;
        }
      }
      to_a_frag<BK>(s_acc, p_frag);

      mbar_wait(&v_full[s], ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<1>(o_acc, p_frag[kk],
                    desc_sw128(vt + kk * 16 * kRowBytes, S::kKBox,
                               kGroupBytes),
                    1);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(o_acc);
    fence_regs(p_frag);

    float inv[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const float l = quad_sum(l_r[rr]);
      const float l_safe = l == 0.f ? 1.f : l;
      inv[rr] = 1.f / l_safe;
      const int row = 64 * cw + r_in + 8 * rr;
      if (row < nq && (lane & 3) == 0)
        a.lse[a.slse.at(b, h, q0 + row)] = m_r[rr] * kLn2 + logf(l_safe);
    }
    store_frag<DP>(o_acc, a.o, a.so, b, h, q0 + 64 * cw, nq - 64 * cw, a.D,
                   inv[0], inv[1]);
  }
}

// ---- backward: dk, dv ---------------------------------------------------

template <int DP, int CW>
struct DkvSmem {
  static constexpr int kBoxes = DP / 64, kBKey = 64 * CW;
  static constexpr uint32_t kKBox = kBKey * kRowBytes, kK = kBoxes * kKBox;
  static constexpr uint32_t kQBox = 64 * kRowBytes, kQ = kBoxes * kQBox;
  // per stage: the tile's 64 lse and delta, and per consumer warpgroup
  // its 64 |q| and |dO|, f32
  static constexpr uint32_t kStats = 2 * kK + 2 * kStages * kQ;
  static constexpr uint32_t kStatFloats = 64 * (2 + 2 * CW);
  static constexpr uint32_t kBars = kStats + kStages * kStatFloats * 4;
  static constexpr size_t kBytes = 1024 + kBars + 8 * (1 + 2 * kStages);
  static_assert(kBytes <= 232448, "over a block's shared memory");
};

template <int DP, int CW>
__global__ void __launch_bounds__(128 * (CW + 1), 1)
    flash_bwd_dkv_tc(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const BwdArgs a) {
  using S = DkvSmem<DP, CW>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* k_s = align1024(smem_raw);
  uint8_t* v_s = k_s + S::kK;
  uint8_t* q_s = v_s + S::kK;            // stage s at q_s + s kQ
  uint8_t* do_s = q_s + kStages * S::kQ;  // stage s at do_s + s kQ
  // stage s at stat_s + kStatFloats s: lse, delta of its 64 queries, then
  // |q|, |dO| per consumer warpgroup
  float* stat_s = reinterpret_cast<float*>(k_s + S::kStats);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(k_s + S::kBars);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * S::kBKey;
  const int Lq = a.Lq, Lk = a.Lk, q_offset = Lk - Lq;
  // query tiles before the first query that attends key k0 are skipped
  const int q_begin = a.causal ? max(0, k0 - q_offset) / 64 * 64 : 0;
  const int n_tiles = q_begin < Lq ? (Lq - q_begin + 63) / 64 : 0;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1 + 32);  // the TMA thread and the stats warp
      mbar_init(&empty[s], 128 * CW);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    if constexpr (CW == 2) regs_dealloc<40>();
    if (threadIdx.x == 0) {
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      tma_prefetch_map(&tdo);
      mbar_arrive_expect_tx(kv_full, 2 * S::kK);
      for (int x = 0; x < S::kBoxes; ++x) {
        tma_load_4d(k_s + x * S::kKBox, &tk, kv_full, 64 * x, k0, h, b);
        tma_load_4d(v_s + x * S::kKBox, &tv, kv_full, 64 * x, k0, h, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages, row = q_begin + 64 * it;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * S::kQ);
        for (int x = 0; x < S::kBoxes; ++x) {
          tma_load_4d(q_s + s * S::kQ + x * S::kQBox, &tq, &full[s], 64 * x,
                      row, h, b);
          tma_load_4d(do_s + s * S::kQ + x * S::kQBox, &tdo, &full[s],
                      64 * x, row, h, b);
        }
      }
    } else if (threadIdx.x >= 32 && threadIdx.x < 64) {
      // the stats warp: each tile's lse and delta (per-row f32, h floats
      // apart: too narrow for a TMA box) by plain loads into the stage
      const int lane = threadIdx.x - 32;
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages, row = q_begin + 64 * it;
        float* st_s = stat_s + S::kStatFloats * s;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        for (int i = lane; i < 64; i += 32) {
          const int qi = row + i;
          const bool in = qi < Lq;
          st_s[i] = in ? a.lse[a.slse.at(b, h, qi)] : 0.f;
          st_s[64 + i] = in ? a.delta[a.sdelta.at(b, h, qi)] : 0.f;
        }
        mbar_arrive(&full[s]);
      }
    }
  } else {  // consumer warpgroups: 64 keys each
    if constexpr (CW == 2) regs_alloc<232>();
    const int cw = threadIdx.x / 128 - 1;
    const int t = threadIdx.x & 127, lane = t & 31;
    const int r_in = (t >> 5) * 16 + (lane >> 2), c_in = (lane & 3) * 2;
    const int kj0 = k0 + 64 * cw + r_in;  // fragment rows kj0, kj0 + 8
    const uint8_t* k_wg = k_s + 64 * cw * kRowBytes;
    const uint8_t* v_wg = v_s + 64 * cw * kRowBytes;
    float dk_acc[DP / 2], dv_acc[DP / 2];
    zero(dk_acc);
    zero(dv_acc);
    // the dots' part of the bound per fragment row, per unit of the
    // query-side norm
    float ek[2], ev[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int kj = kj0 + 8 * rr;
      const bool in = kj < Lk;
      ek[rr] =
          in ? kDotErr * a.scale * row_norm(a.k + a.sk.at(b, h, kj), a.D)
             : 0.f;
      ev[rr] = in ? kDotErr * row_norm(a.v + a.sv.at(b, h, kj), a.D) : 0.f;
    }

    // P^T and dS^T of the tile before, the register A of its dV and dK
    // products, which run on while this tile's S^T and dP^T are issued
    uint32_t pt_frag[4][4], dst_frag[4][4];
    mbar_wait(kv_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages, qt0 = q_begin + 64 * it;
      const uint8_t* qt = q_s + s * S::kQ;
      const uint8_t* dot = do_s + s * S::kQ;

      float st[32], dpt[32];  // S^T, dP^T: 64 keys x 64 queries
      mbar_wait(&full[s], (it / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss<0>(st,
                    desc_sw128(k_wg + (kk / 4) * S::kKBox + off, 16,
                               kGroupBytes),
                    desc_sw128(qt + (kk / 4) * S::kQBox + off, 16,
                               kGroupBytes),
                    kk > 0);
        wgmma_ss<0>(dpt,
                    desc_sw128(v_wg + (kk / 4) * S::kKBox + off, 16,
                               kGroupBytes),
                    desc_sw128(dot + (kk / 4) * S::kQBox + off, 16,
                               kGroupBytes),
                    kk > 0);
      }
      wgmma_commit();
      // the norms of the tile's q and dO rows, one row a thread, while the
      // products run
      float* stt = stat_s + S::kStatFloats * s;
      float* norms = stt + 64 * (2 + 2 * cw);
      norms[t] = tile_row_norm(t < 64 ? qt : dot, S::kQBox, t & 63, a.D);
      warpgroup_sync(1 + cw);
      // float2 of this thread's column pair in each block of 8
      const float2* lse_t = reinterpret_cast<const float2*>(stt);
      const float2* dlt_t = lse_t + 32;
      const float2* nq_t = reinterpret_cast<const float2*>(norms);
      const float2* ndo_t = nq_t + 32;
      wgmma_wait<0>();  // this tile's S^T, dP^T and the dV, dK before
      fence_regs(st);
      fence_regs(dpt);
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      fence_regs(pt_frag);
      fence_regs(dst_frag);
      if (it > 0) mbar_arrive(&empty[(it - 1) % kStages]);

      // fast p and ds on the fragment; `exact` marks the elements whose
      // rounding to bf16 could differ from the plain version's. A tile
      // with no masked element and no row or column past the data skips
      // the mask.
      uint32_t exact = 0;
      auto fast = [&](auto masked) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int pair = 4 * j + (c_in >> 1);
          const float2 l = lse_t[pair], dl = dlt_t[pair];
          const float2 cx = {fmaf(2.f * kRound, fabsf(l.x), kExp),
                             fmaf(2.f * kRound, fabsf(l.y), kExp)};
          const float2 nq = nq_t[pair], ndo = ndo_t[pair];
#pragma unroll
          for (int rr = 0; rr < 2; ++rr)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int i = 4 * j + 2 * rr + c;
              const float x =
                  __fsub_rn(__fmul_rn(st[i], a.scale), c ? l.y : l.x);
              float p = ex2(x * kLog2e);
              if constexpr (decltype(masked)::value) {
                const int qi = qt0 + 8 * j + c_in + c, kj = kj0 + 8 * rr;
                if (!(qi < Lq && kj < Lk && !(a.causal && kj > qi + q_offset)))
                  p = 0.f;
              }
              const float ds = p * (dpt[i] - (c ? dl.y : dl.x));
              const float eps = fmaf(ek[rr], c ? nq.y : nq.x,
                                     fmaf(3.f * kRound, fabsf(x),
                                          c ? cx.y : cx.x));
              const float err_ds = fmaf(
                  p, fmaf(ev[rr], c ? ndo.y : ndo.x, kRound * fabsf(dpt[i])),
                  fabsf(ds) * (eps + 2.f * kRound));
              if (near_midpoint(p, p * eps) || near_midpoint(ds, err_ds))
                exact |= 1u << i;
              st[i] = p;
              dpt[i] = ds;
            }
        }
      };
      const int key_last = k0 + 64 * cw + 63;
      if (qt0 + 64 <= Lq && key_last < Lk &&
          (!a.causal || key_last <= qt0 + q_offset))
        fast(std::false_type{});
      else
        fast(std::true_type{});
      // those recomputed as the plain version computes them
      while (exact) {
        const int i = __ffs(exact) - 1;
        exact &= exact - 1;
        const int kr = r_in + 8 * ((i >> 1) & 1);
        const int col = 8 * (i >> 2) + c_in + (i & 1);
        const float s_ex =
            plain_dot(k_wg, S::kKBox, kr, qt, S::kQBox, col, a.D);
        const float dp_ex =
            plain_dot(v_wg, S::kKBox, kr, dot, S::kQBox, col, a.D);
        const float p = expf(__fsub_rn(__fmul_rn(s_ex, a.scale), stt[col]));
        const float ds = __fmul_rn(p, __fsub_rn(dp_ex, stt[64 + col]));
#pragma unroll
        for (int e = 0; e < 32; ++e)
          if (e == i) {
            st[e] = p;
            dpt[e] = ds;
          }
      }
      to_a_frag<64>(st, pt_frag);
      to_a_frag<64>(dpt, dst_frag);

      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs<1>(dv_acc, pt_frag[kk],
                    desc_sw128(dot + kk * 16 * kRowBytes, S::kQBox,
                               kGroupBytes),
                    1);
        wgmma_rs<1>(dk_acc, dst_frag[kk],
                    desc_sw128(qt + kk * 16 * kRowBytes, S::kQBox,
                               kGroupBytes),
                    1);
      }
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    fence_regs(pt_frag);
    fence_regs(dst_frag);

    const int nk = min(S::kBKey, Lk - k0) - 64 * cw;
    store_frag<DP>(dk_acc, a.dk, a.sdk, b, h, k0 + 64 * cw, nk, a.D, a.scale,
                   a.scale);
    store_frag<DP>(dv_acc, a.dv, a.sdv, b, h, k0 + 64 * cw, nk, a.D, 1.f,
                   1.f);
  }
}

// ---- backward: dq -------------------------------------------------------

template <int DP, int CW>
struct DqSmem {
  static constexpr int kBoxes = DP / 64, kBQ = 64 * CW;
  static constexpr uint32_t kQBox = kBQ * kRowBytes, kQ = kBoxes * kQBox;
  static constexpr uint32_t kKBox = 64 * kRowBytes, kK = kBoxes * kKBox;
  // per stage and consumer warpgroup: the largest |k| (2 warps) and |v|
  // (2 warps) of the tile, f32
  static constexpr uint32_t kStats = 2 * kQ + 2 * kStages * kK;
  static constexpr uint32_t kBars = kStats + kStages * CW * 4 * 4;
  static constexpr size_t kBytes = 1024 + kBars + 8 * (1 + 2 * kStages);
  static_assert(kBytes <= 232448, "over a block's shared memory");
};

template <int DP, int CW>
__global__ void __launch_bounds__(128 * (CW + 1), 1)
    flash_bwd_dq_tc(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const BwdArgs a) {
  using S = DqSmem<DP, CW>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = align1024(smem_raw);
  uint8_t* do_s = q_s + S::kQ;
  uint8_t* k_s = do_s + S::kQ;            // stage s at k_s + s kK
  uint8_t* v_s = k_s + kStages * S::kK;   // stage s at v_s + s kK
  // stage s, consumer warpgroup w at stat_s + 4 (CW s + w): the per-warp
  // maxima of |k| and |v| over its 64 keys
  float* stat_s = reinterpret_cast<float*>(q_s + S::kStats);
  uint64_t* qd_full = reinterpret_cast<uint64_t*>(q_s + S::kBars);
  uint64_t* full = qd_full + 1;
  uint64_t* empty = full + kStages;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * S::kBQ;
  const int Lq = a.Lq, Lk = a.Lk, q_offset = Lk - Lq;
  const int nq = min(S::kBQ, Lq - q0);
  // keys past the last one a row of this tile attends add nothing
  const int k_end = a.causal ? min(Lk, q0 + nq + q_offset) : Lk;
  const int n_tiles = k_end > 0 ? (k_end + 63) / 64 : 0;

  if (threadIdx.x == 0) {
    mbar_init(qd_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * CW);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    if constexpr (CW == 2) regs_dealloc<40>();
    if (threadIdx.x == 0) {
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      tma_prefetch_map(&tdo);
      mbar_arrive_expect_tx(qd_full, 2 * S::kQ);
      for (int x = 0; x < S::kBoxes; ++x) {
        tma_load_4d(q_s + x * S::kQBox, &tq, qd_full, 64 * x, q0, h, b);
        tma_load_4d(do_s + x * S::kQBox, &tdo, qd_full, 64 * x, q0, h, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * S::kK);
        for (int x = 0; x < S::kBoxes; ++x) {
          tma_load_4d(k_s + s * S::kK + x * S::kKBox, &tk, &full[s], 64 * x,
                      64 * it, h, b);
          tma_load_4d(v_s + s * S::kK + x * S::kKBox, &tv, &full[s], 64 * x,
                      64 * it, h, b);
        }
      }
    }
  } else {  // consumer warpgroups: 64 queries each
    if constexpr (CW == 2) regs_alloc<232>();
    const int cw = threadIdx.x / 128 - 1;
    const int t = threadIdx.x & 127, lane = t & 31;
    const int r_in = (t >> 5) * 16 + (lane >> 2), c_in = (lane & 3) * 2;
    const int qi0 = q0 + 64 * cw + r_in;  // fragment rows qi0, qi0 + 8
    const uint8_t* q_wg = q_s + 64 * cw * kRowBytes;
    const uint8_t* do_wg = do_s + 64 * cw * kRowBytes;
    // per fragment row: lse, delta, and the bound's parts: the dots' per
    // unit of the key-side norm, lse's
    float lse[2], dlt[2], eq[2], edo[2], cx[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int qi = qi0 + 8 * rr;
      const bool in = qi < Lq;
      lse[rr] = in ? a.lse[a.slse.at(b, h, qi)] : 0.f;
      dlt[rr] = in ? a.delta[a.sdelta.at(b, h, qi)] : 0.f;
      eq[rr] =
          in ? kDotErr * a.scale * row_norm(a.q + a.sq.at(b, h, qi), a.D)
             : 0.f;
      edo[rr] =
          in ? kDotErr * row_norm(a.dout + a.sdo.at(b, h, qi), a.D) : 0.f;
      cx[rr] = fmaf(2.f * kRound, fabsf(lse[rr]), kExp);
    }
    float dq_acc[DP / 2];
    zero(dq_acc);

    // dS of the tile before, the register A of its dQ product, which runs
    // on while this tile's S and dP are issued
    uint32_t ds_frag[4][4];
    mbar_wait(qd_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages, k0 = 64 * it;
      const uint8_t* kt = k_s + s * S::kK;
      const uint8_t* vt = v_s + s * S::kK;

      float s_acc[32], dp_acc[32];  // 64 queries x 64 keys
      mbar_wait(&full[s], (it / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss<0>(s_acc,
                    desc_sw128(q_wg + (kk / 4) * S::kQBox + off, 16,
                               kGroupBytes),
                    desc_sw128(kt + (kk / 4) * S::kKBox + off, 16,
                               kGroupBytes),
                    kk > 0);
        wgmma_ss<0>(dp_acc,
                    desc_sw128(do_wg + (kk / 4) * S::kQBox + off, 16,
                               kGroupBytes),
                    desc_sw128(vt + (kk / 4) * S::kKBox + off, 16,
                               kGroupBytes),
                    kk > 0);
      }
      wgmma_commit();
      // the largest norm of the tile's k rows and of its v rows (one row
      // a thread) while the products run
      float* wmax = stat_s + 4 * (CW * s + cw);
      const float wm = warp_max_nonneg(
          tile_row_norm(t < 64 ? kt : vt, S::kKBox, t & 63, a.D));
      if (lane == 0) wmax[t >> 5] = wm;
      warpgroup_sync(1 + cw);
      // the bound's parts per fragment row for this tile: relative (c)
      // and absolute per unit p (e)
      const float nk_max = fmaxf(wmax[0], wmax[1]);
      const float nv_max = fmaxf(wmax[2], wmax[3]);
      float c_bound[2], e_bound[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        c_bound[rr] = fmaf(eq[rr], nk_max, cx[rr]);
        e_bound[rr] = fmaf(edo[rr], nv_max, kRound * fabsf(dlt[rr]));
      }
      wgmma_wait<0>();  // this tile's S, dP and the dQ product before
      fence_regs(s_acc);
      fence_regs(dp_acc);
      fence_regs(dq_acc);
      fence_regs(ds_frag);
      if (it > 0) mbar_arrive(&empty[(it - 1) % kStages]);

      // fast ds on the fragment; `exact` marks the elements whose rounding
      // to bf16 could differ from the plain version's. A tile with no
      // masked element and no row or column past the data skips the mask.
      uint32_t exact = 0;
      auto fast = [&](auto masked) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int rr = 0; rr < 2; ++rr)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int i = 4 * j + 2 * rr + c;
              const float x =
                  __fsub_rn(__fmul_rn(s_acc[i], a.scale), lse[rr]);
              float p = ex2(x * kLog2e);
              if constexpr (decltype(masked)::value) {
                const int qi = qi0 + 8 * rr, kj = k0 + 8 * j + c_in + c;
                if (!(kj < Lk && qi < Lq && !(a.causal && kj > qi + q_offset)))
                  p = 0.f;
              }
              const float ds = p * (dp_acc[i] - dlt[rr]);
              const float eps = fmaf(3.f * kRound, fabsf(x), c_bound[rr]);
              const float err_ds =
                  fmaf(p, e_bound[rr], fabsf(ds) * (eps + 3.f * kRound));
              if (near_midpoint(ds, err_ds)) exact |= 1u << i;
              dp_acc[i] = ds;
            }
        }
      };
      const int query_first = q0 + 64 * cw;
      if (query_first + 64 <= Lq && k0 + 64 <= Lk &&
          (!a.causal || k0 + 63 <= query_first + q_offset))
        fast(std::false_type{});
      else
        fast(std::true_type{});
      // those recomputed as the plain version computes them
      while (exact) {
        const int i = __ffs(exact) - 1;
        exact &= exact - 1;
        const int rr = (i >> 1) & 1, qr = r_in + 8 * rr;
        const int col = 8 * (i >> 2) + c_in + (i & 1);
        const float s_ex =
            plain_dot(q_wg, S::kQBox, qr, kt, S::kKBox, col, a.D);
        const float dp_ex =
            plain_dot(do_wg, S::kQBox, qr, vt, S::kKBox, col, a.D);
        const float l = rr ? lse[1] : lse[0], d = rr ? dlt[1] : dlt[0];
        const float p = expf(__fsub_rn(__fmul_rn(s_ex, a.scale), l));
        const float ds = __fmul_rn(p, __fsub_rn(dp_ex, d));
#pragma unroll
        for (int e = 0; e < 32; ++e)
          if (e == i) dp_acc[e] = ds;
      }
      to_a_frag<64>(dp_acc, ds_frag);

      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<1>(dq_acc, ds_frag[kk],
                    desc_sw128(kt + kk * 16 * kRowBytes, S::kKBox,
                               kGroupBytes),
                    1);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(dq_acc);
    fence_regs(ds_frag);
    store_frag<DP>(dq_acc, a.dq, a.sdq, b, h, q0 + 64 * cw, nq - 64 * cw,
                   a.D, a.scale, a.scale);
  }
}

// ---- host ---------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library links no libcuda
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The 4-D map (d, l, h, b) of one bf16 operand, boxes of 64 columns by
// `box_rows` rows, 128-byte swizzle, zero fill outside the tensor. A
// dim of extent 1 is never stepped, so its stride is not read.
cudaError_t make_map(CUtensorMap* map, const void* base, const Stride3& s,
                     int D, int L, int H, int B, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const long long e = 2;  // bytes per bf16
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)L, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {
      L > 1 ? (cuuint64_t)(s.l * e) : 16, H > 1 ? (cuuint64_t)(s.h * e) : 16,
      B > 1 ? (cuuint64_t)(s.b * e) : 16};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

Stride3 stride3(const long long* s, int t) {
  return Stride3{s[3 * t], s[3 * t + 2], s[3 * t + 1]};
}

template <typename F>
int by_padded_dim(int D, F&& f) {
  if (D <= 64) return f(std::integral_constant<int, 64>{});
  return f(std::integral_constant<int, 128>{});
}
template <typename F>
int by_consumers(int rows, F&& f) {
  if (rows == 64) return f(std::integral_constant<int, 1>{});
  return f(std::integral_constant<int, 2>{});
}

}  // namespace

// The bf16 forward (q, k, v, o, lse) with 15 element strides, (batch,
// row, head) of each; bq, bk the row caps, 64 or 128.
int ff_flash_fwd_tc(const void* q, const void* k, const void* v, void* o,
                    float* lse, const long long* strides, int B, int Lq,
                    int Lk, int H, int D, float scale, int causal, int bq,
                    int bk, cudaStream_t stream) {
  if ((bq != 64 && bq != 128) || (bk != 64 && bk != 128) || D > 128)
    return (int)cudaErrorInvalidValue;
  FwdArgs a{static_cast<__nv_bfloat16*>(o), lse, stride3(strides, 3),
            stride3(strides, 4), Lq, Lk, D, causal, scale * kLog2e};
  return by_padded_dim(D, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    return by_consumers(bq, [&](auto cw) {
      constexpr int CW = decltype(cw)::value;
      auto launch = [&](auto bkc) {
        constexpr int BK = decltype(bkc)::value;
        CUtensorMap mq, mk, mv;
        cudaError_t err = make_map(&mq, q, stride3(strides, 0), D, Lq, H, B,
                                   64 * CW);
        if (err == cudaSuccess)
          err = make_map(&mk, k, stride3(strides, 1), D, Lk, H, B, BK);
        if (err == cudaSuccess)
          err = make_map(&mv, v, stride3(strides, 2), D, Lk, H, B, BK);
        const size_t smem = FwdSmem<DP, BK, CW>::kBytes;
        auto kernel = flash_fwd_tc<DP, BK, CW>;
        if (err == cudaSuccess) err = allow_smem(kernel, smem);
        if (err != cudaSuccess) return (int)err;
        const dim3 grid((Lq + 64 * CW - 1) / (64 * CW), H, B);
        kernel<<<grid, 128 * (CW + 1), smem, stream>>>(mq, mk, mv, a);
        return (int)cudaGetLastError();
      };
      // at d 128 the O accumulator takes 64 registers: keys stream 64 at
      // a time
      if constexpr (DP == 128)
        return launch(std::integral_constant<int, 64>{});
      else if (bk == 64)
        return launch(std::integral_constant<int, 64>{});
      else
        return launch(std::integral_constant<int, 128>{});
    });
  });
}

// The bf16 backward (q, k, v, dout, lse, delta, dq, dk, dv) with 27
// element strides; dq's blocks hold bq queries, dk / dv's bk keys (64 or
// 128). Two launches: dq, then dk and dv.
int ff_flash_bwd_tc(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dq, void* dk, void* dv, const long long* strides,
                    int B, int Lq, int Lk, int H, int D, float scale,
                    int causal, int bq, int bk, cudaStream_t stream) {
  if ((bq != 64 && bq != 128) || (bk != 64 && bk != 128) || D > 128)
    return (int)cudaErrorInvalidValue;
  using bf16 = const __nv_bfloat16*;
  BwdArgs a{static_cast<bf16>(q),    static_cast<bf16>(k),
            static_cast<bf16>(v),    static_cast<bf16>(dout),
            lse,
            delta,
            static_cast<__nv_bfloat16*>(dq),
            static_cast<__nv_bfloat16*>(dk),
            static_cast<__nv_bfloat16*>(dv),
            stride3(strides, 0),     stride3(strides, 1),
            stride3(strides, 2),     stride3(strides, 3),
            stride3(strides, 4),     stride3(strides, 5),
            stride3(strides, 6),     stride3(strides, 7),
            stride3(strides, 8),     Lq,
            Lk,                      D,
            causal,                  scale};
  return by_padded_dim(D, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    int err = by_consumers(bq, [&](auto cw) {
      constexpr int CW = decltype(cw)::value;
      CUtensorMap mq, mk, mv, mdo;
      cudaError_t e = make_map(&mq, q, stride3(strides, 0), D, Lq, H, B,
                               64 * CW);
      if (e == cudaSuccess)
        e = make_map(&mdo, dout, stride3(strides, 3), D, Lq, H, B, 64 * CW);
      if (e == cudaSuccess)
        e = make_map(&mk, k, stride3(strides, 1), D, Lk, H, B, 64);
      if (e == cudaSuccess)
        e = make_map(&mv, v, stride3(strides, 2), D, Lk, H, B, 64);
      const size_t smem = DqSmem<DP, CW>::kBytes;
      auto kernel = flash_bwd_dq_tc<DP, CW>;
      if (e == cudaSuccess) e = allow_smem(kernel, smem);
      if (e != cudaSuccess) return (int)e;
      const dim3 grid((Lq + 64 * CW - 1) / (64 * CW), H, B);
      kernel<<<grid, 128 * (CW + 1), smem, stream>>>(mq, mk, mv, mdo, a);
      return (int)cudaGetLastError();
    });
    if (err != 0) return err;
    return by_consumers(bk, [&](auto cw) {
      constexpr int CW = decltype(cw)::value;
      CUtensorMap mq, mk, mv, mdo;
      cudaError_t e = make_map(&mq, q, stride3(strides, 0), D, Lq, H, B, 64);
      if (e == cudaSuccess)
        e = make_map(&mdo, dout, stride3(strides, 3), D, Lq, H, B, 64);
      if (e == cudaSuccess)
        e = make_map(&mk, k, stride3(strides, 1), D, Lk, H, B, 64 * CW);
      if (e == cudaSuccess)
        e = make_map(&mv, v, stride3(strides, 2), D, Lk, H, B, 64 * CW);
      const size_t smem = DkvSmem<DP, CW>::kBytes;
      auto kernel = flash_bwd_dkv_tc<DP, CW>;
      if (e == cudaSuccess) e = allow_smem(kernel, smem);
      if (e != cudaSuccess) return (int)e;
      const dim3 grid((Lk + 64 * CW - 1) / (64 * CW), H, B);
      kernel<<<grid, 128 * (CW + 1), smem, stream>>>(mq, mk, mv, mdo, a);
      return (int)cudaGetLastError();
    });
  });
}

// Dynamic shared memory, in bytes, of one instantiation: kernel 0 the
// forward (bk keys per streamed tile), 1 dq, 2 dk / dv; dp 64 or 128, cw
// 1 or 2 consumer warpgroups. -1 for an instantiation that does not exist.
extern "C" long long ff_flash_tc_smem_bytes(int kernel, int dp, int cw,
                                            int bk) {
  if ((dp != 64 && dp != 128) || (cw != 1 && cw != 2)) return -1;
  return by_padded_dim(dp, [&](auto dpc) {
    constexpr int DP = decltype(dpc)::value;
    return by_consumers(64 * cw, [&](auto cwc) -> int {
      constexpr int CW = decltype(cwc)::value;
      if (kernel == 1) return (int)DqSmem<DP, CW>::kBytes;
      if (kernel == 2) return (int)DkvSmem<DP, CW>::kBytes;
      if (kernel != 0) return -1;
      if (bk == 64) return (int)FwdSmem<DP, 64, CW>::kBytes;
      if constexpr (DP == 64)
        if (bk == 128) return (int)FwdSmem<DP, 128, CW>::kBytes;
      return -1;
    });
  });
}
