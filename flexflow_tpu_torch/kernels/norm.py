"""LayerNorm, RMSNorm and softmax, forward and backward: CUDA kernels,
plain versions and the autograd Functions.

`layernorm_fwd` / `layernorm_bwd` replace flexflow_tpu/kernels/pallas/
norm.py `_ln_fwd` / `_ln_bwd` (`fused_layernorm`); `rmsnorm_fwd` /
`rmsnorm_bwd` replace `_rms_fwd` / `_rms_bwd` (`fused_rmsnorm`);
`softmax_fwd` / `softmax_bwd` replace `_softmax_call` with
`_softmax_fwd_kernel` / `_softmax_bwd_kernel` (`fused_softmax`);
`layernorm`, `rmsnorm` and `softmax` are the differentiable ops, saving
what the JAX custom VJPs save. All normalize
the trailing axis with leading dims flattened into rows, compute in f32
and store in x's dtype. The kernels are csrc/norm.cu. On the card all
are bound by bytes (one read and one write per element, a few operations
each). Softmax forward, RMSNorm forward and LayerNorm forward take a
route that `softmax_plan` / `rmsnorm_plan` / `layernorm_fwd_plan` choose
from the shape alone (rows, N, dtype: never a value, so no host sync):
softmax "rows" (N <= ROWS_MAX_N: lanes of a warp per row, shuffles
only), "block" (a wide row a CTA in registers, 16-byte vectors),
"cluster" (a wide row split over a thread-block cluster of 2-8 CTAs
that merge their (max, sum) in rank order through distributed shared
memory: few rows) and "loop" (rows too wide for a cluster's registers:
three passes, re-reads from L2); RMSNorm "warp" (N <= RMS_WARP_MAX_N:
a warp a row in registers, gamma kept in registers) and "block" (a row
a block, staged in shared memory); LayerNorm "warp" (N <=
LN_FWD_WARP_MAX_N: the RMSNorm warp route with the mean, its two sums
taken from the registers, beta kept beside gamma) and "block" (a row a
block, staged in shared memory as f32). `softmax_split_plain`,
`rmsnorm_warp_plain` and `layernorm_fwd_warp_plain` repeat the cluster
and warp routes' arithmetic in torch. LayerNorm backward and RMSNorm
backward take a route that `layernorm_bwd_plan` / `rmsnorm_bwd_plan`
choose from the shape alone: "warp" (N <= 2048: a warp a row, x
and dy in registers through 16-byte loads, gamma kept, the row sums
through shuffles only, dgamma and dbeta summed per lane over the warp's
rows and per CTA over its warps, one partial row a CTA of a persistent
grid; the column sums a programmatic dependent launch) and "block" (a
few rows a block, dgamma and dbeta summed per block, then over blocks in
a second launch); both add in a fixed order. RMSNorm's routes are
LayerNorm's without the mean (and without dbeta);
`layernorm_bwd_warp_plain` and `rmsnorm_bwd_warp_plain` repeat the warp
route's arithmetic in torch. Softmax backward takes a route that
`softmax_bwd_plan` chooses from the shape alone, the forward's routes
with a second operand: "rows" (N <= SOFTMAX_BWD_ROWS_MAX_N: 2^k lanes a
row, y and dy in registers, the sum of y * dy by shuffles only),
"block" (a wide row a CTA, y and dy held as loaded 16-byte vectors),
"cluster" (a row split over 2-8 CTAs whose partial sums meet in rank
order through distributed shared memory) and "loop" (a CTA a row, two
passes, the second read from L2); every sum in a fixed order, so
`softmax_bwd_split_plain` gives each route's bits in torch.

A wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

import functools
from typing import Dict, NamedTuple

import torch

from . import _build

# kernel launches per wrapper (layernorm_bwd's and rmsnorm_bwd's two
# launches count once), a plain count the serving and training paths are
# read by
LAUNCHES: Dict[str, int] = {"layernorm_fwd": 0, "layernorm_bwd": 0,
                            "rmsnorm_fwd": 0, "rmsnorm_bwd": 0,
                            "softmax_fwd": 0, "softmax_bwd": 0}
# calls by route of every planned kernel (csrc/norm.cu SoftmaxRoute,
# RmsRoute, LnFwdRoute, LnBwdRoute), the codes the C entries take
SOFTMAX_ROUTES = {"loop": 0, "rows": 1, "block": 2, "cluster": 3}
SOFTMAX_BWD_ROUTES = SOFTMAX_ROUTES  # the same codes (csrc/norm.cu)
RMSNORM_ROUTES = {"block": 0, "warp": 1}
LN_FWD_ROUTES = {"block": 0, "warp": 1}
LN_BWD_ROUTES = {"block": 0, "warp": 1}
RMS_BWD_ROUTES = LN_BWD_ROUTES  # the same launcher, without the mean
ROUTES: Dict[str, int] = {
    f"{name}/{r}": 0 for name, routes in (
        ("softmax_fwd", SOFTMAX_ROUTES), ("rmsnorm_fwd", RMSNORM_ROUTES),
        ("layernorm_fwd", LN_FWD_ROUTES), ("layernorm_bwd", LN_BWD_ROUTES),
        ("rmsnorm_bwd", RMS_BWD_ROUTES),
        ("softmax_bwd", SOFTMAX_BWD_ROUTES)) for r in routes}
# SMs of the card the plans assume when not told (H100 SXM)
H100_SMS = 132
# softmax "rows": N up to ROWS_MAX_N (lanes a row: the power of two at or
# above N, 32 from N = 33), ROWS_THREADS a block, at most
# ROWS_BLOCKS_PER_SM blocks an SM, the grid walking the rows
ROWS_MAX_N = 1024
ROWS_THREADS = 128
ROWS_BLOCKS_PER_SM = 8
# softmax "block" / "cluster": a CTA of 128-1024 threads holds its slice
# as f32 values in registers, up to REGS_PER_THREAD a thread (fewer
# threads with more values timed as fast or faster than 16 a thread at
# every wide shape, tools/norm_bench.py); a row takes the least
# power-of-two cluster with rows x cluster >= FILL_CTAS (at most
# MAX_CLUSTER, the portable size), or the least that holds it; a row no
# cluster holds takes "loop"
REGS_PER_THREAD = 32
REGS_MIN_THREADS, REGS_MAX_THREADS = 128, 1024
MAX_CLUSTER = 8
FILL_CTAS = 128
LOOP_THREADS = 1024
# RMSNorm "warp": N up to RMS_WARP_MAX_N (x and gamma in registers: at
# most 64 f32 of each a lane), 8 warps a block, at most RMS_BLOCKS_PER_SM
# blocks an SM, the grid walking the rows; "block": 256 threads a row
RMS_WARP_MAX_N = 2048
RMS_WARP_THREADS = 256
RMS_BLOCKS_PER_SM = 2
RMS_BLOCK_THREADS = 256
# LayerNorm forward "warp": N up to LN_FWD_WARP_MAX_N (at most 64 values a
# lane; gamma and beta stay in registers up to 32), up to 8 warps a block
# (fewer for fewer rows than 8 an SM: the rows spread over the SMs), at
# most LN_FWD_BLOCKS_PER_SM blocks an SM, the grid walking the rows;
# "block": 256 threads a row
LN_FWD_WARP_MAX_N = 2048
LN_FWD_WARP_THREADS = 256
LN_FWD_BLOCKS_PER_SM = 2
LN_FWD_BLOCK_THREADS = 256
# LayerNorm and RMSNorm backward "warp" (one kernel): N up to
# LN_BWD_WARP_MAX_N (at most 64 values a lane; x, dy and gamma stay in
# registers up to 32), 8 warps a block, LN_BWD_BLOCKS_PER_SM blocks an SM:
# a CTA writes one partial row of dgamma (and of dbeta); "block": 256
# threads take 8 rows (csrc/norm.cu kLnBwdRows)
LN_BWD_WARP_MAX_N = 2048
LN_BWD_WARP_THREADS = 256
LN_BWD_BLOCKS_PER_SM = 1
LN_BWD_BLOCK_THREADS = 256
LN_BWD_BLOCK_ROWS = 8
# softmax backward "rows": N up to SOFTMAX_BWD_ROWS_MAX_N; lanes a row the
# power of two at or above N / SOFTMAX_BWD_LANE_VALUES, at least 2 (or N)
# and at most 32, then K values a lane (a power of two); ROWS_THREADS a
# block, at most SOFTMAX_BWD_ROWS_BLOCKS_PER_SM blocks an SM walking the
# rows. "block" / "cluster": a thread holds at most SOFTMAX_BWD_VECS
# 16-byte vectors of y and as many of dy as loaded (8 registers a vector
# pair: ptxas gives the bf16 kernel 58 of the 64 a thread of a
# 1024-thread CTA may have), 128-1024 threads a CTA; a row takes the
# least power-of-two cluster with rows x cluster >= SOFTMAX_BWD_FILL_CTAS
# (at most MAX_CLUSTER), or the least that holds it; a row no cluster of
# 8 holds (bf16 N > 262144, f32 N > 131072) takes "loop".
# SOFTMAX_BWD_ROWS_MAX_N, SOFTMAX_BWD_LANE_VALUES and
# SOFTMAX_BWD_FILL_CTAS are the fastest of tools/norm_bench.py --sweep
# (PERF.md, section 6)
SOFTMAX_BWD_ROWS_MAX_N = 512
SOFTMAX_BWD_LANE_VALUES = 4
SOFTMAX_BWD_ROWS_BLOCKS_PER_SM = 8
SOFTMAX_BWD_VECS = 4
SOFTMAX_BWD_FILL_CTAS = 64
# shared memory a block may use; the RMSNorm block route stages a row's
# bytes beside 32 floats of reduction scratch
SMEM_BYTES = 232448
_ESZ = {torch.float32: 4, torch.bfloat16: 2}


class SoftmaxPlan(NamedTuple):
    """How one softmax_fwd call runs on the card (`softmax_plan`)."""
    route: str       # "rows", "block", "cluster" or "loop"
    threads: int     # a block (a CTA)
    blocks: int      # the grid: rows x cluster on "block" / "cluster"
    per_thread: int  # rows: values a lane; block / cluster: 16-byte
    #                  vectors a thread; loop: 0
    lanes: int       # rows: lanes a row; else 0
    cluster: int     # CTAs a row: > 1 only on "cluster"


class RmsNormPlan(NamedTuple):
    """How one rmsnorm_fwd call runs on the card (`rmsnorm_plan`)."""
    route: str    # "warp" or "block"
    threads: int  # a block
    blocks: int   # the grid
    vecs: int     # warp: 16-byte vectors a lane; block: 0


class LnFwdPlan(NamedTuple):
    """How one layernorm_fwd call runs on the card
    (`layernorm_fwd_plan`)."""
    route: str    # "warp" or "block"
    threads: int  # a block
    blocks: int   # the grid
    vecs: int     # warp: 16-byte vectors a lane; block: 0


class LnBwdPlan(NamedTuple):
    """How one layernorm_bwd call runs on the card
    (`layernorm_bwd_plan`)."""
    route: str    # "warp" or "block"
    threads: int  # a block
    blocks: int   # the grid, one partial row of dgamma / dbeta each
    vecs: int     # warp: 16-byte vectors a lane; block: 0


class RmsBwdPlan(NamedTuple):
    """How one rmsnorm_bwd call runs on the card (`rmsnorm_bwd_plan`)."""
    route: str    # "warp" or "block"
    threads: int  # a block
    blocks: int   # the grid, one partial row of dgamma each
    vecs: int     # warp: 16-byte vectors a lane; block: 0


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


def _lane_vecs(n: int, esz: int) -> int:
    """16-byte vectors a lane of the warp routes takes: the power of two
    that holds a row of N in 32 lanes."""
    return _pow2_at_least(-(-(-(-n // (16 // esz))) // 32))


def _shape(name, rows, n, dtype):
    rows, n = int(rows), int(n)
    if rows < 1 or n < 1:
        raise ValueError(f"{name}: rows = {rows} and N = {n} must be >= 1")
    if dtype not in _ESZ:
        raise TypeError(f"{name}: dtype must be float32 or bfloat16, got "
                        f"{dtype}")
    return rows, n, _ESZ[dtype]


def softmax_plan(rows: int, n: int, dtype,
                 sms: int = H100_SMS) -> SoftmaxPlan:
    """The route and launch of softmax_fwd over `rows` rows of N, from the
    shape and dtype alone. N <= ROWS_MAX_N: "rows" (the training step's
    (4096, 2), the tier's (4096, 10)). Wider: the cluster size c is the
    least power of two with rows * c >= FILL_CTAS, capped at MAX_CLUSTER,
    raised to the least that holds the row in registers (1024 threads x
    REGS_PER_THREAD a CTA): c = 1 is "block" (128 x 30522), c > 1
    "cluster" (the 8 decode rows and 16 prefill-chunk rows of 30522: c =
    8); a row more than MAX_CLUSTER CTAs hold takes "loop". Threads per
    CTA: the least power of two that holds the CTA's slice at
    REGS_PER_THREAD values a thread, in [REGS_MIN_THREADS,
    REGS_MAX_THREADS]."""
    rows, n, esz = _shape("softmax_plan", rows, n, dtype)
    if n <= ROWS_MAX_N:
        lanes = min(32, _pow2_at_least(n))
        k = _pow2_at_least(-(-n // 32)) if n > 32 else 1
        per_block = ROWS_THREADS // 32 * (32 // lanes)
        blocks = min(-(-rows // per_block), sms * ROWS_BLOCKS_PER_SM)
        return SoftmaxPlan("rows", ROWS_THREADS, blocks, k, lanes, 1)
    w = 16 // esz
    nvec = -(-n // w)  # at most; a row's head leaves one fewer
    need = _pow2_at_least(-(-nvec // (REGS_MAX_THREADS
                                      * (REGS_PER_THREAD // w))))
    if need > MAX_CLUSTER:
        return SoftmaxPlan("loop", LOOP_THREADS, rows, 0, 0, 1)
    c = max(need, min(MAX_CLUSTER, _pow2_at_least(-(-FILL_CTAS // rows))))
    per_cta = -(-nvec // c)
    threads = min(REGS_MAX_THREADS, max(REGS_MIN_THREADS, _pow2_at_least(
        -(-per_cta * w // REGS_PER_THREAD))))
    return SoftmaxPlan("block" if c == 1 else "cluster", threads, rows * c,
                       -(-per_cta // threads), 0, c)


def rmsnorm_max_n(dtype) -> int:
    """The widest row rmsnorm_fwd takes on the card: the block route's
    row in shared memory (f32 58080, as the parent's f32 staging)."""
    return (SMEM_BYTES - 32 * 4) // _ESZ[dtype]


def rmsnorm_plan(rows: int, n: int, dtype,
                 sms: int = H100_SMS) -> RmsNormPlan:
    """The route and launch of rmsnorm_fwd over `rows` rows of N, from the
    shape and dtype alone: "warp" for N <= RMS_WARP_MAX_N (the tier's
    (4096, 1024)), with the power of two of 16-byte vectors a lane that
    holds the row; "block" up to `rmsnorm_max_n`; wider raises
    ValueError."""
    rows, n, esz = _shape("rmsnorm_plan", rows, n, dtype)
    if n <= RMS_WARP_MAX_N:
        vecs = _lane_vecs(n, esz)
        per_block = RMS_WARP_THREADS // 32
        blocks = min(-(-rows // per_block), sms * RMS_BLOCKS_PER_SM)
        return RmsNormPlan("warp", RMS_WARP_THREADS, blocks, vecs)
    if n > rmsnorm_max_n(dtype):
        raise ValueError(f"rmsnorm_fwd: N={n} > {rmsnorm_max_n(dtype)}, "
                         "the widest row a block stages in shared memory")
    return RmsNormPlan("block", RMS_BLOCK_THREADS, rows, 0)


def layernorm_max_n(dtype) -> int:
    """The widest row layernorm_fwd takes on the card: the block route's
    row in shared memory as f32 whatever x's dtype (58080, where the
    parent's launch failed above it)."""
    _shape("layernorm_max_n", 1, 1, dtype)
    return (SMEM_BYTES - 32 * 4) // 4


def layernorm_fwd_plan(rows: int, n: int, dtype,
                       sms: int = H100_SMS) -> LnFwdPlan:
    """The route and launch of layernorm_fwd over `rows` rows of N, from
    the shape and dtype alone: "warp" for N <= LN_FWD_WARP_MAX_N (every
    path's N = 1024), with the power of two of 16-byte vectors a lane that
    holds the row, ceil(rows / sms) warps a block up to 8 (a decode
    iteration's 8 rows take 8 blocks of one warp, the training step's
    4096 blocks of 8) and at most LN_FWD_BLOCKS_PER_SM blocks an SM;
    "block" up to `layernorm_max_n`; wider raises ValueError."""
    rows, n, esz = _shape("layernorm_fwd_plan", rows, n, dtype)
    if n <= LN_FWD_WARP_MAX_N:
        warps = min(LN_FWD_WARP_THREADS // 32, -(-rows // sms))
        blocks = min(-(-rows // warps), sms * LN_FWD_BLOCKS_PER_SM)
        return LnFwdPlan("warp", 32 * warps, blocks, _lane_vecs(n, esz))
    if n > layernorm_max_n(dtype):
        raise ValueError(f"layernorm_fwd: N={n} > {layernorm_max_n(dtype)}, "
                         "the widest row a block stages in shared memory")
    return LnFwdPlan("block", LN_FWD_BLOCK_THREADS, rows, 0)


def _softmax_bwd_splits(n: int, esz: int, rows: int) -> int:
    """CTAs a row of the softmax backward's register routes takes (1:
    "block", 2-8: "cluster"), or 0 where no cluster of MAX_CLUSTER holds
    it ("loop")."""
    nvec = -(-n // (16 // esz))
    need = _pow2_at_least(-(-nvec // (REGS_MAX_THREADS * SOFTMAX_BWD_VECS)))
    if need > MAX_CLUSTER:
        return 0
    return max(need, min(MAX_CLUSTER,
                         _pow2_at_least(-(-SOFTMAX_BWD_FILL_CTAS // rows))))


def _softmax_bwd_cta(n: int, esz: int, splits: int):
    """(threads, 16-byte vectors a thread) of one CTA of `splits` over a
    row of N: the least power of two of threads in [REGS_MIN_THREADS,
    REGS_MAX_THREADS] that holds the CTA's vectors at SOFTMAX_BWD_VECS a
    thread."""
    per_cta = -(-(-(-n // (16 // esz))) // splits)
    threads = min(REGS_MAX_THREADS, max(REGS_MIN_THREADS, _pow2_at_least(
        -(-per_cta // SOFTMAX_BWD_VECS))))
    return threads, -(-per_cta // threads)


def _softmax_bwd_lanes(n: int):
    """(lanes a row, values a lane) of the softmax backward's rows route."""
    lanes = min(_pow2_at_least(n), 32, max(2, _pow2_at_least(
        -(-n // SOFTMAX_BWD_LANE_VALUES))))
    return lanes, _pow2_at_least(-(-n // lanes))


def softmax_bwd_plan(rows: int, n: int, dtype,
                     sms: int = H100_SMS) -> SoftmaxPlan:
    """The route and launch of softmax_bwd over `rows` rows of N, from the
    shape and dtype alone. N <= SOFTMAX_BWD_ROWS_MAX_N: "rows" (the
    training step's (4096, 2), the tier's (4096, 10)), a persistent grid of
    at most SOFTMAX_BWD_ROWS_BLOCKS_PER_SM blocks an SM. Wider: the
    cluster size c is the least power of two with rows * c >=
    SOFTMAX_BWD_FILL_CTAS, capped at MAX_CLUSTER, raised to the least that
    holds the row at SOFTMAX_BWD_VECS vectors of each operand a thread of
    1024: c = 1 is "block" ((128, 30522), (2048, 32000), (4096, 1024)),
    c > 1 "cluster" ((8, 30522): c = 8, (16, 30522): 4); a row more than
    MAX_CLUSTER CTAs hold takes "loop" (1024 threads a row). N or a grid
    past 2^31 - 1 raises ValueError."""
    rows, n, esz = _shape("softmax_bwd_plan", rows, n, dtype)
    if n > 2 ** 31 - 1 or rows * max(1, _softmax_bwd_splits(
            n, esz, rows)) > 2 ** 31 - 1:
        raise ValueError(f"softmax_bwd: R={rows} N={n}: the kernels index a "
                         "row with 32-bit ints and launch at most 2^31 - 1 "
                         "CTAs")
    if n <= SOFTMAX_BWD_ROWS_MAX_N:
        lanes, k = _softmax_bwd_lanes(n)
        per_block = ROWS_THREADS // 32 * (32 // lanes)
        blocks = min(-(-rows // per_block),
                     sms * SOFTMAX_BWD_ROWS_BLOCKS_PER_SM)
        return SoftmaxPlan("rows", ROWS_THREADS, blocks, k, lanes, 1)
    c = _softmax_bwd_splits(n, esz, rows)
    if c == 0:
        return SoftmaxPlan("loop", LOOP_THREADS, rows, 0, 0, 1)
    threads, vecs = _softmax_bwd_cta(n, esz, c)
    return SoftmaxPlan("block" if c == 1 else "cluster", threads, rows * c,
                       vecs, 0, c)


def _bwd_plan(kernel, plan, rows, n, dtype, sms):
    rows, n, esz = _shape(f"{kernel}_plan", rows, n, dtype)
    if n <= LN_BWD_WARP_MAX_N:
        per_block = LN_BWD_WARP_THREADS // 32
        blocks = min(-(-rows // per_block), sms * LN_BWD_BLOCKS_PER_SM)
        return plan("warp", LN_BWD_WARP_THREADS, blocks, _lane_vecs(n, esz))
    if n > MAX_BWD_COLS:
        raise ValueError(f"{kernel}: N={n} > {MAX_BWD_COLS}, the most a "
                         "block stages in shared memory")
    return plan("block", LN_BWD_BLOCK_THREADS, -(-rows // LN_BWD_BLOCK_ROWS),
                0)


def layernorm_bwd_plan(rows: int, n: int, dtype,
                       sms: int = H100_SMS) -> LnBwdPlan:
    """The route and launch of layernorm_bwd over `rows` rows of N, from
    the shape and dtype alone: "warp" for N <= LN_BWD_WARP_MAX_N (the
    training step's (4096, 1024)), with the power of two of 16-byte
    vectors a lane that holds the row, a persistent grid of at most
    LN_BWD_BLOCKS_PER_SM blocks an SM of 8 warps (so the stride between a
    warp's rows is a multiple of 16 bytes); "block" up to MAX_BWD_COLS,
    8 rows a block; wider raises ValueError."""
    return _bwd_plan("layernorm_bwd", LnBwdPlan, rows, n, dtype, sms)


def rmsnorm_bwd_plan(rows: int, n: int, dtype,
                     sms: int = H100_SMS) -> RmsBwdPlan:
    """`layernorm_bwd_plan`'s routes and grid for rmsnorm_bwd (the same
    kernels without the mean): "warp" for N <= LN_BWD_WARP_MAX_N (the
    tier's (4096, 1024)), one partial row of dgamma a block; "block" up
    to MAX_BWD_COLS; wider raises ValueError."""
    return _bwd_plan("rmsnorm_bwd", RmsBwdPlan, rows, n, dtype, sms)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _empty_in_phase(x):
    """An empty tensor like contiguous x at x's 16-byte phase, so that a
    row of both starts at the same distance from a 16-byte boundary: the
    vector routes read x and write y with the same 16-byte vectors."""
    phase = x.data_ptr() % 16
    y = torch.empty_like(x)
    if y.data_ptr() % 16 == phase:
        return y
    esz = x.element_size()
    buf = torch.empty(x.numel() + 16 // esz, dtype=x.dtype, device=x.device)
    off = (phase - buf.data_ptr() % 16) % 16 // esz
    return buf[off:off + x.numel()].view(x.shape)


def _row_heads(rows: int, n: int, esz: int, phase: int):
    """Each row's head (elements before its first 16-byte boundary) for a
    tensor whose first row lies `phase` bytes past one."""
    off = (phase + torch.arange(rows, dtype=torch.int64) * (n * esz)) % 16
    return torch.clamp((16 - off) % 16 // esz, max=n)


def softmax_split_plain(x, splits: int, phase: int = 0):
    """The cluster route's arithmetic in torch, in f32, result in x.dtype:
    each row cut as the kernel cuts it — a head to its first 16-byte
    boundary (x's first row `phase` bytes past one), 16-byte vectors, a
    tail — CTA c of `splits` taking vectors [c * per, (c + 1) * per) and
    CTA 0 the head and tail; each CTA's m_c and s_c = sum exp(x - m_c);
    M = max m_c and S = sum s_c e^(m_c - M) merged in rank order; y =
    exp(x - m_c) * (e^(m_c - M) / S). (The order of the sums inside a CTA
    is torch's.)"""
    n = x.shape[-1]
    xf = x.reshape(-1, n).float()
    esz = x.element_size()
    w = 16 // esz
    out = torch.empty_like(xf)
    heads = _row_heads(xf.shape[0], n, esz, phase)
    for head in heads.unique().tolist():
        idx = (heads == head).nonzero().flatten()
        rows = xf[idx]
        nv = (n - head) // w
        tail = n - head - nv * w
        per = -(-nv // splits)
        parts = []
        for c in range(splits):
            cols = list(range(head + min(nv, c * per) * w,
                              head + min(nv, (c + 1) * per) * w))
            if c == 0:
                cols = list(range(head)) + cols + list(range(n - tail, n))
            if not cols:
                continue
            cols = torch.tensor(cols, dtype=torch.int64)
            m = rows[:, cols].amax(dim=1, keepdim=True)
            e = torch.exp(rows[:, cols] - m)
            parts.append((cols, m, e, e.sum(dim=1, keepdim=True)))
        big_m = parts[0][1]
        for _, m, _, _ in parts[1:]:
            big_m = torch.maximum(big_m, m)
        big_s = torch.zeros_like(big_m)
        for _, m, _, s in parts:
            big_s = big_s + s * torch.exp(m - big_m)
        y = torch.empty_like(rows)
        for cols, m, e, _ in parts:
            y[:, cols] = e * (torch.exp(m - big_m) / big_s)
        out[idx] = y
    return out.to(x.dtype).reshape(x.shape)


def rmsnorm_warp_plain(x, gamma, eps: float, phase: int = 0):
    """(y, rstd) in the warp route's order, in torch: each row cut into a
    head, 16-byte vectors and a tail as the kernel cuts it (x's first row
    `phase` bytes past a 16-byte boundary); lane l sums x^2 over its
    vectors l, l + 32, ... element by element, then its head or tail
    element, without fused multiply-adds; the 32 lane sums meet in a
    butterfly (s + s[l ^ o] for o = 16, 8, 4, 2, 1); rstd = 1 /
    sqrt(s / N + eps), each step rounded to f32; y = (x * rstd) * gamma,
    rounded once to x.dtype. On the card's sums this gives the kernel's
    bits."""
    n = x.shape[-1]
    xf = x.reshape(-1, n).float()
    r = xf.shape[0]
    esz = x.element_size()
    w = 16 // esz
    rstd = torch.empty((r, 1), dtype=torch.float32)
    heads = _row_heads(r, n, esz, phase)
    for head in heads.unique().tolist():
        idx = (heads == head).nonzero().flatten()
        rows = xf[idx]
        s = _lane_sums(rows * rows, head, n, w)
        # sqrt correctly rounded, as the card's sqrtf (torch's f32 sqrt on
        # the CPU is not): through f64, which rounds a square root right
        rstd[idx] = 1 / torch.sqrt((s / n + eps).double()).float()
    y = xf * rstd
    if gamma is not None:
        y = y * gamma.float()
    return y.to(x.dtype).reshape(x.shape), rstd


def layernorm_fwd_warp_plain(x, gamma, beta, eps: float, phase: int = 0):
    """(y, mean, rstd) in the warp route's order, in torch: each row cut
    as `rmsnorm_warp_plain` cuts it (x's first row `phase` bytes past a
    16-byte boundary); mean = sum(x) / N and var = sum((x - mean)^2) / N,
    each sum as `_lane_sums` takes it (lane sums in order, no fused
    multiply-add, a butterfly); rstd = 1 / sqrt(var + eps), each step
    rounded to f32; y = ((x - mean) * rstd) * gamma + beta, rounded once
    to x.dtype. On the card's sums this gives the kernel's bits."""
    n = x.shape[-1]
    xf = x.reshape(-1, n).float()
    r = xf.shape[0]
    esz = x.element_size()
    w = 16 // esz
    mean = torch.empty((r, 1), dtype=torch.float32)
    rstd = torch.empty((r, 1), dtype=torch.float32)
    heads = _row_heads(r, n, esz, phase)
    for head in heads.unique().tolist():
        idx = (heads == head).nonzero().flatten()
        rows = xf[idx]
        m = _lane_sums(rows, head, n, w) / n
        d = rows - m
        var = _lane_sums(d * d, head, n, w) / n
        mean[idx] = m
        # sqrt correctly rounded, as in rmsnorm_warp_plain
        rstd[idx] = 1 / torch.sqrt((var + eps).double()).float()
    y = (xf - mean) * rstd
    if gamma is not None:
        y = y * gamma.float() + beta.float()
    return y.to(x.dtype).reshape(x.shape), mean, rstd


def _butterfly(s):
    """Each lane's value after a butterfly of adds over the last axis (L
    lanes, a power of two; a warp's 32): s + s[l ^ o] for o = L / 2, ...,
    2, 1."""
    n = s.shape[-1]
    lanes = torch.arange(n, device=s.device)
    o = n // 2
    while o:
        s = s + s[..., lanes ^ o]
        o //= 2
    return s


def _block_sum(s):
    """common.cuh block_reduce<false> of per-thread values s (..., T), T a
    multiple of 32: each warp's butterfly, then the warp sums (zeros past
    the last warp) in one more butterfly. (..., 1)."""
    t = s.shape[-1]
    warps = _butterfly(s.reshape(*s.shape[:-1], t // 32, 32))[..., 0]
    pad = torch.zeros((*s.shape[:-1], 32), dtype=s.dtype, device=s.device)
    pad[..., :t // 32] = warps
    return _butterfly(pad)[..., :1]


def softmax_bwd_split_plain(y, dy, splits: int = 1, phase: int = 0):
    """The softmax backward's routes in torch, in f32, result in y.dtype:
    dx = y * (dy - S) with S = sum(y * dy) in the kernel's order, each
    product and sum rounded to f32 on its own (no fused multiply-add), so
    on the card's inputs it gives the kernel's bits. The route follows
    from N, the dtype and `splits` as `softmax_bwd_plan` picks it:
    "rows" (N <= SOFTMAX_BWD_ROWS_MAX_N; splits 1): lane l of L takes
    columns l, l + L, ... in order, the L lanes meet in a butterfly;
    "block" (splits 1), "cluster" (splits 2-8) and "loop" (a row no
    cluster holds; splits 1): each row cut as the kernel cuts it (a head
    to its first 16-byte boundary, y's first row `phase` bytes past one,
    16-byte vectors, a tail), CTA c taking vectors [c * per, (c + 1) *
    per), thread t of T its vectors t, t + T, ... element by element and
    on CTA 0 one head or tail element, then common.cuh block_reduce; the
    CTAs' sums added in rank order (one CTA: its own sum)."""
    n = y.shape[-1]
    yf = y.reshape(-1, n).float()
    d = dy.reshape(-1, n).float()
    r = yf.shape[0]
    esz = y.element_size()
    w = 16 // esz
    prod = yf * d
    dev = yf.device
    if n <= SOFTMAX_BWD_ROWS_MAX_N:
        if splits != 1:
            raise ValueError(f"softmax_bwd_split_plain: the rows route of "
                             f"N = {n} takes no splits, got {splits}")
        lanes, k = _softmax_bwd_lanes(n)
        cols = torch.zeros((r, k * lanes), dtype=torch.float32, device=dev)
        cols[:, :n] = prod
        cols = cols.reshape(r, k, lanes)
        s = torch.zeros((r, lanes), dtype=torch.float32, device=dev)
        for kk in range(k):
            s = s + cols[:, kk]
        big_s = _butterfly(s)[:, :1]
    else:
        if _softmax_bwd_splits(n, esz, 1) == 0:
            if splits != 1:
                raise ValueError(f"softmax_bwd_split_plain: the loop route "
                                 f"of N = {n} takes no splits, got {splits}")
            threads = LOOP_THREADS
        else:
            threads = _softmax_bwd_cta(n, esz, splits)[0]
        big_s = torch.empty((r, 1), dtype=torch.float32, device=dev)
        heads = _row_heads(r, n, esz, phase)
        for head in heads.unique().tolist():
            idx = (heads == head).nonzero().flatten().to(dev)
            p = prod[idx]
            m = p.shape[0]
            nv = (n - head) // w
            tail = n - head - nv * w
            per = -(-nv // splits)
            total = None
            for c in range(splits):
                v0 = min(nv, c * per)
                v1 = min(nv, v0 + per)
                k = max(1, -(-(v1 - v0) // threads))
                body = torch.zeros((m, k * threads, w), dtype=torch.float32,
                                   device=dev)
                body[:, :v1 - v0] = p[:, head + v0 * w:head + v1 * w].reshape(
                    m, v1 - v0, w)
                body = body.reshape(m, k, threads, w)
                s = torch.zeros((m, threads), dtype=torch.float32, device=dev)
                for kk in range(k):
                    for j in range(w):
                        s = s + body[:, kk, :, j]
                if c == 0:
                    edge = torch.zeros_like(s)
                    edge[:, :head] = p[:, :head]
                    edge[:, head:head + tail] = p[:, n - tail:]
                    s = s + edge
                s = _block_sum(s)
                if splits == 1:
                    total = s
                else:
                    total = (torch.zeros_like(s) if total is None
                             else total) + s
            big_s[idx] = total
    dx = yf * (d - big_s)
    return dx.to(y.dtype).reshape(y.shape)


def _lane_sums(v, head, n, w):
    """The warp route's row sums of v (rows of one head): lane l adds its
    vectors l, l + 32, ... element by element, then its head or tail
    element; the lanes meet in the butterfly. (rows, 1)."""
    rows = v.shape[0]
    nv = (n - head) // w
    tail = n - head - nv * w
    k = -(-nv // 32)
    body = torch.zeros((rows, k * 32, w), dtype=torch.float32)
    body[:, :nv] = v[:, head:head + nv * w].reshape(rows, nv, w)
    body = body.reshape(rows, k, 32, w)
    s = torch.zeros((rows, 32), dtype=torch.float32)
    for kk in range(k):
        for j in range(w):
            s = s + body[:, kk, :, j]
    edge = torch.zeros_like(s)
    edge[:, :head] = v[:, :head]
    edge[:, head:head + tail] = v[:, n - tail:]
    return _butterfly(s + edge)[:, :1]


def layernorm_bwd_warp_plain(x, gamma, mean, rstd, dy, blocks: int,
                             phase: int = 0, warps: int = 8,
                             center: bool = True):
    """(dx, dgamma, dbeta) in the warp route's order, in torch, for a grid
    of `blocks` CTAs of `warps` warps (`layernorm_bwd_plan(...)`'s blocks
    and threads / 32), x's first row `phase` bytes past a 16-byte
    boundary. Every step is
    rounded to f32 on its own: xhat = (x - mean) * rstd, g = dy * gamma;
    sum(g) and sum(g * xhat) as `_lane_sums` takes them, m = sum / N, dx =
    ((g - m1) - xhat * m2) * rstd rounded once to x.dtype. dgamma (of dy *
    xhat) and dbeta (of dy): warp w of the S = warps * blocks adds rows
    w, w + S, ... in order; CTA b adds its warps in order;
    partial row p goes to group p mod 32 in order, and the 32 groups
    meet in the butterfly. On the card's sums this gives the kernel's
    bits. `center` False is RMSNorm's route (the kernel's kCenter): no
    mean (None), xhat = x * rstd, dx = (g - xhat * m2) * rstd, dbeta
    None."""
    n = x.shape[-1]
    xf = x.reshape(-1, n).float()
    d = dy.reshape(-1, n).float()
    r = xf.shape[0]
    w = 16 // x.element_size()
    xhat = (xf - mean) * rstd if center else xf * rstd
    g = d * gamma.float() if gamma is not None else d
    gx = g * xhat
    dx = torch.empty_like(xf)
    heads = _row_heads(r, n, x.element_size(), phase)
    for head in heads.unique().tolist():
        idx = (heads == head).nonzero().flatten()
        m2 = _lane_sums(gx[idx], head, n, w) / n
        c = g[idx]
        if center:
            c = c - _lane_sums(g[idx], head, n, w) / n
        dx[idx] = (c - xhat[idx] * m2) * rstd[idx]
    dx = dx.to(x.dtype).reshape(x.shape)
    if gamma is None:
        return dx, None, None
    stride = warps * blocks

    def column_sums(terms):
        acc = torch.zeros((stride, n), dtype=torch.float32)
        for lo in range(0, r, stride):
            hi = min(r, lo + stride)
            acc[:hi - lo] = acc[:hi - lo] + terms[lo:hi]
        acc = acc.reshape(blocks, warps, n)
        part = torch.zeros((blocks, n), dtype=torch.float32)
        for wi in range(warps):
            part = part + acc[:, wi]
        groups = torch.zeros((n, 32), dtype=torch.float32)
        for lo in range(0, blocks, 32):
            hi = min(blocks, lo + 32)
            groups[:, :hi - lo] = groups[:, :hi - lo] + part[lo:hi].t()
        return _butterfly(groups)[:, 0]

    return dx, column_sums(d * xhat), column_sums(d) if center else None


def rmsnorm_bwd_warp_plain(x, gamma, rstd, dy, blocks: int, phase: int = 0,
                           warps: int = 8):
    """(dx, dgamma) in RMSNorm's warp route's order, in torch:
    `layernorm_bwd_warp_plain` without the mean (`rmsnorm_bwd_plan(...)`'s
    blocks and threads / 32). On the card's sums this gives the kernel's
    bits."""
    dx, dg, _ = layernorm_bwd_warp_plain(x, gamma, None, rstd, dy, blocks,
                                         phase, warps, center=False)
    return dx, dg


# f32 floats of shared memory a layernorm_bwd block stages per column
# (xhat, g, and the dgamma / dbeta partial sums): N <= 227 KB / 16 B;
# rmsnorm_bwd stages one sum fewer, the same bound keeps one rule
MAX_BWD_COLS = 232448 // 16
# with gamma the LayerNorm block route stages all four beside 32 floats of
# reduction scratch: N <= 14520 (the parent's launch failed above it)
LN_BWD_BLOCK_AFFINE_MAX_N = (SMEM_BYTES - 32 * 4) // 16


def layernorm_fwd_plain(x, gamma, beta, eps: float):
    """(y, mean, rstd): f32 statistics over the trailing axis, y in
    x.dtype, mean and rstd (R, 1) f32 — `_ln_fwd_kernel`'s outputs."""
    n = x.shape[-1]
    xf = x.reshape(-1, n).float()
    mean = xf.mean(dim=1, keepdim=True)
    var = torch.square(xf - mean).mean(dim=1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = (xf - mean) * rstd
    if gamma is not None:
        y = y * gamma.float() + beta.float()
    return y.to(x.dtype).reshape(x.shape), mean, rstd


def softmax_fwd_plain(x):
    """softmax over the trailing axis in f32, result in x.dtype."""
    return torch.softmax(x.float(), dim=-1).to(x.dtype)


def layernorm_bwd_plain(x, gamma, mean, rstd, dy):
    """(dx, dgamma, dbeta), `_ln_bwd_kernel`'s math: with xhat =
    (x - mean) * rstd and g = dy * gamma, dx = (g - mean(g) -
    xhat * mean(g * xhat)) * rstd in x.dtype; dgamma = sum(dy * xhat) and
    dbeta = sum(dy) over rows in f32, cast to gamma's dtype (None without
    affine)."""
    n = x.shape[-1]
    xf = x.reshape(-1, n).float()
    d = dy.reshape(-1, n).float()
    xhat = (xf - mean) * rstd
    g = d * gamma.float() if gamma is not None else d
    m1 = g.mean(dim=1, keepdim=True)
    m2 = (g * xhat).mean(dim=1, keepdim=True)
    dx = ((g - m1 - xhat * m2) * rstd).to(x.dtype).reshape(x.shape)
    if gamma is None:
        return dx, None, None
    return (dx, (d * xhat).sum(dim=0).to(gamma.dtype),
            d.sum(dim=0).to(gamma.dtype))


def rmsnorm_fwd_plain(x, gamma, eps: float):
    """(y, rstd): rstd = 1 / sqrt(mean(x^2) + eps) over the trailing axis
    in f32, (R, 1); y = x * rstd [* gamma] in x.dtype — `_rms_fwd_kernel`'s
    outputs."""
    n = x.shape[-1]
    xf = x.reshape(-1, n).float()
    rstd = torch.rsqrt(torch.square(xf).mean(dim=1, keepdim=True) + eps)
    y = xf * rstd
    if gamma is not None:
        y = y * gamma.float()
    return y.to(x.dtype).reshape(x.shape), rstd


def rmsnorm_bwd_plain(x, gamma, rstd, dy):
    """(dx, dgamma), `_rms_bwd_kernel`'s math: with xhat = x * rstd and
    g = dy * gamma, dx = (g - xhat * mean(g * xhat)) * rstd in x.dtype;
    dgamma = sum(dy * xhat) over rows in f32, cast to gamma's dtype (None
    without affine)."""
    n = x.shape[-1]
    xf = x.reshape(-1, n).float()
    d = dy.reshape(-1, n).float()
    xhat = xf * rstd
    g = d * gamma.float() if gamma is not None else d
    m2 = (g * xhat).mean(dim=1, keepdim=True)
    dx = ((g - xhat * m2) * rstd).to(x.dtype).reshape(x.shape)
    if gamma is None:
        return dx, None
    return dx, (d * xhat).sum(dim=0).to(gamma.dtype)


def softmax_bwd_plain(y, dy):
    """dx = y * (dy - sum(y * dy)) over the trailing axis in f32, result
    in y.dtype."""
    yf, d = y.float(), dy.float()
    return (yf * (d - (yf * d).sum(dim=-1, keepdim=True))).to(y.dtype)


def _check_x(name, x):
    if x.dim() < 1 or x.shape[-1] < 1 or x.numel() == 0:
        raise ValueError(f"{name}: need a non-empty (..., N) input, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{name}: x must be float32 or bfloat16, got "
                        f"{x.dtype}")


def _on_card(name, *tensors):
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: operands on several devices")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: operands must be contiguous")
    return True


def layernorm_fwd(x, gamma=None, beta=None, *, eps: float = 1e-5):
    """LayerNorm over the trailing axis: (y, mean, rstd). gamma/beta (N,)
    f32, or both None for no affine."""
    _check_x("layernorm_fwd", x)
    n = x.shape[-1]
    if (gamma is None) != (beta is None):
        raise ValueError("gamma and beta must be given together")
    affine = [] if gamma is None else [gamma, beta]
    for t in affine:
        if tuple(t.shape) != (n,):
            raise ValueError(f"layernorm_fwd: gamma/beta must be ({n},), "
                             f"got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"layernorm_fwd: gamma/beta must be float32, "
                            f"got {t.dtype}")
    if not _on_card("layernorm_fwd", x, *affine):
        return layernorm_fwd_plain(x, gamma, beta, eps)
    r = x.numel() // n
    plan = layernorm_fwd_plan(r, n, x.dtype, _sm_count(x.device.index))
    y = _empty_in_phase(x)
    mean = torch.empty((r, 1), dtype=torch.float32, device=x.device)
    rstd = torch.empty((r, 1), dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.ff_layernorm_fwd(
            x.data_ptr(), gamma.data_ptr() if affine else None,
            beta.data_ptr() if affine else None, y.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), r, n, float(eps), _build.DTYPE_CODES[x.dtype],
            _build.stream_ptr(x.device), LN_FWD_ROUTES[plan.route],
            plan.threads, plan.blocks, plan.vecs)
    _build.check(err, "layernorm_fwd")
    LAUNCHES["layernorm_fwd"] += 1
    ROUTES[f"layernorm_fwd/{plan.route}"] += 1
    return y, mean, rstd


def _check_gamma(name, gamma, n):
    if gamma is not None and (tuple(gamma.shape) != (n,)
                              or gamma.dtype != torch.float32):
        raise ValueError(f"{name}: gamma must be ({n},) float32, got "
                         f"{tuple(gamma.shape)} {gamma.dtype}")


def rmsnorm_fwd(x, gamma=None, *, eps: float = 1e-6):
    """RMSNorm over the trailing axis: (y, rstd). gamma (N,) f32, or None
    for no affine."""
    _check_x("rmsnorm_fwd", x)
    n = x.shape[-1]
    _check_gamma("rmsnorm_fwd", gamma, n)
    affine = [] if gamma is None else [gamma]
    if not _on_card("rmsnorm_fwd", x, *affine):
        return rmsnorm_fwd_plain(x, gamma, eps)
    r = x.numel() // n
    plan = rmsnorm_plan(r, n, x.dtype, _sm_count(x.device.index))
    y = _empty_in_phase(x)
    rstd = torch.empty((r, 1), dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.ff_rmsnorm_fwd(
            x.data_ptr(), gamma.data_ptr() if affine else None, y.data_ptr(),
            rstd.data_ptr(), r, n, float(eps), _build.DTYPE_CODES[x.dtype],
            _build.stream_ptr(x.device), RMSNORM_ROUTES[plan.route],
            plan.threads, plan.blocks, plan.vecs)
    _build.check(err, "rmsnorm_fwd")
    LAUNCHES["rmsnorm_fwd"] += 1
    ROUTES[f"rmsnorm_fwd/{plan.route}"] += 1
    return y, rstd


def rmsnorm_bwd(x, gamma, rstd, dy):
    """(dx, dgamma) of `rmsnorm_fwd(x, gamma)` for the cotangent dy; rstd
    is the forward's (R, 1) f32 statistic. gamma None: no affine, dgamma
    None."""
    _check_x("rmsnorm_bwd", x)
    n = x.shape[-1]
    r = x.numel() // n
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"rmsnorm_bwd: dy {tuple(dy.shape)} {dy.dtype} "
                         f"must match x {tuple(x.shape)} {x.dtype}")
    if tuple(rstd.shape) != (r, 1) or rstd.dtype != torch.float32:
        raise ValueError(f"rmsnorm_bwd: rstd must be ({r}, 1) float32, got "
                         f"{tuple(rstd.shape)} {rstd.dtype}")
    _check_gamma("rmsnorm_bwd", gamma, n)
    affine = [] if gamma is None else [gamma]
    if not _on_card("rmsnorm_bwd", x, rstd, dy, *affine):
        return rmsnorm_bwd_plain(x, gamma, rstd, dy)
    plan = rmsnorm_bwd_plan(r, n, x.dtype, _sm_count(x.device.index))
    dx = _empty_in_phase(x)
    lib = _build.library()
    dg = part = None
    if affine:
        part = torch.empty((plan.blocks, n), dtype=torch.float32,
                           device=x.device)
        dg = torch.empty((n,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.ff_rmsnorm_bwd(
            x.data_ptr(), gamma.data_ptr() if affine else None,
            rstd.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            part.data_ptr() if affine else None,
            dg.data_ptr() if affine else None, r, n,
            _build.DTYPE_CODES[x.dtype], _build.stream_ptr(x.device),
            RMS_BWD_ROUTES[plan.route], plan.threads, plan.blocks, plan.vecs)
    _build.check(err, "rmsnorm_bwd")
    LAUNCHES["rmsnorm_bwd"] += 1
    ROUTES[f"rmsnorm_bwd/{plan.route}"] += 1
    return dx, dg


def softmax_fwd(x):
    """softmax over the trailing axis (f32 max/exp/sum, result in x's
    dtype)."""
    _check_x("softmax_fwd", x)
    if not _on_card("softmax_fwd", x):
        return softmax_fwd_plain(x)
    n = x.shape[-1]
    r = x.numel() // n
    plan = softmax_plan(r, n, x.dtype, _sm_count(x.device.index))
    y = _empty_in_phase(x)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.ff_softmax_fwd(
            x.data_ptr(), y.data_ptr(), r, n, _build.DTYPE_CODES[x.dtype],
            _build.stream_ptr(x.device), SOFTMAX_ROUTES[plan.route],
            plan.threads, plan.blocks, plan.per_thread, plan.lanes,
            plan.cluster)
    _build.check(err, "softmax_fwd")
    LAUNCHES["softmax_fwd"] += 1
    ROUTES[f"softmax_fwd/{plan.route}"] += 1
    return y


def layernorm_bwd(x, gamma, mean, rstd, dy):
    """(dx, dgamma, dbeta) of `layernorm_fwd(x, gamma, beta)` for the
    cotangent dy; mean and rstd are the forward's (R, 1) f32 statistics.
    gamma None: no affine, dgamma and dbeta None."""
    _check_x("layernorm_bwd", x)
    n = x.shape[-1]
    r = x.numel() // n
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"layernorm_bwd: dy {tuple(dy.shape)} {dy.dtype} "
                         f"must match x {tuple(x.shape)} {x.dtype}")
    for tname, t in (("mean", mean), ("rstd", rstd)):
        if tuple(t.shape) != (r, 1) or t.dtype != torch.float32:
            raise ValueError(f"layernorm_bwd: {tname} must be ({r}, 1) "
                             f"float32, got {tuple(t.shape)} {t.dtype}")
    _check_gamma("layernorm_bwd", gamma, n)
    affine = [] if gamma is None else [gamma]
    if not _on_card("layernorm_bwd", x, mean, rstd, dy, *affine):
        return layernorm_bwd_plain(x, gamma, mean, rstd, dy)
    plan = layernorm_bwd_plan(r, n, x.dtype, _sm_count(x.device.index))
    if affine and n > LN_BWD_BLOCK_AFFINE_MAX_N:
        raise ValueError(f"layernorm_bwd: N={n} > "
                         f"{LN_BWD_BLOCK_AFFINE_MAX_N} with gamma, the most "
                         "a block stages in shared memory")
    dx = _empty_in_phase(x)
    lib = _build.library()
    dg = db = part = None
    if affine:
        part = torch.empty((2, plan.blocks, n), dtype=torch.float32,
                           device=x.device)
        dg = torch.empty((n,), dtype=torch.float32, device=x.device)
        db = torch.empty((n,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.ff_layernorm_bwd(
            x.data_ptr(), gamma.data_ptr() if affine else None,
            mean.data_ptr(), rstd.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            part[0].data_ptr() if affine else None,
            part[1].data_ptr() if affine else None,
            dg.data_ptr() if affine else None,
            db.data_ptr() if affine else None, r, n,
            _build.DTYPE_CODES[x.dtype], _build.stream_ptr(x.device),
            LN_BWD_ROUTES[plan.route], plan.threads, plan.blocks, plan.vecs)
    _build.check(err, "layernorm_bwd")
    LAUNCHES["layernorm_bwd"] += 1
    ROUTES[f"layernorm_bwd/{plan.route}"] += 1
    return dx, dg, db


def softmax_bwd(y, dy):
    """dx of `y = softmax_fwd(x)` for the cotangent dy."""
    _check_x("softmax_bwd", y)
    if dy.shape != y.shape or dy.dtype != y.dtype:
        raise ValueError(f"softmax_bwd: dy {tuple(dy.shape)} {dy.dtype} "
                         f"must match y {tuple(y.shape)} {y.dtype}")
    if not _on_card("softmax_bwd", y, dy):
        return softmax_bwd_plain(y, dy)
    n = y.shape[-1]
    r = y.numel() // n
    plan = softmax_bwd_plan(r, n, y.dtype, _sm_count(y.device.index))
    dx = _empty_in_phase(y)
    lib = _build.library()
    with torch.cuda.device(y.device):
        err = lib.ff_softmax_bwd(
            y.data_ptr(), dy.data_ptr(), dx.data_ptr(), r, n,
            _build.DTYPE_CODES[y.dtype], _build.stream_ptr(y.device),
            SOFTMAX_BWD_ROUTES[plan.route], plan.threads, plan.blocks,
            plan.per_thread, plan.lanes, plan.cluster)
    _build.check(err, "softmax_bwd")
    LAUNCHES["softmax_bwd"] += 1
    ROUTES[f"softmax_bwd/{plan.route}"] += 1
    return dx


class _LayerNorm(torch.autograd.Function):
    """Saves (x, gamma, mean, rstd), as `_fused_ln_affine_fwd`; gamma is
    None without affine, as `_fused_ln_plain_fwd` saves (x, mean, rstd)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        y, mean, rstd = layernorm_fwd(x, gamma, beta, eps=eps)
        ctx.save_for_backward(x, gamma, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, g):
        x, gamma, mean, rstd = ctx.saved_tensors
        dx, dg, db = layernorm_bwd(x, gamma, mean, rstd, g.contiguous())
        return dx, dg, db, None


class _RMSNorm(torch.autograd.Function):
    """Saves (x, gamma, rstd), as `_fused_rms_affine_fwd`; gamma is None
    without affine, as `_fused_rms_plain_fwd` saves (x, rstd)."""

    @staticmethod
    def forward(ctx, x, gamma, eps):
        y, rstd = rmsnorm_fwd(x, gamma, eps=eps)
        ctx.save_for_backward(x, gamma, rstd)
        return y

    @staticmethod
    def backward(ctx, g):
        x, gamma, rstd = ctx.saved_tensors
        dx, dg = rmsnorm_bwd(x, gamma, rstd, g.contiguous())
        return dx, dg, None


class _Softmax(torch.autograd.Function):
    """Saves y, as `_fused_softmax_fwd`."""

    @staticmethod
    def forward(ctx, x):
        y = softmax_fwd(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return softmax_bwd(y, g.contiguous())


def layernorm(x, gamma=None, beta=None, *, eps: float = 1e-5):
    """Differentiable LayerNorm over the trailing axis through
    layernorm_fwd / layernorm_bwd."""
    if (gamma is None) != (beta is None):
        raise ValueError("gamma and beta must be given together")
    return _LayerNorm.apply(x, gamma, beta, float(eps))


def rmsnorm(x, gamma=None, eps: float = 1e-6):
    """Differentiable RMSNorm over the trailing axis through rmsnorm_fwd /
    rmsnorm_bwd."""
    return _RMSNorm.apply(x, gamma, float(eps))


def softmax(x):
    """Differentiable softmax over the trailing axis through softmax_fwd /
    softmax_bwd."""
    return _Softmax.apply(x)
