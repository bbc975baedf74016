"""Scalar sum, mean or max of a whole array, and the inclusive scan along
the trailing axis: the CUDA kernels, their plain versions and the
autograd Functions.

`reduce` replaces flexflow_tpu/kernels/pallas/reduction.py
`_reduce_sum_or_max` (`_reduce_kernel`), and `fused_reduce` is the
counterpart of the JAX `fused_reduce` with its custom VJP. x has any
shape, f32 or bf16; the kernel reads the stored dtype and accumulates in
f32, and the result is an f32 scalar. mean is sum / max(1, n); an empty
x gives 0 for sum and mean and -inf for max. The kernel is
csrc/reduction.cu, bound by bytes, on a route that `reduce_plan` picks
from n and the dtype alone (never a value, so no host sync): "cta" (x up
to REDUCE_CTA_MAX_BYTES, the loss's 4096 f32 elements among them): one
launch of one block that holds x; "grid" (larger x): a streaming pass of
block partials, then a finishing block launched as a programmatic
dependent that adds them in a fixed order. No atomics on either, so the
loss is the same bits on every run.

The gradient of sum and mean broadcasts the cotangent (divided by n for
mean) in f32, cast to x's dtype, with no kernel, as the JAX VJP does.
max is forward-only: its gradient raises TypeError.

`cumsum` replaces flexflow_tpu/kernels/pallas/reduction.py `_cumsum_call`
(`_cumsum_kernel`), and `fused_cumsum` is the counterpart of the JAX
`fused_cumsum` with its custom VJP: the inclusive prefix sum along the
trailing axis of x (any shape, f32 or bf16), accumulated in f32 and
written in x's dtype. Its gradient is the reversed scan of the cotangent
by the same kernel (`reverse=True` in place of the JAX flips). The JAX
package has no consumer of it; it is a public kernel of its own. The
kernel (csrc/reduction.cu) is bound by bytes, on a route that
`cumsum_plan` picks from the shape alone: "row" (the rows alone fill the
card, or they are short): one block a row walks it in tiles with an f32
carry; "split" (few long rows): each row cut into chunks of whole tiles
over enough blocks to fill every SM, a first launch writing each chunk's
f32 total, a second, programmatically dependent, in which each block
adds the totals before its chunk in a fixed order and scans its chunk
from that carry. `cumsum_split_plain` repeats both routes' arithmetic in
torch, to the bit.

A wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from . import _build
from .norm import H100_SMS, _block_sum, _sm_count

KINDS = {"sum": 0, "mean": 1, "max": 2}

# kernel launches of `reduce` and `cumsum` (the grid and split routes'
# two launches count once), plain counts the paths are read by
LAUNCHES: Dict[str, int] = {"reduce": 0, "cumsum": 0}
# calls by route (csrc/reduction.cu ReduceRoute, ScanRoute), the codes the
# C entries take
REDUCE_ROUTES = {"grid": 0, "cta": 1}
CUMSUM_ROUTES = {"row": 0, "split": 1}
ROUTES: Dict[str, int] = {f"{name}/{r}": 0 for name, routes in (
    ("reduce", REDUCE_ROUTES), ("cumsum", CUMSUM_ROUTES)) for r in routes}
# "cta": x of at most REDUCE_CTA_MAX_BYTES in one block; a thread takes
# up to CTA_MAX_VECS 16-byte vectors, the block the least multiple of 32
# threads that holds x at the fewest vectors a thread that keeps it within
# CTA_THREADS (past 2048 vectors: 8 a thread, up to 1024 threads)
REDUCE_CTA_MAX_BYTES = 128 * 1024
CTA_THREADS = 256
CTA_MAX_THREADS = 1024
CTA_MAX_VECS = 8
# "grid": a block of 256 threads for every GRID_BLOCK_ELEMS elements, at
# most GRID_MAX_BLOCKS, then one finishing block
GRID_THREADS = 256
GRID_BLOCK_ELEMS = 16 * GRID_THREADS
GRID_MAX_BLOCKS = 1024
_ESZ = {torch.float32: 4, torch.bfloat16: 2}
# the scan: a block of SCAN_THREADS walks tiles of SCAN_TILE elements
# (csrc/reduction.cu kScanThreads, kScanTile). "row" where the rows alone
# give CUMSUM_CTAS_PER_SM blocks an SM, or N <= CUMSUM_ROW_MAX_N; "split"
# else: ceil(CUMSUM_CTAS_PER_SM x SMs / rows) chunks a row (at most
# CUMSUM_MAX_CHUNKS, the totals a block of the second launch adds: 4 a
# thread), each a whole number of tiles, at least CUMSUM_MIN_CHUNK.
# CUMSUM_CTAS_PER_SM and CUMSUM_MIN_CHUNK are the fastest of
# tools/norm_bench.py --sweep (PERF.md, section 6)
SCAN_THREADS = 256
SCAN_TILE = 4 * SCAN_THREADS
CUMSUM_CTAS_PER_SM = 8
CUMSUM_ROW_MAX_N = 4 * SCAN_TILE
CUMSUM_MIN_CHUNK = 2 * SCAN_TILE
CUMSUM_MAX_CHUNKS = 4 * SCAN_THREADS


class ReducePlan(NamedTuple):
    """How one reduce call runs on the card (`reduce_plan`)."""
    route: str    # "cta" or "grid"
    threads: int  # a block
    blocks: int   # the grid (cta: 1; grid: the streaming pass's blocks)
    vecs: int     # cta: 16-byte vectors a thread; grid: 0


def reduce_plan(n: int, dtype) -> ReducePlan:
    """The route and launch of reduce over n elements of `dtype`, from
    those alone: "cta" while x fits REDUCE_CTA_MAX_BYTES (and one block's
    CTA_MAX_THREADS x CTA_MAX_VECS vectors), with the fewest vectors a
    thread (1, 2, 4, 8) that keeps the block within CTA_THREADS; "grid"
    beyond, ceil(n / GRID_BLOCK_ELEMS) blocks, at most GRID_MAX_BLOCKS."""
    n = int(n)
    if n < 0:
        raise ValueError(f"reduce_plan: n = {n} must be >= 0")
    if dtype not in _ESZ:
        raise TypeError(f"reduce_plan: dtype must be float32 or bfloat16, "
                        f"got {dtype}")
    w = 16 // _ESZ[dtype]
    nvec = -(-n // w)
    if (n * _ESZ[dtype] <= REDUCE_CTA_MAX_BYTES
            and nvec <= CTA_MAX_THREADS * CTA_MAX_VECS):
        vecs = next(v for v in (1, 2, 4, CTA_MAX_VECS)
                    if v == CTA_MAX_VECS or nvec <= CTA_THREADS * v)
        per = -(-nvec // vecs)  # threads that hold x, then whole warps
        return ReducePlan("cta", max(32, -(-per // 32) * 32), 1, vecs)
    blocks = min(GRID_MAX_BLOCKS, max(1, -(-n // GRID_BLOCK_ELEMS)))
    return ReducePlan("grid", GRID_THREADS, blocks, 0)


def reduce_plain(x, kind: str):
    """f32 scalar sum / mean / max of x, the JAX `_fused_reduce`'s math:
    x cast to f32, summed (or maxed), mean divided by max(1, n)."""
    xf = x.reshape(-1).float()
    n = xf.numel()
    if kind == "max":
        if n == 0:
            return torch.tensor(float("-inf"), device=x.device)
        return xf.max()
    s = xf.sum()
    return s / max(1, n) if kind == "mean" else s


def _check(x, kind):
    if kind not in KINDS:
        raise ValueError(f"kind must be sum, mean or max, got {kind!r}")
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"reduce: x must be float32 or bfloat16, got "
                        f"{x.dtype}")


def reduce(x, kind: str = "sum"):
    """f32 scalar sum, mean or max of x (any shape)."""
    _check(x, kind)
    if x.device.type == "cpu":
        return reduce_plain(x, kind)
    if x.device.type != "cuda":
        raise ValueError(f"reduce: no kernel for device {x.device}")
    if not x.is_contiguous():
        raise ValueError("reduce: x must be contiguous")
    n = x.numel()
    plan = reduce_plan(n, x.dtype)
    lib = _build.library()
    out = torch.empty((), dtype=torch.float32, device=x.device)
    part = torch.empty((plan.blocks,), dtype=torch.float32,
                       device=x.device) if plan.route == "grid" else None
    with torch.cuda.device(x.device):
        err = lib.ff_reduce(x.data_ptr(), n, int(x.data_ptr() % 16 == 0),
                            KINDS[kind],
                            part.data_ptr() if part is not None else None,
                            out.data_ptr(),
                            _build.DTYPE_CODES[x.dtype],
                            _build.stream_ptr(x.device),
                            REDUCE_ROUTES[plan.route], plan.threads,
                            plan.blocks, plan.vecs)
    _build.check(err, "reduce")
    LAUNCHES["reduce"] += 1
    ROUTES[f"reduce/{plan.route}"] += 1
    return out


class _Reduce(torch.autograd.Function):
    """Saves x's shape and dtype only, as the JAX VJP saves a zero-size
    prototype."""

    @staticmethod
    def forward(ctx, x, kind):
        ctx.kind, ctx.shape, ctx.dtype = kind, x.shape, x.dtype
        return reduce(x, kind)

    @staticmethod
    def backward(ctx, g):
        if ctx.kind == "max":
            raise TypeError("fused_reduce(kind='max') is forward-only; use "
                            "the reference reduction for differentiable "
                            "maxima")
        n = 1
        for d in ctx.shape:
            n *= d
        scale = g.float() / max(1, n) if ctx.kind == "mean" else g.float()
        return scale.to(ctx.dtype).expand(ctx.shape), None


def fused_reduce(x, kind: str = "sum"):
    """Differentiable scalar reduction of x through `reduce`."""
    return _Reduce.apply(x, kind)


class CumsumPlan(NamedTuple):
    """How one cumsum call runs on the card (`cumsum_plan`)."""
    route: str   # "row" or "split"
    chunk: int   # elements of a row a block scans (row: N)
    chunks: int  # blocks a row (row: 1); the grid is rows x chunks


def cumsum_plan(rows: int, n: int, dtype,
                sms: int = H100_SMS) -> CumsumPlan:
    """The route and launch of cumsum over `rows` rows of N, from the
    shape and dtype alone: "row" (one block a row) where rows >=
    CUMSUM_CTAS_PER_SM x sms or N <= CUMSUM_ROW_MAX_N ((4096, 1024),
    (37, 300)); "split" else ((3, 1000003): 326 chunks of 3072, (1,
    2^24): 1024 of 16384), chunks of the least whole number of tiles
    that cuts a row into at most ceil(CUMSUM_CTAS_PER_SM x sms / rows),
    capped at CUMSUM_MAX_CHUNKS, and no shorter than CUMSUM_MIN_CHUNK."""
    rows, n = int(rows), int(n)
    if rows < 1 or n < 1:
        raise ValueError(f"cumsum_plan: rows = {rows} and N = {n} must be "
                         ">= 1")
    if dtype not in _ESZ:
        raise TypeError(f"cumsum_plan: dtype must be float32 or bfloat16, "
                        f"got {dtype}")
    target = sms * CUMSUM_CTAS_PER_SM
    if rows < target and n > CUMSUM_ROW_MAX_N:
        want = min(CUMSUM_MAX_CHUNKS, -(-target // rows))
        chunk = max(CUMSUM_MIN_CHUNK,
                    -(-(-(-n // want)) // SCAN_TILE) * SCAN_TILE)
        chunks = -(-n // chunk)
        if chunks > 1:
            return CumsumPlan("split", chunk, chunks)
    return CumsumPlan("row", n, 1)


def _scan_tiles(v, carry):
    """csrc/reduction.cu `scan_span` in torch: spans v (..., tiles x
    SCAN_TILE), each scanned from its carry (...,) tile by tile — a
    thread's 4 elements in order, a Hillis-Steele scan of the thread
    totals over each warp, one of the 8 warp totals, the tile's values
    (carry + warp prefix) + thread prefix + own, the carry plus the tile
    total — every add rounded to f32 as on the card."""
    lead = v.shape[:-1]
    tiles = v.shape[-1] // SCAN_TILE
    t = v.reshape(*lead, tiles, SCAN_THREADS, 4)
    part = torch.empty_like(t)
    run = torch.zeros(t.shape[:-1], dtype=torch.float32, device=v.device)
    for j in range(4):
        run = run + t[..., j]
        part[..., j] = run
    incl = run.reshape(*lead, tiles, SCAN_THREADS // 32, 32)

    def hillis_steele(a):
        o = 1
        while o < a.shape[-1]:
            a = torch.cat([a[..., :o], a[..., o:] + a[..., :-o]], -1)
            o *= 2
        return a

    incl = hillis_steele(incl)
    zero = torch.zeros_like(incl[..., :1])
    excl = torch.cat([zero, incl[..., :-1]], -1)
    warps = hillis_steele(incl[..., 31])          # (..., tiles, 8)
    prev = torch.cat([torch.zeros_like(warps[..., :1]), warps[..., :-1]], -1)
    carries, c = [], carry
    for k in range(tiles):
        carries.append(c)
        c = c + warps[..., k, -1]
    before = ((torch.stack(carries, -1)[..., None, None] + prev[..., None])
              + excl).reshape(*lead, tiles, SCAN_THREADS)
    return (before[..., None] + part).reshape(v.shape)


def cumsum_split_plain(x, chunk=None, reverse: bool = False):
    """Both cumsum routes' arithmetic in torch, x's dtype, to the bit:
    each row cut into chunks of `chunk` elements (None: one a row, the
    "row" route), in scan order (`reverse` from the row's end). Each
    chunk's total as the first launch takes it (thread t of 256 adds
    elements t + 256 k from the last k down to 0, then common.cuh
    block_reduce); the
    carry of chunk j as the second launch takes it (thread t adds the
    totals t, t + 256, ... before j, then the block's butterflies); then
    the chunk scanned tile by tile from that carry (`_scan_tiles`)."""
    n = x.shape[-1]
    xf = x.reshape(-1, n).float()
    if reverse:
        xf = xf.flip(-1)
    r = xf.shape[0]
    dev = xf.device
    chunk = n if chunk is None else int(chunk)
    chunks = -(-n // chunk)
    span = -(-chunk // SCAN_TILE) * SCAN_TILE
    v = torch.zeros((r, chunks * chunk), dtype=torch.float32, device=dev)
    v[:, :n] = xf
    v = v.reshape(r, chunks, chunk)
    if span != chunk:
        v = torch.cat([v, torch.zeros((r, chunks, span - chunk),
                                      dtype=torch.float32, device=dev)], -1)
    carry = torch.zeros((r, chunks), dtype=torch.float32, device=dev)
    if chunks > 1:
        t = v.reshape(r, chunks, span // SCAN_THREADS, SCAN_THREADS)
        s = torch.zeros((r, chunks, SCAN_THREADS), dtype=torch.float32,
                        device=dev)
        for k in reversed(range(t.shape[2])):
            s = s + t[:, :, k]
        totals = _block_sum(s)[..., 0]                        # (r, chunks)
        before = (torch.arange(chunks, device=dev)[None, :]
                  < torch.arange(chunks, device=dev)[:, None])  # (j, i)
        m = torch.zeros((r, chunks, CUMSUM_MAX_CHUNKS), dtype=torch.float32,
                        device=dev)
        m[..., :chunks] = torch.where(before, totals[:, None, :], 0.0)
        m = m.reshape(r, chunks, CUMSUM_MAX_CHUNKS // SCAN_THREADS,
                      SCAN_THREADS)
        s = torch.zeros((r, chunks, SCAN_THREADS), dtype=torch.float32,
                        device=dev)
        for k in range(m.shape[2]):
            s = s + m[:, :, k]
        carry = _block_sum(s)[..., 0]
    out = _scan_tiles(v, carry)[..., :chunk].reshape(r, chunks * chunk)
    out = out[:, :n]
    if reverse:
        out = out.flip(-1)
    return out.to(x.dtype).reshape(x.shape)


def cumsum_plain(x, reverse: bool = False):
    """Inclusive scan of x along its trailing axis, the JAX
    `_cumsum_kernel`'s math: x cast to f32, jnp.cumsum, cast back to x's
    dtype; `reverse` scans from the end (the flip, scan, flip of the JAX
    VJP)."""
    xf = x.float()
    if reverse:
        return torch.cumsum(xf.flip(-1), dim=-1).flip(-1).to(x.dtype)
    return torch.cumsum(xf, dim=-1).to(x.dtype)


def cumsum(x, reverse: bool = False):
    """Inclusive prefix sum of x along its trailing axis (from the end
    with `reverse`), f32 accumulation, in x's dtype and shape."""
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"cumsum: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    if x.dim() < 1:
        raise ValueError("cumsum: x needs a trailing axis to scan")
    if x.device.type == "cpu":
        return cumsum_plain(x, reverse)
    if x.device.type != "cuda":
        raise ValueError(f"cumsum: no kernel for device {x.device}")
    if not x.is_contiguous():
        raise ValueError("cumsum: x must be contiguous")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    n = x.shape[-1]
    rows = x.numel() // n
    plan = cumsum_plan(rows, n, x.dtype, _sm_count(x.device.index))
    if rows * plan.chunks > 2 ** 31 - 1:
        raise ValueError(f"cumsum: {rows} rows, the kernel's grid takes at "
                         f"most 2^31 - 1")
    totals = (torch.empty((rows, plan.chunks), dtype=torch.float32,
                          device=x.device) if plan.route == "split" else None)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.ff_cumsum(x.data_ptr(), out.data_ptr(), rows, n,
                            int(bool(reverse)), _build.DTYPE_CODES[x.dtype],
                            _build.stream_ptr(x.device),
                            CUMSUM_ROUTES[plan.route], plan.chunk,
                            plan.chunks,
                            totals.data_ptr() if totals is not None else None)
    _build.check(err, "cumsum")
    LAUNCHES["cumsum"] += 1
    ROUTES[f"cumsum/{plan.route}"] += 1
    return out


class _Cumsum(torch.autograd.Function):
    """Saves nothing, as the JAX VJP: the gradient is the reversed scan of
    the cotangent."""

    @staticmethod
    def forward(ctx, x):
        return cumsum(x)

    @staticmethod
    def backward(ctx, g):
        # the kernel reads rows in place: a cotangent that arrives strided
        # (an expanded gradient) is the one copy
        return cumsum(g.contiguous(), reverse=True)


def fused_cumsum(x):
    """Differentiable inclusive prefix sum along the trailing axis through
    `cumsum` (counterpart of the JAX `fused_cumsum`)."""
    return _Cumsum.apply(x)
