"""The collectives of tensor- and data-parallel training, written out over
torch.distributed (the JAX package's GSPMD inserts them from the
shardings; flexflow_tpu/runtime/collectives.py lowers its gradient sync).

Every op takes and gives activations replicated over the `model` axis.
A tensor-parallel op computes its shard of the output from its shard of
the weights, then restores the replicated output with one collective,
each an autograd Function:

 - `enter_tp`: identity forward, all-reduce of the input's gradient
   backward (each rank's gradient is the part from its weight shard);
 - `gather_last`: all-gather of the trailing (feature) axis forward, the
   rank's own slice of the gradient backward (column linear, embedding);
 - `reduce_sum`: all-reduce forward, identity backward (attention's
   partial sums over its local heads, before `bo`).

Over the `data` axis, `mean_` averages the gradients (one flat bucket)
and the reported metrics after backward, before the optimizer. An op
whose plan keeps it at dp = 1 on a data axis (the strategy search's
choice) computes the whole batch: `gather_batch` gathers its batch-cut
inputs over `data` before it (all-gather along dim 0 forward), and the
executor cuts its outputs back to the rank's slice after it (a slice, so
autograd pads its gradient with zeros). Backward, `gather_batch` hands
each rank its own slice of the gradient. So each rank's gradient of such
an op's weights holds only its own samples' part, and the weights keep
the data-axis mean like every other: the same numbers as the plan's
GSPMD backward in the JAX package, which gathers the output gradient
instead and leaves those weights out of the mean.

Under gloo a CUDA tensor is staged through host memory explicitly
(runtime/distributed.py decides when): copied to the host, reduced or
gathered there, and copied back. That is the transport of ranks that
share one card, not a fallback; STAGED counts its copies and bytes.
GradSyncLowering and the bucketed per-tier plans of the JAX package wait
for ROADMAP A8; the plan analysis reads the per-tier groups the
lowering would use (`tier_axis_groups`, a copy of the JAX function).
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.distributed as dist

from . import distributed

# host-staged collectives since the last reset: device -> host copies and
# the bytes they moved (each copy back moves as many again)
STAGED: Dict[str, int] = {"copies": 0, "bytes": 0}


class CollectiveLoweringError(ValueError):
    """A reduction plan that cannot be lowered to per-tier collectives
    (the JAX package's error of the same name)."""


def tier_axis_groups(n: int, group_sizes: List[int]
                     ) -> List[List[List[int]]]:
    """Per-tier groups of axis coordinates along one mesh axis of size `n`
    (JAX `runtime/collectives.py tier_axis_groups`). `group_sizes` is the
    tier decomposition inner-first; their product must equal `n`. The
    innermost tier's members are consecutive coordinates; level j's groups
    hold coordinates that differ only in mixed-radix digit j: level 0 of
    (4, 2) over n=8 is [[0..3], [4..7]], level 1 is [[0,4], [1,5], [2,6],
    [3,7]]."""
    if math.prod(group_sizes) != n:
        raise CollectiveLoweringError(
            f"tier group sizes {group_sizes} do not multiply to the axis"
            f" degree {n}")
    out: List[List[List[int]]] = []
    stride = 1
    for nj in group_sizes:
        block = stride * nj
        level = []
        for base in range(0, n, block):
            for r in range(stride):
                level.append([base + r + stride * m for m in range(nj)])
        out.append(level)
        stride = block
    return out


def reset_staged() -> None:
    STAGED["copies"] = 0
    STAGED["bytes"] = 0


def _to_host(t: torch.Tensor) -> torch.Tensor:
    STAGED["copies"] += 1
    STAGED["bytes"] += t.numel() * t.element_size()
    return t.detach().to("cpu", copy=True)


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of `t` over `group`, as a new tensor on t's device."""
    if t.is_cuda and distributed.host_staging():
        h = _to_host(t.contiguous())
        dist.all_reduce(h, group=group)
        return h.to(t.device)
    out = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


def all_gather_last(t: torch.Tensor, group, size: int) -> torch.Tensor:
    """The ranks' `t` of `group` (in rank order) side by side along the
    trailing axis."""
    staged = t.is_cuda and distributed.host_staging()
    src = _to_host(t.contiguous()) if staged else t.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=-1)
    return out.to(t.device) if staged else out


def all_gather_first(t: torch.Tensor, group, size: int) -> torch.Tensor:
    """The ranks' `t` of `group` (in rank order) stacked along dim 0."""
    staged = t.is_cuda and distributed.host_staging()
    src = _to_host(t.contiguous()) if staged else t.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=0)
    return out.to(t.device) if staged else out


class _GatherBatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank, size):
        ctx.rank, ctx.rows = rank, x.shape[0]
        return all_gather_first(x, group, size)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.rank * ctx.rows
        return g[lo:lo + ctx.rows], None, None, None


def gather_batch(x: torch.Tensor, group, rank: int, size: int):
    """The whole batch from the data ranks' slices `x` (this rank's the
    rank-th); backward, this rank's slice of the gradient (see the module
    docstring)."""
    return _GatherBatch.apply(x, group, rank, size)


def cut_batch(x: torch.Tensor, rank: int, size: int) -> torch.Tensor:
    """This rank's slice of a whole-batch value (dim 0 in `size` equal
    parts); the value itself where dim 0 does not divide."""
    if x.dim() == 0 or x.shape[0] % size:
        return x
    n = x.shape[0] // size
    return x.narrow(0, rank * n, n)


class _EnterTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank, size):
        ctx.rank, ctx.width = rank, x.shape[-1]
        return all_gather_last(x, group, size)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.rank * ctx.width
        return g[..., lo:lo + ctx.width], None, None, None


class _ReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def enter_tp(x: torch.Tensor, group) -> torch.Tensor:
    """x as it enters a tensor-parallel op (see the module docstring)."""
    return _EnterTP.apply(x, group)


def gather_last(x: torch.Tensor, group, rank: int, size: int):
    """The replicated output of a feature-sharded op from this rank's
    shard `x` (the rank-th of `size` equal slices)."""
    return _GatherLast.apply(x, group, rank, size)


def reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The replicated sum of the ranks' partial outputs `x`."""
    return _ReduceSum.apply(x, group)


def mean_(tensors: Sequence[torch.Tensor], group, size: int) -> None:
    """Replace each tensor by its mean over `group`, in place, through one
    all-reduce of a flat bucket (the tensors share one dtype)."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    flat = all_reduce(flat, group).div_(size)
    at = 0
    with torch.no_grad():
        for t in tensors:
            n = t.numel()
            t.copy_(flat[at:at + n].view_as(t))
            at += n


def gather_shards(t: torch.Tensor, dim: int, group, size: int):
    """The full tensor from the ranks' equal shards along `dim`."""
    moved = t.detach().movedim(dim, -1)
    return all_gather_last(moved, group, size).movedim(-1, dim)
