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
and the reported metrics after backward, before the optimizer.

Under gloo a CUDA tensor is staged through host memory explicitly
(runtime/distributed.py decides when): copied to the host, reduced or
gathered there, and copied back. That is the transport of ranks that
share one card, not a fallback; STAGED counts its copies and bytes.
GradSyncLowering and the bucketed per-tier plans of the JAX package wait
for ROADMAP A7/A8.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.distributed as dist

from . import distributed

# host-staged collectives since the last reset: device -> host copies and
# the bytes they moved (each copy back moves as many again)
STAGED: Dict[str, int] = {"copies": 0, "bytes": 0}


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
