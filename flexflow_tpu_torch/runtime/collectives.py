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

The other mesh axes (core/machine.py) cut an activation dim instead:
`seq` the positions, `attr` the H of NCHW values. Over `data`, `seq`
and `attr` each rank's gradients are averaged after the backward (the
executor), so a collective between the ranks of those axes must give in
its backward the sum, over the ranks, of what each rank's loss
contributes: the transpose of the forward. These are:

 - `gather_dim`: all-gather along any dim forward, reduce-scatter
   backward (each rank sums the ranks' gradients of its own slice);
   `cut_dim` is its local inverse (a slice);
 - `ppermute`: a ring shift over an axis group (coordinate i's tensor
   goes to i + shift), the opposite shift backward (ring attention's
   K/V rotation, the pipeline's activation hop);
 - `all_to_all`: the tiled all-to-all (split one dim into the group's
   chunks, chunk j to coordinate j, the received chunks concatenated
   along another dim), the opposite all-to-all backward (Ulysses);
 - `halo`: the neighbours' edge rows along one dim (the previous
   coordinate's last rows before, the next's first rows after, a fill
   value past either end of the axis), backward the halo rows'
   gradients sent back and added to their owners' rows (attr
   convolutions and pools);
 - `psum`: all-reduce forward and backward (batch statistics over the
   global batch).

Over `expert` and `stage` the loss is the same on every rank and the
gradients are not averaged, as over `model`: the expert combine is a
`reduce_sum` and its inputs enter through `enter_tp`; the pipeline's
last stage hands its outputs to every stage by `broadcast_from`, whose
backward keeps the gradient on the source alone.

Under gloo a CUDA tensor is staged through host memory explicitly
(runtime/distributed.py decides when): copied to the host, reduced or
gathered there, and copied back. That is the transport of ranks that
share one card, not a fallback; STAGED counts its copies and bytes.

The data axis's gradient sync (JAX `GradSyncLowering`, under
`config.collective_lowering`): "gspmd" is the one flat bucket of
`mean_`; "explicit" (and "auto" where the plan crosses a tier boundary)
runs the searched reduction plan, per synced tensor or fused bucket, as
grouped collectives over the tier groups of the data axis
(`tier_axis_groups`): `flat` one all-reduce, `hier_ring` one all-reduce
a tier inner-first, `rs_ar_ag` a reduce-scatter up the inner tiers, an
all-reduce across the outermost and an all-gather back down. Gloo has
no reduce-scatter, so it is the point-to-point all-to-all of
`_all_to_all_raw` and a sum, as `_GatherDim.backward`'s. The tier
groups are made once, by every rank in one order, when compile plans
the lowering (`make_tier_groups`), never inside a step.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..obs.registry import REGISTRY
from ..obs.tracing import get_tracer
from . import distributed

COLLECTIVE_LOWERINGS = ("gspmd", "explicit", "auto")

# the dim each activation-cutting mesh axis cuts (runtime/executor.py)
CUT_DIMS = {"data": 0, "seq": 1, "attr": 2}

# host-staged collectives since the last reset: device -> host copies and
# the bytes they moved (each copy back moves as many again)
STAGED: Dict[str, int] = {"copies": 0, "bytes": 0}


class CollectiveLoweringError(ValueError):
    """collective_lowering="explicit" was asked for but the compiled plan
    cannot be lowered explicitly (the error names every reason)."""


def lowered_counter():
    """The process-wide lowering counter (one schema, shared with the
    resharding transfer path)."""
    return REGISTRY.counter(
        "ff_collective_lowered_total",
        "Collectives lowered explicitly, by reduction strategy and tier",
        labels=("strategy", "tier"))


def overlap_bucket_counter():
    """Bucketed grad-sync collectives lowered: one per bucket, each ONE
    fused per-tier collective over its concatenated tensors."""
    return REGISTRY.counter(
        "ff_grad_sync_overlap_buckets_total",
        "Bucketed grad-sync collectives lowered, by reduction strategy",
        labels=("strategy",))


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


def _staged_src(t: torch.Tensor):
    """(the tensor to send, staged): a host copy of a CUDA tensor under
    gloo (counted in STAGED), else t itself, contiguous."""
    staged = t.is_cuda and distributed.host_staging()
    return (_to_host(t.contiguous()) if staged
            else t.detach().contiguous()), staged


def _ppermute_raw(t: torch.Tensor, ranks: Sequence[int], index: int,
                  shift: int, group) -> torch.Tensor:
    """The tensor coordinate (index - shift) sends when every coordinate
    i sends `t` to (i + shift) mod n (`ranks`: the group's global ranks
    in coordinate order)."""
    n = len(ranks)
    src, staged = _staged_src(t)
    out = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, ranks[(index + shift) % n], group),
           dist.P2POp(dist.irecv, out, ranks[(index - shift) % n], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out.to(t.device) if staged else out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ranks, index, shift, group):
        ctx.conf = (ranks, index, shift, group)
        return _ppermute_raw(x, ranks, index, shift, group)

    @staticmethod
    def backward(ctx, g):
        ranks, index, shift, group = ctx.conf
        return _ppermute_raw(g, ranks, index, -shift, group), None, None, \
            None, None


def ppermute(x: torch.Tensor, mesh, axis: str, shift: int = 1):
    """The ring shift of `x` over `mesh`'s `axis` group: what coordinate
    (i - shift) mod n holds; backward, the opposite shift."""
    return _PPermute.apply(x, mesh.group_ranks[axis], mesh.index(axis),
                           shift, mesh.group(axis))


def _all_to_all_raw(t: torch.Tensor, ranks: Sequence[int], index: int,
                    split: int, concat: int, group) -> torch.Tensor:
    """The tiled all-to-all as point-to-point sends and receives (gloo
    has no list all-to-all in every torch build): chunk j of `t` along
    `split` to coordinate j, the chunks received concatenated along
    `concat` in coordinate order (this rank's own chunk kept)."""
    n = len(ranks)
    src, staged = _staged_src(t)
    ins = [c.contiguous() for c in src.chunk(n, dim=split)]
    outs = [ins[j] if j == index else torch.empty_like(ins[j])
            for j in range(n)]
    ops = []
    for j in range(n):
        if j != index:
            ops.append(dist.P2POp(dist.isend, ins[j], ranks[j], group))
            ops.append(dist.P2POp(dist.irecv, outs[j], ranks[j], group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    out = torch.cat(outs, dim=concat)
    return out.to(t.device) if staged else out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ranks, index, split, concat, group):
        ctx.conf = (ranks, index, split, concat, group)
        return _all_to_all_raw(x, ranks, index, split, concat, group)

    @staticmethod
    def backward(ctx, g):
        ranks, index, split, concat, group = ctx.conf
        return _all_to_all_raw(g, ranks, index, concat, split, group), \
            None, None, None, None, None


def all_to_all(x: torch.Tensor, mesh, axis: str, split: int, concat: int):
    """The tiled all-to-all over `axis` (JAX `lax.all_to_all(...,
    tiled=True)`): dim `split` cut into the group's n chunks, chunk j to
    coordinate j, the n chunks received concatenated along `concat` in
    coordinate order; backward, the opposite all-to-all."""
    return _AllToAll.apply(x, mesh.group_ranks[axis], mesh.index(axis),
                           split, concat, mesh.group(axis))


def _reduce_scatter(t: torch.Tensor, dim: int, ranks: Sequence[int],
                    index: int, group) -> torch.Tensor:
    """This member's 1/n along `dim` of the sum over the group of each
    member's `t` (`dim` a multiple of n): the all-to-all of the n chunks
    (gloo has no reduce-scatter), then their sum in member order."""
    parts = _all_to_all_raw(t, ranks, index, dim, 0, group).chunk(
        len(ranks), dim=0)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, ranks, index, group):
        ctx.conf = (dim, ranks, index, group)
        moved = x.detach().movedim(dim, -1)
        return all_gather_last(moved, group, len(ranks)).movedim(-1, dim)

    @staticmethod
    def backward(ctx, g):
        dim, ranks, index, group = ctx.conf
        return _reduce_scatter(g, dim, ranks, index, group), None, None, \
            None, None


def gather_dim(x: torch.Tensor, mesh, axis: str, dim: int):
    """The whole of a value cut along `dim` over `axis` (the ranks' equal
    slices in coordinate order); backward, the sum over the ranks of the
    gradients of this rank's slice (a reduce-scatter)."""
    return _GatherDim.apply(x, dim % x.dim(), mesh.group_ranks[axis],
                            mesh.index(axis), mesh.group(axis))


def cut_dim(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """This rank's slice along `dim` of a value whole over `axis`."""
    n = mesh.size(axis)
    m = x.shape[dim] // n
    return x.narrow(dim, mesh.index(axis) * m, m)


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, before, after, fill, ranks, index, group):
        n, rows = len(ranks), x.shape[dim]
        ctx.conf = (dim, before, after, ranks, index, group, rows)
        parts = []
        if before:
            got = _ppermute_raw(x.narrow(dim, rows - before, before), ranks,
                                index, 1, group)
            if index == 0:
                got.fill_(fill)
            parts.append(got)
        parts.append(x)
        if after:
            got = _ppermute_raw(x.narrow(dim, 0, after), ranks, index, -1,
                                group)
            if index == n - 1:
                got.fill_(fill)
            parts.append(got)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        dim, before, after, ranks, index, group, rows = ctx.conf
        n = len(ranks)
        gx = g.narrow(dim, before, rows).clone()
        if before:
            back = _ppermute_raw(g.narrow(dim, 0, before), ranks, index, -1,
                                 group)
            if index != n - 1:
                gx.narrow(dim, rows - before, before).add_(back)
        if after:
            back = _ppermute_raw(g.narrow(dim, before + rows, after), ranks,
                                 index, 1, group)
            if index != 0:
                gx.narrow(dim, 0, after).add_(back)
        return gx, None, None, None, None, None, None, None


def halo(x: torch.Tensor, mesh, axis: str, dim: int, before: int,
         after: int, fill: float = 0.0) -> torch.Tensor:
    """x with `before` rows of the previous coordinate's end and `after`
    rows of the next's start around it along `dim` (`fill` past the ends
    of the axis); backward, the halo rows' gradients added to their
    owners' rows. Each halo fits in one neighbour's rows."""
    if max(before, after) > x.shape[dim]:
        raise ValueError(f"halo of {before} / {after} rows over slices of "
                         f"{x.shape[dim]} rows: a halo must fit in one "
                         "neighbour's slice")
    return _Halo.apply(x, dim % x.dim(), before, after, fill,
                       mesh.group_ranks[axis], mesh.index(axis),
                       mesh.group(axis))


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over `group`; backward, the sum of the gradients
    (see the module docstring)."""
    return _PSum.apply(x, group)


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, src, is_src, group):
        ctx.is_src = is_src
        buf, staged = _staged_src(x)
        if not staged:
            buf = buf.clone()
        dist.broadcast(buf, src, group=group)
        return buf.to(x.device) if staged else buf

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.is_src else torch.zeros_like(g)), None, None, None


def broadcast_from(x: torch.Tensor, mesh, axis: str, index: int):
    """Coordinate `index`'s x on every rank of `axis`; backward, the
    gradient on that coordinate alone (the loss is the same on every
    rank)."""
    return _Broadcast.apply(x, mesh.group_ranks[axis][index],
                            mesh.index(axis) == index, mesh.group(axis))


def gather_shards(t: torch.Tensor, dim: int, group, size: int):
    """The full tensor from the ranks' equal shards along `dim`."""
    moved = t.detach().movedim(dim, -1)
    return all_gather_last(moved, group, size).movedim(-1, dim)


def allgather_dims(x: torch.Tensor, mesh, axes: Sequence[Optional[str]],
                   dims: Sequence[int]) -> torch.Tensor:
    """`x` gathered along each dim of `dims` over the group of its mesh
    axis (`axes[d]`), the other dims as they are; no gradient (JAX
    `kernels/redistribute.py allgather_dims`, the resharding executor's
    same-mesh gather)."""
    for d in dims:
        x = gather_shards(x, d, mesh.group(axes[d]), mesh.size(axes[d]))
    return x


# -- the explicit gradient sync (the module docstring) ----------------------

@dataclasses.dataclass
class TierGroups:
    """One tier decomposition of the data axis: for each level
    (inner-first), this rank's group, its members' global ranks in
    coordinate order and its position among them."""

    sizes: Tuple[int, ...]
    groups: List[Any]
    ranks: List[List[int]]
    index: List[int]


def make_tier_groups(mesh, sizes: Sequence[int]) -> Optional[TierGroups]:
    """The process groups of each tier level of `mesh`'s data axis
    (`tier_axis_groups`), made by every rank of the world in the same
    order (a rank past the mesh too, which holds none: None)."""
    n = mesh.size("data")
    coords_ranks = mesh.group_ranks.get("data") or list(range(n))
    mine = None
    if mesh.holds_position:
        mine = TierGroups(tuple(sizes), [], [], [])
    for level in tier_axis_groups(n, list(sizes)):
        for coords in level:
            ranks = [coords_ranks[c] for c in coords]
            group = dist.new_group(ranks)
            if mine is not None and mesh.rank in ranks:
                mine.groups.append(group)
                mine.ranks.append(ranks)
                mine.index.append(ranks.index(mesh.rank))
    return mine


def lower_allreduce(x: torch.Tensor, strategy: str, tiers: TierGroups,
                    flat_group) -> torch.Tensor:
    """One synced tensor's explicit all-reduce (SUM) over the data axis,
    decomposed per `strategy` over the tier groups (JAX
    `lower_allreduce`). The caller divides by the degree for the MEAN."""
    if strategy == "flat" or len(tiers.sizes) <= 1:
        return all_reduce(x, flat_group)
    if strategy == "hier_ring":
        # a full-bytes ring per tier, inner-first
        for group in tiers.groups:
            x = all_reduce(x, group)
        return x
    if strategy == "rs_ar_ag":
        shape, size = x.shape, x.numel()
        flat = x.reshape(-1)
        inner = math.prod(tiers.sizes[:-1])
        pad = (-size) % inner
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        levels = list(zip(tiers.groups, tiers.ranks, tiers.index))
        # reduce-scatter up the inner tiers: each phase leaves this rank
        # its 1/nj shard of its group's partial sum
        for group, ranks, index in levels[:-1]:
            flat = _reduce_scatter(flat, 0, ranks, index, group)
        # all-reduce the residual shard across the outermost tier
        flat = all_reduce(flat, levels[-1][0])
        # all-gather back down, mirroring the scatter order
        for group, ranks, _ in reversed(levels[:-1]):
            flat = all_gather_first(flat, group, len(ranks))
        if pad:
            flat = flat[:size]
        return flat.reshape(shape)
    raise CollectiveLoweringError(
        f"unknown reduction strategy {strategy!r}; choices:"
        " flat, rs_ar_ag, hier_ring")


@dataclasses.dataclass
class GradSyncLowering:
    """The executable form of a reduction plan (JAX `GradSyncLowering`):
    per synced op, the strategy and tier group sizes its gradients'
    all-reduce decomposes into along the data axis."""

    axis_name: str
    degree: int
    # op name -> {"strategy", "sizes": [inner..outer], "tiers": [names],
    # "bucket": priced bucket id or None (per-tensor), "bytes"}
    entries: Dict[str, Dict[str, Any]]
    mode: str = "explicit"
    # sizes tuple -> this rank's TierGroups (make_groups)
    tier_groups: Dict[Tuple[int, ...], Any] = dataclasses.field(
        default_factory=dict)
    flat_group: Any = None

    def executed_plan(self) -> Dict[str, str]:
        """{op name: strategy} as lowered — what the FFTA072 analysis
        check compares the priced reduction_plan against."""
        return {name: e["strategy"] for name, e in self.entries.items()}

    def executed_buckets(self) -> Dict[str, Optional[int]]:
        """{op name: bucket id (None = per-tensor)} as lowered."""
        return {name: e.get("bucket")
                for name, e in self.entries.items()}

    def bucket_map(self) -> Dict[int, List[str]]:
        """{bucket id: [op names]} over the bucketed entries, in entry
        (topo) order — each bucket lowers as ONE fused collective over
        its members' concatenated gradients."""
        out: Dict[int, List[str]] = {}
        for name, e in self.entries.items():
            bid = e.get("bucket")
            if bid is not None:
                out.setdefault(bid, []).append(name)
        return out

    def strategy_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self.entries.values():
            out[e["strategy"]] = out.get(e["strategy"], 0) + 1
        return out

    def make_groups(self, mesh) -> None:
        """The tier groups of every decomposition the entries use, made
        once by every rank of the world in entry order (compile calls
        it, before any step)."""
        self.flat_group = mesh.group("data")
        for e in self.entries.values():
            sizes = tuple(e["sizes"])
            if len(sizes) > 1 and sizes not in self.tier_groups:
                self.tier_groups[sizes] = make_tier_groups(mesh, sizes)

    def _reduce(self, x: torch.Tensor, e) -> torch.Tensor:
        strategy = e["strategy"] if e else "flat"
        sizes = tuple(e["sizes"]) if e else (self.degree,)
        tiers = self.tier_groups.get(sizes) or TierGroups(sizes, [], [], [])
        return lower_allreduce(x, strategy, tiers,
                               self.flat_group).div_(self.degree)

    def sync_tree(self, grads: Dict[str, Dict[str, torch.Tensor]]) -> None:
        """Replace each gradient of a {op: {weight: grad}} tree by its
        data-group MEAN, in place, with each op's planned strategy (ops
        absent from the plan sync flat). A bucket's members are flattened
        and concatenated (per dtype), reduced as one, and split back.
        Every result is computed before any is written: autograd may hand
        one tensor to two weights."""
        results: List[Tuple[torch.Tensor, torch.Tensor]] = []
        buckets: Dict[int, List[torch.Tensor]] = {}
        for op_name, sub in grads.items():
            e = self.entries.get(op_name)
            if e is not None and e.get("bucket") is not None:
                buckets.setdefault(e["bucket"], []).extend(sub.values())
                continue
            for g in sub.values():
                results.append((g, self._reduce(g, e)))
        for bid in sorted(buckets):
            e0 = self.entries[self.bucket_map()[bid][0]]
            by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
            for g in buckets[bid]:
                by_dtype.setdefault(g.dtype, []).append(g)
            for gs in by_dtype.values():
                red = self._reduce(torch.cat([g.reshape(-1) for g in gs]),
                                   e0)
                at = 0
                for g in gs:
                    results.append((g, red[at:at + g.numel()].view_as(g)))
                    at += g.numel()
        with torch.no_grad():
            for g, r in results:
                g.copy_(r)

    def record(self) -> None:
        """Count every lowered tensor on
        ff_collective_lowered_total{strategy,tier} (and each bucket on
        ff_grad_sync_overlap_buckets_total{strategy}) and emit the
        exec.grad_sync span carrying the executed schedule, with one
        exec.grad_sync.bucket child a bucket. Once per lowering."""
        if getattr(self, "_recorded", False):
            return
        self._recorded = True
        c = lowered_counter()
        buckets = self.bucket_map()
        tracer = get_tracer()
        with tracer.span(
                "exec.grad_sync", mode=self.mode, axis=self.axis_name,
                degree=self.degree, tensors=len(self.entries),
                buckets=len(buckets),
                strategies=self.strategy_counts()):
            for e in self.entries.values():
                for tier in (e["tiers"] or ["mesh"]):
                    c.inc(strategy=e["strategy"], tier=tier)
            bc = overlap_bucket_counter()
            for bid, names in sorted(buckets.items()):
                e0 = self.entries[names[0]]
                bc.inc(strategy=e0["strategy"])
                with tracer.span("exec.grad_sync.bucket", bucket=bid,
                                 tensors=len(names),
                                 strategy=e0["strategy"],
                                 bytes=sum(self.entries[n].get("bytes")
                                           or 0 for n in names)):
                    pass


def plan_grad_sync_lowering(config, graph, mesh, reduction_plan,
                            pipeline_plan=None
                            ) -> Tuple[Optional[GradSyncLowering],
                                       Tuple[str, ...]]:
    """Decide whether (and how) to lower the reduction plan explicitly
    (JAX `plan_grad_sync_lowering`, the same reasons). Returns
    (lowering, reasons): lowering is None when the flat mean should run,
    because the knob says so, because ``auto`` found nothing cross-tier
    to decompose, or because the plan is unsupported (reasons name why;
    the caller raises for mode ``explicit``). Supported means: a 'data'
    mesh axis (degree > 1) carries every sync group, no pipeline region
    and no other mesh axis, and no ops with running state. `mesh` is a
    core.machine.Mesh (or None). The lowering's tier groups are not made
    here: the caller makes them on every rank (make_groups)."""
    mode = getattr(config, "collective_lowering", "gspmd") or "gspmd"
    if mode not in COLLECTIVE_LOWERINGS:
        raise CollectiveLoweringError(
            f"collective_lowering={mode!r}: choices are"
            f" {COLLECTIVE_LOWERINGS}")
    if mode == "gspmd":
        return None, ()
    reasons: List[str] = []
    axis = "data"
    shape = dict(mesh.shape) if mesh is not None else {}
    dp = int(shape.get(axis, 1))
    if dp <= 1:
        reasons.append("no 'data' mesh axis with degree > 1 to sync over")
    if pipeline_plan is not None:
        reasons.append("the pipeline region already lowers through its"
                       " own shard_map (nesting is illegal)")
    other = sorted(a for a, s in shape.items() if a != axis and s > 1)
    if other:
        reasons.append(
            "mesh axes beyond 'data' cannot be lowered explicitly"
            " yet: " + ", ".join(other))
    stateful = sorted(op.name for op in graph.ops.values()
                      if op.state_vars)
    if stateful:
        reasons.append(
            "ops with running state need GSPMD's global batch statistics:"
            " " + ", ".join(stateful[:3]))
    plan = dict(reduction_plan or {})
    if not reasons:
        mismatched = sorted(
            name for name, e in plan.items()
            if int(e.get("degree") or dp) != dp)
        if mismatched:
            reasons.append(
                "sync group != the data axis (dp x ap attribute-parallel"
                " sync) for: " + ", ".join(mismatched[:3]))
    if reasons:
        return None, tuple(reasons)
    entries: Dict[str, Dict[str, Any]] = {}
    for op in graph.topo_order():
        if not op.weights:
            continue
        e = plan.get(op.name)
        strategy, sizes, tiers, bucket = "flat", [dp], [], None
        if e:
            tier_list = e.get("tiers") or []
            cand = [int(t["group"]) for t in tier_list]
            if cand and math.prod(cand) == dp:
                strategy = str(e.get("strategy", "flat"))
                sizes = cand
                tiers = [str(t["tier"]) for t in tier_list]
                bucket = e.get("bucket")
        entries[op.name] = {"strategy": strategy, "sizes": sizes,
                            "tiers": tiers, "bucket": bucket,
                            "bytes": float((e or {}).get("bytes") or 0.0)}
    if mode == "auto" and not any(len(e["sizes"]) > 1
                                  for e in entries.values()):
        return None, ("auto: no cross-tier reduction to decompose — the"
                      " flat mean is already tier-optimal",)
    if not entries:
        return None, ("no synced weight tensors",)
    lowering = GradSyncLowering(axis_name=axis, degree=dp,
                                entries=entries, mode=mode)
    _verify_lowered_program(config, graph, lowering)
    return lowering, ()


def _verify_lowered_program(config, graph, lowering) -> None:
    """The sharding-flow gate before the lowering's first step (JAX
    `_verify_lowered_program`): the executed program must discharge every
    pending gradient (FFTA090), carry partition-legal groups (FFTA091),
    and be deadlock-free (FFTA092). Honors plan_analysis: "error" raises
    PlanAnalysisError, "warn" logs, "off" skips."""
    gate = getattr(config, "plan_analysis", "error") or "error"
    if gate == "off":
        return
    from ..analysis.diagnostics import (DiagnosticReport,
                                        PlanAnalysisError, record_report)
    from ..analysis.interp import verify_grad_sync_program

    report = DiagnosticReport(passes_run=["collective_program"])
    report.extend(verify_grad_sync_program(lowering, graph=graph))
    if not report.diagnostics:
        return
    record_report(report)
    import logging

    log = logging.getLogger("flexflow_tpu_torch.collectives")
    for d in report.diagnostics:
        log.warning("collective program: %s", d.format())
    if gate == "error" and report.errors():
        raise PlanAnalysisError(report)
