"""Parallel ops: explicit resharding nodes in the PCG (the port's copy of
flexflow_tpu/parallel/parallel_ops.py; reference: src/parallel_ops/
{partition,combine,replicate,reduction,fused_parallel_op}.cc).

In the JAX package each parallel op is an identity on a LOGICAL value
that changes its output tensor's ParallelTensorShape; the executor
applies that shape as a sharding constraint and GSPMD emits the
collective. The port has no logical values: each rank's walk
(runtime/executor.py) holds its local piece of every value, with the
mesh axes it is cut over (`data` the batch, dim 0; `seq` the positions,
dim 1; `attr` the H of NCHW, dim 2: runtime/collectives.py CUT_DIMS).
So each op's `reshard` says what it does to the local value and its
cuts, and `apply_parallel_shape` records the same parallel shape the
JAX op records (the search, the cost model and the analysis read it):

| op          | shape change                 | on this rank's value          |
|-------------|------------------------------|-------------------------------|
| Repartition | degree 1 -> k on a dim       | `cut_dim` onto a cut axis     |
| Combine     | degree k -> 1 on a dim       | `gather_dim` off a cut axis   |
| Replicate   | every dim degree 1           | `gather_dim` off every cut    |
| Reduction   | drops the leading replica dim| the sum over it               |
| AllReduce   | none                         | identity                      |

The choices, one by one:

1. Combine and Replicate on an axis the walk cuts make the value whole
   with `collectives.gather_dim`, whose backward is the reduce-scatter:
   each rank gets the sum over the ranks of its slice's gradient. Not
   `gather_batch`, whose backward hands each rank its own slice: that is
   right for a `whole_batch` op only because the executor cuts its
   outputs back at once. After a Combine the value stays whole, so every
   rank's loss reaches every row, and `gather_batch` would leave the
   upstream weights' gradient `dp` times too small after the data mean.
2. Repartition onto a cut axis (`data` on dim 0, `seq` on dim 1, `attr`
   on dim 2) is `cut_dim`, a local slice; on a value already cut there
   it is the identity.
3. On `model`, `expert` and `stage`, and for a partition whose dim is
   not its axis's cut dim, the ops change only the parallel shape: the
   port's ops take and give values replicated over those axes.
4. Reduction sums its explicit leading replica axis, as JAX's does
   (reduction.cc:230 adds num_replicas buffers); its input is made whole
   first, since its dim 0 is not a batch.
5. AllReduce is JAX's identity: the port has no manual region, so there
   are no partial values to reduce at the PCG level.

The walk's other ops then meet values of mixed cuts; the executor cuts
a whole input to the batch slice of its data-cut siblings, and the loss
reads the final value cut like the batch (runtime/executor.py).
"""
from __future__ import annotations

from typing import Dict, List, Optional

from ..core.op import Op, register_op
from ..core.tensor import ParallelDim, ParallelTensorShape
from ..ffconst import OpType

PARALLEL_OP_TYPES = frozenset({OpType.REPARTITION, OpType.COMBINE,
                               OpType.REPLICATE, OpType.REDUCTION,
                               OpType.ALLREDUCE, OpType.FUSED_PARALLEL})


def resolve_partition_axis(op_name: str, dim: int, degree: int,
                           axes: Dict[str, int],
                           axis: Optional[str] = None) -> Optional[str]:
    """Mesh axis a partition descriptor shards over: an explicit axis param
    wins; else the dim-kind convention (dim 0 = batch -> 'data', others ->
    'model'); else any axis whose size matches. Raises when no axis of the
    required size exists (degree > 1 under a non-empty mesh)."""
    if axis is None:
        cand = "data" if dim == 0 else "model"
        if axes.get(cand) == degree:
            axis = cand
        else:
            axis = next((n for n, s in axes.items() if s == degree), None)
    if axis is None:
        if degree > 1 and axes:
            raise ValueError(
                f"partition {op_name}: no mesh axis of size {degree} in {axes}")
        return None
    if axes.get(axis) != degree:
        raise ValueError(
            f"partition {op_name}: axis {axis!r} has size "
            f"{axes.get(axis)}, need {degree}")
    return axis


def _source_dims(op: Op) -> List[ParallelDim]:
    """A copy of the input's parallel dims (replicated where the input
    carries no parallel shape)."""
    t = op.inputs[0]
    ps = getattr(t, "parallel_shape", None)
    if ps is None:
        return [ParallelDim(s) for s in t.dims]
    return [ParallelDim(d.size, d.degree, d.axis) for d in ps.dims]


def _cut_dims():
    from ..runtime.collectives import CUT_DIMS

    return CUT_DIMS


def _partition(v, cuts, mesh, dim: int, axis: Optional[str]):
    """Choice 2: cut `dim` over `axis` where the walk cuts that dim."""
    if (mesh is None or axis is None or axis in cuts
            or _cut_dims().get(axis) != dim % max(v.dim(), 1)
            or mesh.size(axis) == 1 or v.shape[dim] % mesh.size(axis)):
        return v, cuts
    from ..runtime.collectives import cut_dim

    return cut_dim(v, mesh, axis, dim), cuts | {axis}


def _combine(v, cuts, mesh, dim: int):
    """Choice 1: gather the axes that cut `dim`."""
    from ..runtime.collectives import gather_dim

    for axis in sorted(cuts):
        if _cut_dims().get(axis) == dim % max(v.dim(), 1):
            v = gather_dim(v, mesh, axis, dim)
            cuts = cuts - {axis}
    return v, cuts


def _replicate(v, cuts, mesh):
    """Choice 1: gather every cut axis."""
    from ..runtime.collectives import gather_dim

    for axis in sorted(cuts):
        v = gather_dim(v, mesh, axis, _cut_dims()[axis])
    return v, frozenset()


class ParallelOpBase(Op):
    """Base for parallel ops (reference: parallel_op.h:17)."""

    def is_parallel_op(self) -> bool:
        return True

    def output_shapes(self):
        return [self.inputs[0].dims], [self.inputs[0].dtype]

    def lower(self, ctx, inputs):
        # one device: a value identity (the mesh walk calls `reshard`)
        return [inputs[0]]

    def reshard(self, mesh, value, cuts):
        """(this rank's output value, the axes it is cut over) from this
        rank's input value and its cuts (see the module docstring)."""
        return value, cuts


@register_op
class RepartitionOp(ParallelOpBase):
    """Partition a dim to degree k (reference: partition.cc)."""

    op_type = OpType.REPARTITION
    axis: Optional[str] = None

    def apply_parallel_shape(self, axis_name: str):
        self.axis = axis_name
        dim = self.params["dim"]
        dims = _source_dims(self)
        dims[dim] = ParallelDim(dims[dim].size, self.params["degree"],
                                axis_name)
        t = self.outputs[0]
        t.parallel_shape = ParallelTensorShape(dims, t.dtype)

    def reshard(self, mesh, value, cuts):
        return _partition(value, cuts, mesh, self.params["dim"], self.axis)


@register_op
class CombineOp(ParallelOpBase):
    """Gather a partitioned dim back to degree 1 (reference: combine.cc)."""

    op_type = OpType.COMBINE

    def apply_parallel_shape(self):
        dim = self.params["dim"]
        dims = _source_dims(self)
        dims[dim] = ParallelDim(dims[dim].size, 1, None)
        t = self.outputs[0]
        t.parallel_shape = ParallelTensorShape(dims, t.dtype)

    def reshard(self, mesh, value, cuts):
        return _combine(value, cuts, mesh, self.params["dim"])


@register_op
class ReplicateOp(ParallelOpBase):
    """Broadcast to `degree` replicas (reference: replicate.cc): every dim
    unpartitioned."""

    op_type = OpType.REPLICATE

    def apply_parallel_shape(self):
        t = self.outputs[0]
        t.parallel_shape = ParallelTensorShape(
            [ParallelDim(d.size) for d in _source_dims(self)], t.dtype)

    def reshard(self, mesh, value, cuts):
        return _replicate(value, cuts, mesh)


@register_op
class ReductionOp(ParallelOpBase):
    """Sum over an explicit leading replica axis (reference: reduction.cc:230
    sums num_replicas buffers). Input dims: (k, ...) -> output (...)."""

    op_type = OpType.REDUCTION

    def output_shapes(self):
        (x,) = self.inputs
        return [x.dims[1:]], [x.dtype]

    def lower(self, ctx, inputs):
        return [inputs[0].sum(dim=0).to(inputs[0].dtype)]

    def reshard(self, mesh, value, cuts):
        value, _ = _replicate(value, cuts, mesh)
        return value.sum(dim=0).to(value.dtype), frozenset()


@register_op
class AllReduceOp(ParallelOpBase):
    """All-reduce marker: an identity, as the JAX package's outside a
    manual region (choice 5 of the module docstring)."""

    op_type = OpType.ALLREDUCE


def descriptors_of(op: Op) -> List[dict]:
    """The descriptors a FusedParallelOp absorbs (reference:
    FusedParallelOp's ParallelOpInfo{op_type, parallel_dim,
    parallel_degree}, include/flexflow/parallel_ops/parallel_op.h)."""
    if op.op_type == OpType.REPARTITION:
        return [{"type": "partition", "dim": op.params["dim"],
                 "degree": op.params["degree"],
                 "axis": op.params.get("axis")}]
    if op.op_type == OpType.COMBINE:
        return [{"type": "combine", "dim": op.params["dim"]}]
    if op.op_type == OpType.REPLICATE:
        return [{"type": "replicate"}]
    if op.op_type == OpType.FUSED_PARALLEL:
        return [dict(d) for d in op.params["descriptors"]]
    raise ValueError(f"{op.op_type} has no parallel descriptor")


@register_op
class FusedParallelOp(ParallelOpBase):
    """Composition of parallel-op descriptors applied as one reshard
    (reference: fused_parallel_op.cc). The output's parallel shape is the
    chain's final state; on a rank the descriptors apply in order.

    params["descriptors"]: list of {"type": "partition"|"combine"|
    "replicate", "dim": int, "degree": int, "axis": Optional[str]} applied
    in order (dim/degree/axis per type as in the standalone ops)."""

    op_type = OpType.FUSED_PARALLEL
    axes: Optional[List[Optional[str]]] = None

    def apply_parallel_shape(self, axes: Dict[str, int]) -> None:
        t = self.outputs[0]
        dims = _source_dims(self)
        resolved: List[Optional[str]] = []
        for desc in self.params["descriptors"]:
            kind = desc["type"]
            axis = None
            if kind == "partition":
                dim, degree = desc["dim"], desc["degree"]
                axis = resolve_partition_axis(self.name, dim, degree, axes,
                                              axis=desc.get("axis"))
                if axis is not None:
                    dims[dim] = ParallelDim(dims[dim].size, degree, axis)
            elif kind == "combine":
                dim = desc["dim"]
                dims[dim] = ParallelDim(dims[dim].size, 1, None)
            elif kind == "replicate":
                dims = [ParallelDim(d.size) for d in dims]
            else:
                raise ValueError(
                    f"{self.name}: unknown parallel descriptor type {kind!r}")
            resolved.append(axis)
        self.axes = resolved
        t.parallel_shape = ParallelTensorShape(dims, t.dtype)

    def reshard(self, mesh, value, cuts):
        for desc, axis in zip(self.params["descriptors"], self.axes or ()):
            if desc["type"] == "partition":
                value, cuts = _partition(value, cuts, mesh, desc["dim"], axis)
            elif desc["type"] == "combine":
                value, cuts = _combine(value, cuts, mesh, desc["dim"])
            else:
                value, cuts = _replicate(value, cuts, mesh)
        return value, cuts
