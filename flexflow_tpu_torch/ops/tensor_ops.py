"""Shape and data-movement ops, reductions, TopK and BatchMatmul
(counterpart of flexflow_tpu/ops/tensor_ops.py).

Each is a plain torch call, as the JAX package's are jax / lax
primitives with no Pallas kernel. BatchMatmul's product is
`torch.matmul` (cuBLAS on the card), as the JAX package leaves its
`jnp.matmul` to XLA.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.op import Op, register_op
from ..ffconst import DataType, OpType
from .common import emit_dtype, matmul_dtype


@register_op
class ReshapeOp(Op):
    op_type = OpType.RESHAPE

    def output_shapes(self):
        (x,) = self.inputs
        shape = tuple(self.params["shape"])
        if -1 in shape:
            known = int(np.prod([s for s in shape if s != -1]))
            total = int(np.prod(x.dims))
            shape = tuple(total // known if s == -1 else s for s in shape)
        if int(np.prod(shape)) != int(np.prod(x.dims)):
            raise ValueError(f"reshape {x.dims} -> {shape}: sizes differ")
        return [shape], [x.dtype]

    def lower(self, ctx, inputs):
        x = inputs[0]
        shape = self.outputs[0].dims
        declared = self.inputs[0].dims[0]
        if x.shape[0] != declared and shape[0] == declared:
            # a data rank holds its slice of the batch (FFModel._batch)
            shape = (x.shape[0],) + shape[1:]
        return [x.reshape(shape)]


@register_op
class TransposeOp(Op):
    op_type = OpType.TRANSPOSE

    def output_shapes(self):
        (x,) = self.inputs
        return [tuple(x.dims[p] for p in self.params["perm"])], [x.dtype]

    def lower(self, ctx, inputs):
        return [inputs[0].permute(*self.params["perm"])]


@register_op
class ReverseOp(Op):
    op_type = OpType.REVERSE

    def output_shapes(self):
        return [self.inputs[0].dims], [self.inputs[0].dtype]

    def lower(self, ctx, inputs):
        axis = self.params["axis"]
        return [torch.flip(inputs[0], dims=(axis,))]


@register_op
class ConcatOp(Op):
    op_type = OpType.CONCAT

    def output_shapes(self):
        axis = self.params["axis"]
        base = list(self.inputs[0].dims)
        base[axis] = sum(t.dims[axis] for t in self.inputs)
        return [tuple(base)], [self.inputs[0].dtype]

    def lower(self, ctx, inputs):
        return [torch.cat(inputs, dim=self.params["axis"])]


@register_op
class SplitOp(Op):
    op_type = OpType.SPLIT

    def output_shapes(self):
        (x,) = self.inputs
        axis, sizes = self.params["axis"], self.params["sizes"]
        if sum(sizes) != x.dims[axis]:
            raise ValueError(f"split sizes {sizes} do not sum to dim "
                             f"{axis} of {x.dims}")
        outs = []
        for s in sizes:
            d = list(x.dims)
            d[axis] = s
            outs.append(tuple(d))
        return outs, [x.dtype] * len(sizes)

    def lower(self, ctx, inputs):
        return list(torch.split(inputs[0], list(self.params["sizes"]),
                                dim=self.params["axis"]))


@register_op
class GatherOp(Op):
    """Gather along a dim with an index tensor of the same rank
    (`take_along_axis` / torch.gather semantics)."""

    op_type = OpType.GATHER

    def output_shapes(self):
        _, idx = self.inputs
        return [idx.dims], [self.inputs[0].dtype]

    def lower(self, ctx, inputs):
        x, idx = inputs
        return [torch.gather(x, self.params.get("axis", 0), idx.long())]


def _reduced_dims(x, axes, keepdims):
    return tuple(1 if i in axes else d for i, d in enumerate(x.dims)
                 if keepdims or i not in axes)


class _Reduce(Op):
    def output_shapes(self):
        (x,) = self.inputs
        return [_reduced_dims(x, tuple(self.params["axes"]),
                              self.params.get("keepdims", False))], [x.dtype]


@register_op
class ReduceSumOp(_Reduce):
    op_type = OpType.REDUCE_SUM

    def lower(self, ctx, inputs):
        return [torch.sum(inputs[0], dim=tuple(self.params["axes"]),
                          keepdim=self.params.get("keepdims", False))]


@register_op
class MeanOp(_Reduce):
    op_type = OpType.MEAN

    def lower(self, ctx, inputs):
        return [torch.mean(inputs[0], dim=tuple(self.params["axes"]),
                           keepdim=self.params.get("keepdims", False))]


@register_op
class TopKOp(Op):
    """The k largest values along the last dim, largest first, and their
    int32 indices (`jax.lax.top_k`)."""

    op_type = OpType.TOPK

    def output_shapes(self):
        (x,) = self.inputs
        out = x.dims[:-1] + (self.params["k"],)
        return [out, out], [x.dtype, DataType.DT_INT32]

    def lower(self, ctx, inputs):
        values, indices = torch.topk(inputs[0], self.params["k"], dim=-1)
        return [values, indices.to(torch.int32)]


@register_op
class BatchMatmulOp(Op):
    """Batched matmul. `a_seq_length_dim` / `b_seq_length_dim` are kept as
    the JAX op keeps them; they slice a declared sequence dim to an
    iteration's seq_length, which only the manual training loop
    (`forward(seq_length)`, not ported) sets, so here they slice
    nothing."""

    op_type = OpType.BATCHMATMUL

    def output_shapes(self):
        a, b = self.inputs
        if a.dims[:-2] != b.dims[:-2] or a.dims[-1] != b.dims[-2]:
            raise ValueError(f"batch_matmul {a.dims} x {b.dims}: shapes do "
                             "not chain")
        return [a.dims[:-1] + (b.dims[-1],)], [a.dtype]

    def lower(self, ctx, inputs):
        a, b = inputs
        cdt = matmul_dtype(ctx.config, a.dtype)
        # f32 accumulation, one rounding to the boundary dtype, as Linear
        odt = emit_dtype(ctx.config, self.outputs[0].dtype)
        return [torch.matmul(a.to(cdt), b.to(cdt)).to(odt)]

    def flops(self) -> float:
        a, b = self.inputs
        return 2.0 * int(np.prod(a.dims[:-2])) * a.dims[-2] * a.dims[-1] \
            * b.dims[-1]
