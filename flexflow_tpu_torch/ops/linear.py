"""Linear / Dense (counterpart of flexflow_tpu/ops/linear.py).

Weight layout (in_dim, out_dim), as in the JAX package. The product is a
plain `torch.matmul` (cuBLAS on the card), which is what the JAX package
leaves to XLA.

Column-parallel on a mesh (`kernel` sharded on out_dim, `bias` on its
one dim, search/simulator.py TP_WEIGHT_SHARD_DIMS): each rank computes
its columns from the replicated input, then the output is all-gathered
(runtime/collectives.py). Where every consumer of the output is a
row-parallel linear of the same degree (the Megatron pair), the output
stays this rank's columns (`gather_out` off, FFModel._assign_strategy).

Row-parallel (`tp_row`, the plan's other half of the pair: `kernel`
sharded on in_dim, `bias` whole, JAX `model.py:1111-1127`): the rank
multiplies its slice of the input features (the producer's columns as
they come, or its slice of a replicated input) by its rows of the
kernel, the partial products are summed over `model` in f32
(`reduce_sum`: one all-reduce, no gather), then cast, and the bias is
added once, after the sum."""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..core.op import Op, WeightSpec, register_op
from ..ffconst import ActiMode, OpType
from ..runtime.collectives import enter_tp, gather_last, reduce_sum
from ..runtime.initializers import DefaultInitializer, ZeroInitializer
from .common import apply_activation, emit_dtype, matmul_dtype


@register_op
class LinearOp(Op):
    op_type = OpType.LINEAR

    def output_shapes(self):
        (x,) = self.inputs
        dtype = self.params.get("dtype") or x.dtype
        return [x.dims[:-1] + (self.params["out_dim"],)], [dtype]

    def weight_specs(self) -> List[WeightSpec]:
        (x,) = self.inputs
        out_dim = self.params["out_dim"]
        dtype = self.params.get("dtype") or x.dtype
        specs = [WeightSpec(
            "kernel", (x.dims[-1], out_dim), dtype,
            self.params.get("kernel_initializer") or DefaultInitializer())]
        if self.params.get("use_bias", True):
            specs.append(WeightSpec(
                "bias", (out_dim,), dtype,
                self.params.get("bias_initializer") or ZeroInitializer()))
        return specs

    # False: a column-parallel output stays sharded (the Megatron pair)
    gather_out = True

    def lower(self, ctx, inputs):
        x = inputs[0]
        if self.row_parallel and self.tp_degree > 1:
            return [self._row_parallel(ctx, x)]
        if self.tp_degree > 1:
            x = enter_tp(x, ctx.mesh.group("model"))
        cdt = matmul_dtype(ctx.config, x.dtype)
        # the product accumulates in f32 and is rounded once to the
        # boundary dtype; bias and activation then run in that dtype
        odt = emit_dtype(ctx.config, self.outputs[0].dtype)
        y = torch.matmul(x.to(cdt), self.w("kernel", cdt)).to(odt)
        if self.has_weight("bias"):
            y = y + self.w("bias", odt)
        y = apply_activation(
            y, self.params.get("activation", ActiMode.AC_MODE_NONE))
        if self.tp_degree > 1 and self.gather_out:
            y = gather_last(y, ctx.mesh.group("model"),
                            ctx.mesh.index("model"), self.tp_degree)
        return [y]

    def _row_parallel(self, ctx, x):
        """This rank's input features times its kernel rows, summed over
        `model` in f32, cast, then the bias and the activation."""
        group = ctx.mesh.group("model")
        rows = self._parameters["kernel"].shape[0]
        if x.shape[-1] != rows:  # replicated: take this rank's features
            x = enter_tp(x, group).narrow(
                -1, ctx.mesh.index("model") * rows, rows)
        cdt = matmul_dtype(ctx.config, x.dtype)
        odt = emit_dtype(ctx.config, self.outputs[0].dtype)
        y = torch.matmul(x.to(cdt), self.w("kernel", cdt)).float()
        y = reduce_sum(y, group).to(odt)
        if self.has_weight("bias"):
            y = y + self.w("bias", odt)
        return apply_activation(
            y, self.params.get("activation", ActiMode.AC_MODE_NONE))

    def flops(self) -> float:
        x = self.inputs[0]
        return 2.0 * int(np.prod(x.dims[:-1])) * x.dims[-1] \
            * self.params["out_dim"]
