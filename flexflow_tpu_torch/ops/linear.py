"""Linear / Dense (counterpart of flexflow_tpu/ops/linear.py).

Weight layout (in_dim, out_dim), as in the JAX package. The product is a
plain `torch.matmul` (cuBLAS on the card), which is what the JAX package
leaves to XLA.

Column-parallel on a mesh (`kernel` sharded on out_dim, `bias` on its
one dim, search/simulator.py TP_WEIGHT_SHARD_DIMS): each rank computes
its columns from the replicated input, then the output is all-gathered
(runtime/collectives.py)."""
from __future__ import annotations

from typing import List

import torch

from ..core.op import Op, WeightSpec, register_op
from ..ffconst import ActiMode, OpType
from ..runtime.collectives import enter_tp, gather_last
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

    def lower(self, ctx, inputs):
        x = inputs[0]
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
        if self.tp_degree > 1:
            y = gather_last(y, ctx.mesh.group("model"),
                            ctx.mesh.index("model"), self.tp_degree)
        return [y]
