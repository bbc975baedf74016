"""Linear / Dense (counterpart of flexflow_tpu/ops/linear.py).

Weight layout (in_dim, out_dim), as in the JAX package. The product is a
plain `torch.matmul` (cuBLAS on the card), which is what the JAX package
leaves to XLA."""
from __future__ import annotations

from typing import List

import torch

from ..core.op import Op, WeightSpec, register_op
from ..ffconst import ActiMode, OpType
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
        cdt = matmul_dtype(ctx.config, x.dtype)
        # the product accumulates in f32 and is rounded once to the
        # boundary dtype; bias and activation then run in that dtype
        odt = emit_dtype(ctx.config, self.outputs[0].dtype)
        y = torch.matmul(x.to(cdt), self.w("kernel", cdt)).to(odt)
        if self.has_weight("bias"):
            y = y + self.w("bias", odt)
        return [apply_activation(
            y, self.params.get("activation", ActiMode.AC_MODE_NONE))]
