"""Graph input placeholder (counterpart of flexflow_tpu/ops/core_ops.py InputOp)."""
from __future__ import annotations

from ..core.op import Op, register_op
from ..ffconst import DataType, OpType


@register_op
class InputOp(Op):
    op_type = OpType.INPUT

    def output_shapes(self):
        return ([tuple(self.params["dims"])],
                [self.params.get("dtype", DataType.DT_FLOAT)])

    def lower(self, ctx, inputs):
        raise RuntimeError("InputOp is resolved by the executor, not lowered")
