"""Elementwise binary ops (counterpart of flexflow_tpu/ops/elementwise.py):
the add of the residual stream, the one the serving slice uses."""
from __future__ import annotations

import numpy as np
import torch

from ..core.op import Op, register_op
from ..ffconst import OpType


@register_op
class AddOp(Op):
    op_type = OpType.EW_ADD

    def output_shapes(self):
        a, b = self.inputs
        return [tuple(np.broadcast_shapes(a.dims, b.dims))], [a.dtype]

    def lower(self, ctx, inputs):
        return [torch.add(inputs[0], inputs[1])]
