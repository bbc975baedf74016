"""Elementwise unary and binary ops and the cast (counterpart of
flexflow_tpu/ops/elementwise.py).

Plain torch calls: the JAX package leaves these to XLA, with no Pallas
kernel. Binary ops broadcast as numpy does; the output keeps the first
input's declared dtype, and the executor casts it to its boundary dtype.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.op import Op, register_op
from ..ffconst import OpType

_UNARY_FNS = {
    OpType.RELU: torch.relu,
    OpType.SIGMOID: torch.sigmoid,
    OpType.TANH: torch.tanh,
    # jax.nn.gelu defaults to the tanh approximation
    OpType.GELU: lambda x: F.gelu(x, approximate="tanh"),
    OpType.ELU: F.elu,
    OpType.RSQRT: torch.rsqrt,
    OpType.EXP: torch.exp,
    OpType.SIN: torch.sin,
    OpType.COS: torch.cos,
}

# x op the op's `scalar`, or x to the power of its `exponent`
_SCALAR_FNS = {
    OpType.POW: lambda x, p: torch.pow(x, p["exponent"]),
    OpType.SCALAR_MULTIPLY: lambda x, p: x * p["scalar"],
    OpType.SCALAR_ADD: lambda x, p: x + p["scalar"],
    OpType.SCALAR_SUB: lambda x, p: x - p["scalar"],
    OpType.SCALAR_TRUE_DIV: lambda x, p: x / p["scalar"],
}

_BINARY_FNS = {
    OpType.EW_ADD: torch.add,
    OpType.EW_SUB: torch.sub,
    OpType.EW_MUL: torch.mul,
    OpType.EW_DIV: torch.div,
    OpType.EW_MAX: torch.maximum,
    OpType.EW_MIN: torch.minimum,
}


class _Unary(Op):
    def output_shapes(self):
        return [self.inputs[0].dims], [self.inputs[0].dtype]

    def lower(self, ctx, inputs):
        if self.op_type in _SCALAR_FNS:
            return [_SCALAR_FNS[self.op_type](inputs[0], self.params)]
        return [_UNARY_FNS[self.op_type](inputs[0])]


class _Binary(Op):
    def output_shapes(self):
        a, b = self.inputs
        return [tuple(np.broadcast_shapes(a.dims, b.dims))], [a.dtype]

    def lower(self, ctx, inputs):
        return [_BINARY_FNS[self.op_type](inputs[0], inputs[1])]


for _t in (*_UNARY_FNS, *_SCALAR_FNS):
    register_op(type(f"Unary_{_t.value}", (_Unary,), {"op_type": _t}))
for _t in _BINARY_FNS:
    register_op(type(f"Binary_{_t.value}", (_Binary,), {"op_type": _t}))


@register_op
class CastOp(Op):
    op_type = OpType.CAST

    def output_shapes(self):
        return [self.inputs[0].dims], [self.params["dtype"]]

    def lower(self, ctx, inputs):
        return [inputs[0].to(self.params["dtype"].torch_dtype)]
