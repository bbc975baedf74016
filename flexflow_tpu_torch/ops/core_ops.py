"""Graph source and pass-through ops (counterpart of
flexflow_tpu/ops/core_ops.py): InputOp, ConstantOp, NoOp, IdentityOp."""
from __future__ import annotations

import numpy as np
import torch

from ..core.op import Op, WeightSpec, register_op
from ..ffconst import DataType, OpType


@register_op
class InputOp(Op):
    op_type = OpType.INPUT

    def output_shapes(self):
        return ([tuple(self.params["dims"])],
                [self.params.get("dtype", DataType.DT_FLOAT)])

    def lower(self, ctx, inputs):
        raise RuntimeError("InputOp is resolved by the executor, not lowered")


class _Value:
    """The initializer of a trainable constant: its own value."""

    def __init__(self, value: np.ndarray):
        self.value = value

    def __call__(self, generator, dims, dtype):
        return torch.from_numpy(np.array(self.value)).to(dtype)


@register_op
class ConstantOp(Op):
    """A fixed tensor value as a graph source (`FFModel.create_constant`).
    trainable=True makes it the weight "value", drawn as the value itself;
    otherwise it is a buffer on the model's device, outside autograd."""

    op_type = OpType.WEIGHT

    def output_shapes(self):
        v = self.params["value"]
        dtype = self.params.get("dtype") or DataType.from_numpy(v.dtype)
        return [tuple(v.shape)], [dtype]

    def weight_specs(self):
        if not self.params.get("trainable", False):
            return []
        v = self.params["value"]
        return [WeightSpec("value", tuple(v.shape), self.outputs[0].dtype,
                           _Value(v))]

    def init_weights(self, generator, device, trainable=False):
        super().init_weights(generator, device, trainable)
        if not self.specs:
            self.register_buffer("const", _Value(self.params["value"])(
                None, None, self.outputs[0].dtype.torch_dtype).to(device))

    def lower(self, ctx, inputs):
        if self.specs:
            return [self.w("value")]
        return [self.const]


@register_op
class NoOp(Op):
    op_type = OpType.NOOP

    def output_shapes(self):
        return [self.inputs[0].dims], [self.inputs[0].dtype]

    def lower(self, ctx, inputs):
        return [inputs[0]]


@register_op
class IdentityOp(NoOp):
    op_type = OpType.IDENTITY
