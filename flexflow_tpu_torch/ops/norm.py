"""LayerNorm and Softmax ops (counterpart of flexflow_tpu/ops/norm.py).

Both normalize the trailing axis through the port's differentiable
kernel ops (kernels/norm.py `layernorm`, `softmax`): forward and backward
are the CUDA kernels for tensors on the card, their plain versions on the
CPU. Other axes come with the op-set slice (ROADMAP A6).
"""
from __future__ import annotations

from typing import List

from ..core.op import Op, WeightSpec, register_op
from ..ffconst import OpType
from ..kernels.norm import layernorm, softmax
from ..runtime.initializers import ConstantInitializer, ZeroInitializer


def _require_trailing(op: Op, axis: int) -> None:
    nd = len(op.inputs[0].dims)
    if axis not in (-1, nd - 1):
        raise NotImplementedError(
            f"{op.name}: only the trailing axis is normalized in this port "
            f"so far (got axis {axis} of rank {nd}); other axes come with "
            "the op-set slice (ROADMAP A6)")


@register_op
class LayerNormOp(Op):
    op_type = OpType.LAYERNORM

    def output_shapes(self):
        axes = tuple(self.params["axes"])
        if len(axes) != 1:
            raise NotImplementedError(
                f"layer_norm over axes {axes}: only the trailing axis is "
                "ported so far (ROADMAP A6)")
        _require_trailing(self, axes[0])
        return [self.inputs[0].dims], [self.inputs[0].dtype]

    def weight_specs(self) -> List[WeightSpec]:
        if not self.params.get("elementwise_affine", True):
            return []
        shape = (self.inputs[0].dims[-1],)
        return [
            WeightSpec("gamma", shape, self.inputs[0].dtype,
                       ConstantInitializer(1.0)),
            WeightSpec("beta", shape, self.inputs[0].dtype,
                       ZeroInitializer()),
        ]

    def lower(self, ctx, inputs):
        affine = self.has_weight("gamma")
        return [layernorm(inputs[0], self.w("gamma") if affine else None,
                          self.w("beta") if affine else None,
                          eps=self.params.get("eps", 1e-5))]


@register_op
class SoftmaxOp(Op):
    op_type = OpType.SOFTMAX

    def output_shapes(self):
        _require_trailing(self, self.params.get("axis", -1))
        return [self.inputs[0].dims], [self.inputs[0].dtype]

    def lower(self, ctx, inputs):
        return [softmax(inputs[0])]
