"""LayerNorm, RMSNorm, Softmax and Dropout ops (counterpart of
flexflow_tpu/ops/norm.py).

Each is a kernel-tier family (kernels/registry.py): when the registry
selects the kernel tier, and the op normalizes the trailing axis only,
the lowering runs the port's differentiable kernel op (kernels/norm.py
`layernorm`, `rmsnorm`, `softmax`: the CUDA kernels on the card, their
plain versions on the CPU). Otherwise it runs the JAX op's reference
lowering, ported as written: f32 statistics over any `axes`, the affine
parameters broadcast over the normalized axes, the result stored in x's
dtype, and autograd for the backward.
"""
from __future__ import annotations

from typing import List

import torch

from ..core.op import Op, WeightSpec, register_op
from ..ffconst import CompMode, OpType
from ..kernels.norm import layernorm, rmsnorm, softmax
from ..kernels.registry import KERNELS
from ..runtime.collectives import CUT_DIMS
from ..runtime.initializers import ConstantInitializer, ZeroInitializer


def _trailing_axis_only(op: Op, axes) -> bool:
    """The kernels normalize the trailing axis with leading dims
    flattened; anything else stays on the reference lowering."""
    return tuple(axes) == (len(op.inputs[0].dims) - 1,)


def _affine_shape(x, axes):
    """The weights' (normalized dims) shape broadcast against x."""
    shape = [1] * x.dim()
    for a in axes:
        shape[a] = x.shape[a]
    return shape


class _NormOp(Op):
    """Shape and weights shared by LayerNorm and RMSNorm: gamma (and beta)
    over the normalized dims."""

    has_beta = True

    def output_shapes(self):
        return [self.inputs[0].dims], [self.inputs[0].dtype]

    def weight_specs(self) -> List[WeightSpec]:
        if not self.params.get("elementwise_affine", True):
            return []
        shape = tuple(self.inputs[0].dims[a] for a in self.params["axes"])
        specs = [WeightSpec("gamma", shape, self.inputs[0].dtype,
                            ConstantInitializer(1.0))]
        if self.has_beta:
            specs.append(WeightSpec("beta", shape, self.inputs[0].dtype,
                                    ZeroInitializer()))
        return specs

    def _fused(self, ctx, x, family: str) -> bool:
        return _trailing_axis_only(self, self.params["axes"]) and bool(
            KERNELS.resolve(self.kernel_memo, family, config=ctx.config,
                            device=x.device))


@register_op
class LayerNormOp(_NormOp):
    op_type = OpType.LAYERNORM

    def lower(self, ctx, inputs):
        x = inputs[0]
        axes = tuple(self.params["axes"])
        eps = self.params.get("eps", 1e-5)
        affine = self.has_weight("gamma")
        if self._fused(ctx, x, "layernorm"):
            return [layernorm(x, self.w("gamma") if affine else None,
                              self.w("beta") if affine else None, eps=eps)]
        # statistics in f32 even when activations flow bf16; the result
        # is stored back in the activation dtype
        xf = x.float()
        mean = xf.mean(dim=axes, keepdim=True)
        var = torch.square(xf - mean).mean(dim=axes, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + eps)
        if affine:
            shape = _affine_shape(x, axes)
            y = (y * self.w("gamma").float().reshape(shape)
                 + self.w("beta").float().reshape(shape))
        return [y.to(x.dtype)]


@register_op
class RMSNormOp(_NormOp):
    """Root-mean-square norm: no mean-centering, no beta, eps 1e-6."""

    op_type = OpType.RMSNORM
    has_beta = False

    def lower(self, ctx, inputs):
        x = inputs[0]
        axes = tuple(self.params["axes"])
        eps = self.params.get("eps", 1e-6)
        affine = self.has_weight("gamma")
        if self._fused(ctx, x, "rmsnorm"):
            return [rmsnorm(x, self.w("gamma") if affine else None, eps=eps)]
        xf = x.float()
        y = xf * torch.rsqrt(
            torch.square(xf).mean(dim=axes, keepdim=True) + eps)
        if affine:
            y = y * self.w("gamma").float().reshape(_affine_shape(x, axes))
        return [y.to(x.dtype)]


@register_op
class SoftmaxOp(Op):
    op_type = OpType.SOFTMAX

    def output_shapes(self):
        return [self.inputs[0].dims], [self.inputs[0].dtype]

    def lower(self, ctx, inputs):
        x = inputs[0]
        axis = self.params.get("axis", -1)
        if axis in (-1, x.dim() - 1) and KERNELS.resolve(
                self.kernel_memo, "softmax", config=ctx.config,
                device=x.device):
            return [softmax(x)]
        # f32 exp / sum even for bf16 activations
        return [torch.softmax(x.float(), dim=axis).to(x.dtype)]


def dropout_keep(x: torch.Tensor, rate: float, generator) -> torch.Tensor:
    """The keep mask of inverted dropout over x's shape: each element kept
    with probability 1 - rate (a uniform draw below 1 - rate, as
    `jax.random.bernoulli`), from `generator` on x's device."""
    u = torch.rand(x.shape, generator=generator, device=x.device)
    return u < 1.0 - rate


def global_keep(ctx, local_shape, rate: float, cuts, device
                ) -> torch.Tensor:
    """The keep mask of this rank's slice of a value of `local_shape`,
    cut along dim d over axis a for each (d, a) of `cuts`: drawn at the
    whole shape from the walk's generator (the same draw on every rank,
    and the one-device run's), then cut to this rank's slice."""
    mesh = ctx.mesh
    live = {d: a for d, a in cuts.items()
            if mesh is not None and mesh.size(a) > 1}
    shape = list(local_shape)
    for d, a in live.items():
        shape[d] *= mesh.size(a)
    keep = torch.rand(shape, generator=ctx.generator, device=device) \
        < 1.0 - rate
    for d, a in live.items():
        n = local_shape[d]
        keep = keep.narrow(d, mesh.index(a) * n, n)
    return keep


def apply_dropout(x: torch.Tensor, keep: torch.Tensor, rate: float):
    """where(keep, x / (1 - rate), 0) in x's dtype (JAX `DropoutOp`)."""
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


@register_op
class DropoutOp(Op):
    """Inverted dropout: the identity outside training and at rate 0;
    in training each element is kept with probability 1 - rate and scaled
    by 1 / (1 - rate), the mask drawn from the walk's generator
    (runtime/executor.py) at the value's whole shape and cut to this
    rank's slice on a mesh (`global_keep`)."""

    op_type = OpType.DROPOUT

    def output_shapes(self):
        return [self.inputs[0].dims], [self.inputs[0].dtype]

    def lower(self, ctx, inputs):
        x = inputs[0]
        rate = self.params.get("rate", 0.5)
        if ctx.mode != CompMode.COMP_MODE_TRAINING or rate <= 0.0:
            return [x]
        cuts = ctx.in_cuts[0] if ctx.in_cuts else ()
        keep = global_keep(ctx, x.shape, rate,
                           {CUT_DIMS[a]: a for a in cuts}, x.device)
        return [apply_dropout(x, keep, rate)]
