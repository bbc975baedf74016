"""Loss functions (counterpart of flexflow_tpu/runtime/losses.py).

Each loss is a scalar f32 tensor of (pred, label); autograd seeds the
gradients as `jax.value_and_grad` does in the JAX package. Every loss
ends in `reduce_scalar`, the kernel tier's `reduction` family.
"""
from __future__ import annotations

import torch

from ..ffconst import LossType
from ..kernels.reduction import fused_reduce
from ..kernels.registry import KERNELS

# reduce_scalar's resolved choice per device (KernelRegistry.resolve):
# it only caches the process-wide registry's answer, and the registry's
# generation invalidates it
_CHOICES: dict = {}


def reduce_scalar(x, kind: str = "mean"):
    """f32 scalar mean or sum of a loss or metric term through the kernel
    tier's `reduction` family: the fused reduction (kernels/reduction.py,
    the kernel on the card) when the registry selects it, plain torch
    otherwise. With no config to hand it reads the registry's
    configure()d default, as the JAX package does."""
    if kind not in ("mean", "sum"):
        raise ValueError(f"unknown reduction {kind!r}")
    if KERNELS.resolve(_CHOICES, "reduction", device=x.device):
        return fused_reduce(x, kind)
    return torch.mean(x) if kind == "mean" else torch.sum(x)


def sparse_categorical_crossentropy(logits, labels):
    """labels: int class ids, shape logits.shape[:-1] or (..., 1).

    Takes log_softmax of `logits` as given. The flagship model ends in a
    softmax op, so what arrives here are already probabilities and the
    loss is log_softmax of them — exactly what the JAX package computes
    (its model.py feeds the final op's output to this loss)."""
    if labels.dim() == logits.dim():
        labels = labels[..., 0]
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels.long()[..., None])
    return -reduce_scalar(ll, "mean")


def categorical_crossentropy(probs_or_logits, labels,
                             from_logits: bool = False):
    x = probs_or_logits.float()
    if from_logits:
        logp = torch.log_softmax(x, dim=-1)
    else:
        logp = torch.log(torch.clamp(x, 1e-12, 1.0))
    return -reduce_scalar(torch.sum(labels.float() * logp, dim=-1), "mean")


def mean_squared_error(pred, target, reduce: str = "avg"):
    se = torch.square(pred.float() - target.float())
    per_sample = torch.sum(se.reshape(se.shape[0], -1), dim=-1)
    return reduce_scalar(per_sample, "mean" if reduce == "avg" else "sum")


def identity_loss(pred, target=None):
    return reduce_scalar(pred.float(), "mean")


def loss_fn_for(loss_type: LossType):
    if loss_type == LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY:
        return sparse_categorical_crossentropy
    if loss_type == LossType.LOSS_CATEGORICAL_CROSSENTROPY:
        return categorical_crossentropy
    if loss_type == LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE:
        return lambda p, t: mean_squared_error(p, t, "avg")
    if loss_type == LossType.LOSS_MEAN_SQUARED_ERROR_SUM_REDUCE:
        return lambda p, t: mean_squared_error(p, t, "sum")
    if loss_type == LossType.LOSS_IDENTITY:
        return identity_loss
    raise ValueError(f"unknown loss {loss_type}")


class Loss:
    """API-compat wrapper (counterpart of the JAX package's Loss)."""

    def __init__(self, loss_type: LossType):
        self.loss_type = loss_type
        self.fn = loss_fn_for(loss_type)
