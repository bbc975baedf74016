"""Loss functions (counterpart of flexflow_tpu/runtime/losses.py), the
sparse categorical cross-entropy the training slice runs.

Each loss is a scalar f32 tensor of (pred, label); autograd seeds the
gradients as `jax.value_and_grad` does in the JAX package.
"""
from __future__ import annotations

import torch

from ..ffconst import LossType


def reduce_scalar(x, kind: str = "mean"):
    """f32 scalar mean or sum: the plain reduction, the path the JAX
    package's registry takes unless `--kernel-impl` forces its Pallas
    reduction (ROADMAP B4)."""
    if kind == "mean":
        return torch.mean(x)
    if kind == "sum":
        return torch.sum(x)
    raise ValueError(f"unknown reduction {kind!r}")


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


def loss_fn_for(loss_type: LossType):
    if loss_type == LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY:
        return sparse_categorical_crossentropy
    raise NotImplementedError(
        f"{loss_type}: only the sparse categorical cross-entropy is ported "
        "so far (ROADMAP A2)")


class Loss:
    """API-compat wrapper (counterpart of the JAX package's Loss)."""

    def __init__(self, loss_type: LossType):
        self.loss_type = loss_type
        self.fn = loss_fn_for(loss_type)
