"""Metrics (counterpart of flexflow_tpu/runtime/metrics.py): the six
metric types, and `PerfMetrics`, the accumulator behind `FFModel.fit`'s
per-epoch history and `FFModel.eval`'s result."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import torch

from ..ffconst import LossType, MetricsType
from .losses import (categorical_crossentropy, reduce_scalar,
                     sparse_categorical_crossentropy)


@dataclasses.dataclass
class PerfMetrics:
    """Accumulated training metrics: a copy of the JAX package's
    `PerfMetrics` (flexflow_tpu/runtime/metrics.py), whose module imports
    jax. Each step adds its batch, round(accuracy * batch) correct samples
    and each metric times the batch; metrics no step reports stay 0."""

    train_all: int = 0
    train_correct: int = 0
    cce_loss: float = 0.0
    sparse_cce_loss: float = 0.0
    mse_loss: float = 0.0
    rmse_loss: float = 0.0
    mae_loss: float = 0.0
    loss_sum: float = 0.0

    def update(self, batch: int, vals: Dict[str, float]) -> None:
        self.train_all += batch
        if "accuracy" in vals:
            self.train_correct += int(round(vals["accuracy"] * batch))
        self.cce_loss += vals.get("cce", 0.0) * batch
        self.sparse_cce_loss += vals.get("sparse_cce", 0.0) * batch
        self.mse_loss += vals.get("mse", 0.0) * batch
        self.rmse_loss += vals.get("rmse", 0.0) * batch
        self.mae_loss += vals.get("mae", 0.0) * batch
        self.loss_sum += vals.get("loss", 0.0) * batch

    @property
    def accuracy(self) -> float:
        return self.train_correct / max(1, self.train_all)

    def summary(self) -> Dict[str, float]:
        n = max(1, self.train_all)
        return {
            "samples": self.train_all,
            "accuracy": self.accuracy,
            "loss": self.loss_sum / n,
            "cce": self.cce_loss / n,
            "sparse_cce": self.sparse_cce_loss / n,
            "mse": self.mse_loss / n,
            "rmse": self.rmse_loss / n,
            "mae": self.mae_loss / n,
        }


# the key each metric type reports under, as the JAX package names it
METRIC_KEYS = {
    MetricsType.METRICS_ACCURACY: "accuracy",
    MetricsType.METRICS_CATEGORICAL_CROSSENTROPY: "cce",
    MetricsType.METRICS_SPARSE_CATEGORICAL_CROSSENTROPY: "sparse_cce",
    MetricsType.METRICS_MEAN_SQUARED_ERROR: "mse",
    MetricsType.METRICS_ROOT_MEAN_SQUARED_ERROR: "rmse",
    MetricsType.METRICS_MEAN_ABSOLUTE_ERROR: "mae",
}


class Metrics:
    """Computes the selected metric set from (pred, label) on the device;
    each value is an f32 scalar tensor, every reduction through
    `reduce_scalar`, as in flexflow_tpu/runtime/metrics.py."""

    def __init__(self, loss_type: LossType, metrics: Sequence[MetricsType]):
        self.loss_type = loss_type
        self.metrics = list(metrics)

    def keys(self) -> List[str]:
        """The keys `compute` returns, in its order."""
        return list(dict.fromkeys(METRIC_KEYS[m] for m in self.metrics))

    def compute(self, pred, label) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        sparse = label
        if (label.dim() == pred.dim() and label.shape[-1] == 1
                and pred.shape[-1] != 1 and not label.is_floating_point()):
            sparse = label[..., 0]
        for m in self.metrics:
            key = METRIC_KEYS[m]
            if m == MetricsType.METRICS_ACCURACY:
                if sparse.is_floating_point() and sparse.dim() == pred.dim():
                    tgt = torch.argmax(sparse, dim=-1)
                else:
                    tgt = sparse
                # argmax takes the first of tied maxima, as jnp.argmax does
                out[key] = reduce_scalar(
                    (torch.argmax(pred, dim=-1) == tgt.long()).float())
            elif m == MetricsType.METRICS_SPARSE_CATEGORICAL_CROSSENTROPY:
                out[key] = sparse_categorical_crossentropy(pred, label)
            elif m == MetricsType.METRICS_CATEGORICAL_CROSSENTROPY:
                out[key] = categorical_crossentropy(pred, label)
            else:
                # f32 before the reduction, as the JAX package does: the
                # reduction's two impls must agree
                diff = pred - label.to(pred.dtype)
                term = torch.abs(diff) if key == "mae" else torch.square(diff)
                val = reduce_scalar(term.float())
                out[key] = torch.sqrt(val) if key == "rmse" else val
        return out
