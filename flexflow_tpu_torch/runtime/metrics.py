"""Metrics (counterpart of flexflow_tpu/runtime/metrics.py): accuracy, the
metric the flagship model compiles with (other metric types raise), and
`PerfMetrics`, the per-epoch accumulator behind `FFModel.fit`'s history."""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import torch

from ..ffconst import LossType, MetricsType
from .losses import reduce_scalar


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


class Metrics:
    """Computes the selected metric set from (pred, label) on the device."""

    def __init__(self, loss_type: LossType, metrics: Sequence[MetricsType]):
        self.loss_type = loss_type
        self.metrics = list(metrics)
        for m in self.metrics:
            if m != MetricsType.METRICS_ACCURACY:
                raise NotImplementedError(
                    f"{m}: only METRICS_ACCURACY is ported so far "
                    "(ROADMAP A2)")

    def compute(self, pred, label) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        if (label.dim() == pred.dim() and label.shape[-1] == 1
                and pred.shape[-1] != 1 and not label.is_floating_point()):
            label = label[..., 0]
        for m in self.metrics:
            if label.is_floating_point() and label.dim() == pred.dim():
                tgt = torch.argmax(label, dim=-1)
            else:
                tgt = label
            # argmax takes the first of tied maxima, as jnp.argmax does
            out["accuracy"] = reduce_scalar(
                (torch.argmax(pred, dim=-1) == tgt.long()).float())
        return out
