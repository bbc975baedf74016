"""Metrics (counterpart of flexflow_tpu/runtime/metrics.py): accuracy, the
metric the flagship model compiles with. Other metric types raise."""
from __future__ import annotations

from typing import Dict, Sequence

import torch

from ..ffconst import LossType, MetricsType
from .losses import reduce_scalar


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
