"""Metric name mapping.

reference parity: python/flexflow/keras/metrics.py.
"""
from __future__ import annotations

from ..ffconst import MetricsType

_NAMES = {
    "accuracy": MetricsType.METRICS_ACCURACY,
    "acc": MetricsType.METRICS_ACCURACY,
    "categorical_crossentropy": MetricsType.METRICS_CATEGORICAL_CROSSENTROPY,
    "sparse_categorical_crossentropy": MetricsType.METRICS_SPARSE_CATEGORICAL_CROSSENTROPY,
    "mean_squared_error": MetricsType.METRICS_MEAN_SQUARED_ERROR,
    "mse": MetricsType.METRICS_MEAN_SQUARED_ERROR,
    "root_mean_squared_error": MetricsType.METRICS_ROOT_MEAN_SQUARED_ERROR,
    "rmse": MetricsType.METRICS_ROOT_MEAN_SQUARED_ERROR,
    "mean_absolute_error": MetricsType.METRICS_MEAN_ABSOLUTE_ERROR,
    "mae": MetricsType.METRICS_MEAN_ABSOLUTE_ERROR,
}


class Accuracy:
    metrics_type = MetricsType.METRICS_ACCURACY


def get(identifier) -> MetricsType:
    if isinstance(identifier, MetricsType):
        return identifier
    if hasattr(identifier, "metrics_type"):
        return identifier.metrics_type
    return _NAMES[str(identifier)]
