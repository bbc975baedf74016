"""Loss name mapping.

reference parity: python/flexflow/keras/losses.py.
"""
from __future__ import annotations

from ..ffconst import LossType


class Loss:
    loss_type = None


class CategoricalCrossentropy(Loss):
    loss_type = LossType.LOSS_CATEGORICAL_CROSSENTROPY


class SparseCategoricalCrossentropy(Loss):
    loss_type = LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY


class MeanSquaredError(Loss):
    loss_type = LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE


_NAMES = {
    "categorical_crossentropy": LossType.LOSS_CATEGORICAL_CROSSENTROPY,
    "sparse_categorical_crossentropy": LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
    "mean_squared_error": LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE,
    "mse": LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE,
    "identity": LossType.LOSS_IDENTITY,
}


def get(identifier) -> LossType:
    if isinstance(identifier, LossType):
        return identifier
    if isinstance(identifier, Loss) or (
        isinstance(identifier, type) and issubclass(identifier, Loss)
    ):
        return identifier.loss_type
    return _NAMES[str(identifier)]
