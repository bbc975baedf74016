"""reference parity: python/flexflow/keras/utils/np_utils.py."""
from __future__ import annotations

import numpy as np


def to_categorical(y, num_classes=None, dtype="float32"):
    y = np.asarray(y, dtype="int64").ravel()
    if num_classes is None:
        num_classes = int(y.max()) + 1
    out = np.zeros((y.shape[0], num_classes), dtype=dtype)
    out[np.arange(y.shape[0]), y] = 1
    return out
