"""MNIST loader. reference parity: python/flexflow/keras/datasets/mnist.py."""
from __future__ import annotations

import numpy as np

from ._synthetic import find_cached, make_classification


def load_data(path: str = "mnist.npz"):
    cached = find_cached(path)
    if cached:
        with np.load(cached, allow_pickle=True) as f:
            return (f["x_train"], f["y_train"]), (f["x_test"], f["y_test"])
    x_train, y_train = make_classification(6000, (28, 28), 10, seed=1)
    x_test, y_test = make_classification(1000, (28, 28), 10, seed=2)
    return (x_train, y_train), (x_test, y_test)
