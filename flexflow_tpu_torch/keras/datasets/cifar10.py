"""CIFAR-10 loader (NCHW, matching the reference keras frontend).

reference parity: python/flexflow/keras/datasets/cifar10.py.
"""
from __future__ import annotations

import numpy as np

from ._synthetic import find_cached, make_classification


def load_data(num_samples: int = 50000):
    cached = find_cached("cifar-10-batches-py.npz")
    if cached:
        with np.load(cached, allow_pickle=True) as f:
            return (
                (f["x_train"][:num_samples], f["y_train"][:num_samples]),
                (f["x_test"], f["y_test"]),
            )
    n_test = max(1, num_samples // 5)
    x_train, y_train = make_classification(num_samples, (3, 32, 32), 10, seed=3)
    x_test, y_test = make_classification(n_test, (3, 32, 32), 10, seed=4)
    # reference returns labels as (n, 1) for cifar
    return (x_train, y_train.reshape(-1, 1)), (x_test, y_test.reshape(-1, 1))
