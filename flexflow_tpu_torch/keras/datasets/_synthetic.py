"""Deterministic synthetic dataset generator.

reference parity: python/flexflow/keras/datasets/* download real data; this
environment has no network egress, so load_data() uses a locally cached copy
when present and otherwise generates deterministic *learnable* synthetic data:
each class has a fixed random template and samples are template + noise, so
accuracy-gated tests remain meaningful.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

_CACHE_DIRS = [
    os.path.expanduser("~/.keras/datasets"),
    os.path.join(os.path.dirname(__file__), "..", "..", "..", "data"),
]


def find_cached(filename: str) -> Optional[str]:
    for d in _CACHE_DIRS:
        p = os.path.join(d, filename)
        if os.path.exists(p):
            return p
    return None


def make_classification(
    n: int, shape: Tuple[int, ...], num_classes: int, seed: int = 7,
    noise: float = 0.35,
) -> Tuple[np.ndarray, np.ndarray]:
    """uint8 images in [0,255], labels int32 in [0,num_classes)."""
    rng = np.random.RandomState(seed)
    templates = rng.rand(num_classes, *shape).astype(np.float32)
    y = rng.randint(0, num_classes, size=n).astype(np.int32)
    x = (1.0 - noise) * templates[y] + noise * rng.rand(n, *shape).astype(np.float32)
    return (x * 255.0).astype(np.uint8), y
