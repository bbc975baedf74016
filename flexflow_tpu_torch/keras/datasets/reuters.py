"""Reuters newswire topics. reference parity:
python/flexflow/keras/datasets/reuters.py."""
from __future__ import annotations

import numpy as np

from ._synthetic import find_cached

NUM_CLASSES = 46


def load_data(path: str = "reuters.npz", num_words: int = 10000,
              maxlen: int = 200, test_split: float = 0.2, seed: int = 113):
    cached = find_cached(path)
    if cached:
        with np.load(cached, allow_pickle=True) as f:
            xs, ys = f["x"], f["y"]
    else:
        rng = np.random.RandomState(seed)
        n = 2000
        # class-correlated token distributions so models can learn
        centers = rng.randint(1, num_words, size=(NUM_CLASSES, 32))
        ys = rng.randint(0, NUM_CLASSES, size=n)
        xs = np.empty(n, dtype=object)
        for i in range(n):
            length = rng.randint(16, maxlen)
            base = centers[ys[i]]
            seq = base[rng.randint(0, len(base), size=length)]
            noise_mask = rng.rand(length) < 0.3
            seq = np.where(noise_mask, rng.randint(1, num_words, size=length), seq)
            xs[i] = seq.astype(np.int32).tolist()
    split = int(len(xs) * (1.0 - test_split))
    return (xs[:split], ys[:split]), (xs[split:], ys[split:])
