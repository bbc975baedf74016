"""SingleDataLoader (counterpart of flexflow_tpu/runtime/dataloader.py), on
the JAX package's numpy path.

The dataset stays in host numpy; `next_batch` returns the next batch of
the model's batch size, in order or, with `shuffle`, in a per-epoch
permutation from `np.random.RandomState(seed + epoch)`: the JAX numpy
backend's order, so the same loaders feed both packages the same
batches. A loader attaches itself to its model, and `FFModel.fit()`
with no x and y pulls its batches from the attached loaders. The JAX
package's native prefetch ring (`native.BatchStream`, a C++ producer
thread) is not ported (ROADMAP A11): `backend` is always "numpy".
"""
from __future__ import annotations

from typing import Optional

import numpy as np


class SingleDataLoader:
    def __init__(self, ffmodel, input_tensor, full_array: np.ndarray,
                 num_samples: Optional[int] = None, data_type=None,
                 shuffle: bool = False, seed: int = 0):
        self.model = ffmodel
        self.input_tensor = input_tensor
        self.data = np.ascontiguousarray(full_array)
        self.num_samples = num_samples or full_array.shape[0]
        self.batch_size = ffmodel.config.batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.next_index = 0
        self._order = None
        self._epoch = 0
        ffmodel._attach_dataloader(self)

    @property
    def num_batches(self) -> int:
        return self.num_samples // self.batch_size

    @property
    def backend(self) -> str:
        return "numpy"

    def reset(self) -> None:
        self.next_index = 0
        self._epoch = 0
        self._order = None

    def next_batch(self, ffmodel=None) -> np.ndarray:
        lo = self.next_index
        hi = lo + self.batch_size
        if hi > self.num_samples:
            self.next_index = 0
            self._epoch += 1
            self._order = None
            lo, hi = 0, self.batch_size
        self.next_index = hi
        if not self.shuffle:
            return self.data[lo:hi]
        if self._order is None:
            rng = np.random.RandomState((self.seed + self._epoch) % (2**32))
            self._order = rng.permutation(self.num_samples)
        return self.data[self._order[lo:hi]]
