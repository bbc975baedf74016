"""SingleDataLoader (counterpart of flexflow_tpu/runtime/dataloader.py).

The dataset stays in host numpy; `next_batch` returns the next batch of
the model's batch size, in order or, with `shuffle`, in a per-epoch
permutation. A loader attaches itself to its model, and `FFModel.fit()`
with no x and y pulls its batches from the attached loaders.

With `prefetch=True` (the default) and the native core available, a C++
producer thread (`native.BatchStream`, csrc/ffcore/dataloader.cc)
gathers each batch into a prefetch ring ahead of the training step;
its shuffled order is `std::mt19937_64` seeded by seed + epoch, the JAX
package's default order, so the same loaders feed both packages the same
batches. `prefetch=False`, or no native core, takes the numpy path, whose
order is `np.random.RandomState(seed + epoch)` (the JAX numpy backend's).
`backend` says which one runs.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


class SingleDataLoader:
    def __init__(self, ffmodel, input_tensor, full_array: np.ndarray,
                 num_samples: Optional[int] = None, data_type=None,
                 shuffle: bool = False, seed: int = 0,
                 prefetch: bool = True):
        self.model = ffmodel
        self.input_tensor = input_tensor
        self.data = np.ascontiguousarray(full_array)
        self.num_samples = num_samples or full_array.shape[0]
        self.batch_size = ffmodel.config.batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.next_index = 0
        self._stream = None
        if prefetch:
            from .. import native

            if native.available():
                try:
                    self._stream = native.BatchStream(
                        self.data[: self.num_samples], self.batch_size,
                        shuffle=shuffle, seed=seed)
                except ValueError:  # fewer samples than a batch: numpy
                    self._stream = None
        self._order = None
        self._epoch = 0
        ffmodel._attach_dataloader(self)

    @property
    def num_batches(self) -> int:
        return self.num_samples // self.batch_size

    @property
    def backend(self) -> str:
        return "native" if self._stream is not None else "numpy"

    def reset(self) -> None:
        self.next_index = 0
        self._epoch = 0
        self._order = None
        if self._stream is not None:
            self._stream.reset()

    def _numpy_next(self) -> np.ndarray:
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

    def next_batch(self, ffmodel=None) -> np.ndarray:
        if self._stream is not None:
            # copy out of the ring slot: the loader hands out a stable
            # array (callers may keep batches across calls); the prefetch
            # win is the background GATHER, which still overlaps compute.
            # Zero-copy consumers can use native.BatchStream directly and
            # honor its valid-until-next-call rule
            return self._stream.next_batch().copy()
        return self._numpy_next()
