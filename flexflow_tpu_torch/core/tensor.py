"""Logical graph tensors (counterpart of flexflow_tpu/core/tensor.py).

A Tensor here is a node of the graph, not data: dims, dtype and the op
that produces it. Parallel shapes arrive with the search slice; the port
runs on one device.
"""
from __future__ import annotations

import itertools
from typing import Sequence, Tuple

from ..ffconst import DataType

_guid_counter = itertools.count(1000)


class Tensor:
    def __init__(self, dims: Sequence[int], dtype: DataType = DataType.DT_FLOAT,
                 name: str = "", owner_op=None, owner_idx: int = 0):
        self.guid: int = next(_guid_counter)
        self.dims: Tuple[int, ...] = tuple(int(d) for d in dims)
        self.dtype = dtype
        self.name = name or f"tensor_{self.guid}"
        self.owner_op = owner_op  # producing Op (None for graph inputs)
        self.owner_idx = owner_idx

    @property
    def num_dims(self) -> int:
        return len(self.dims)

    def __repr__(self):
        return f"Tensor({self.name}, dims={self.dims}, {self.dtype.value})"
