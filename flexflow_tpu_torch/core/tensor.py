"""Logical graph tensors (counterpart of flexflow_tpu/core/tensor.py).

A Tensor here is a node of the graph, not data: dims, dtype and the op
that produces it. ParallelDim and ParallelTensorShape describe how a
weight is sharded over a mesh (FFModel._assign_tp_weights sets them);
activations carry none: they are replicated over `model` and cut over
`data` at the batch (runtime/collectives.py, FFModel.fit).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

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


@dataclasses.dataclass
class ParallelDim:
    """One dimension of a parallel tensor (flexflow_tpu/core/tensor.py:31):
    its global size, the number of shards, and the mesh axis it is
    sharded over (None iff degree == 1)."""

    size: int
    degree: int = 1
    axis: Optional[str] = None

    def __post_init__(self):
        if self.degree > 1 and self.axis is None:
            raise ValueError("partitioned dim needs a mesh axis name")
        if self.size % self.degree != 0:
            raise ValueError(f"dim size {self.size} not divisible by degree "
                             f"{self.degree}")


@dataclasses.dataclass
class ParallelTensorShape:
    """The shape of a parallel tensor (flexflow_tpu/core/tensor.py:57),
    only what describes a weight's shard."""

    dims: List[ParallelDim]
    dtype: DataType

    def sharded_dims(self) -> List[int]:
        return [i for i, d in enumerate(self.dims) if d.degree > 1]

    def shard(self, value, coords: Dict[str, int]):
        """The piece of the full `value` that the mesh position `coords`
        (axis name -> index) holds."""
        for i in self.sharded_dims():
            d = self.dims[i]
            n = d.size // d.degree
            value = value.narrow(i, coords[d.axis] * n, n)
        return value
