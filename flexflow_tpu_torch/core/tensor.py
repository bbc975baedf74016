"""Logical graph tensors (counterpart of flexflow_tpu/core/tensor.py).

A Tensor here is a node of the graph, not data: dims, dtype and the op
that produces it; a weight's handle (`Op.weights`) also carries its
`_weight_spec`. The value API of the JAX package (`set_tensor`,
`get_tensor`, `attach_numpy_array`) goes through the model for a weight:
`get_tensor` returns the whole weight as numpy (gathered over `model` on
a mesh), `set_tensor` writes it in place (`Op.set_weight`, which bumps
the version counters a captured graph watches). Any other tensor holds
a host value only. ParallelDim and ParallelTensorShape describe how a
weight is sharded over a mesh (FFModel._assign_tp_weights sets them);
activations carry none: they are replicated over `model` and cut over
`data` at the batch (runtime/collectives.py, FFModel.fit).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

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
        self.create_gradients = True
        # host-attached value (set_tensor / attach_numpy_array)
        self._host_value: Optional[np.ndarray] = None

    @property
    def num_dims(self) -> int:
        return len(self.dims)

    def num_elements(self) -> int:
        return math.prod(self.dims) if self.dims else 1

    # -- host I/O (JAX `core/tensor.py:150-180`) ----------------------------
    def set_tensor(self, model, value) -> bool:
        """Set the value: a weight's is written into `model` in place;
        any tensor keeps it as its host value too. The shape must be
        the tensor's dims."""
        value = np.asarray(value, dtype=self.dtype.host_np_dtype)
        if tuple(value.shape) != self.dims:
            raise ValueError(f"shape mismatch: {value.shape} vs {self.dims}")
        self._host_value = value
        if model is not None:
            model._set_tensor_value(self, value)
        return True

    def get_tensor(self, model) -> np.ndarray:
        """A weight's whole value from `model` (bf16 widened to f32), else
        the host value; raises when there is neither."""
        if model is not None:
            arr = model._get_tensor_value(self)
            if arr is not None:
                return arr
        if self._host_value is not None:
            return self._host_value
        raise RuntimeError(f"tensor {self.name} has no materialized value")

    def attach_numpy_array(self, value) -> None:
        self._host_value = np.ascontiguousarray(
            value, dtype=self.dtype.host_np_dtype)

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
    only what describes a weight's shard (the port has no replica
    dims)."""

    dims: List[ParallelDim]
    dtype: DataType

    @property
    def shape(self) -> Tuple[int, ...]:
        """The global (unsharded) shape."""
        return tuple(d.size for d in self.dims)

    def num_elements(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

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
