"""Keras-side symbolic tensor (counterpart of
flexflow_tpu/keras/models/tensor.py).

reference parity: python/flexflow/keras/models/tensor.py — a placeholder that
records which layer produced it and its (batch-inclusive) shape, resolved to
an FFModel Tensor when the model is compiled.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from ...ffconst import DataType

_STR_DTYPES = {
    "float32": DataType.DT_FLOAT,
    "float64": DataType.DT_DOUBLE,
    "float16": DataType.DT_HALF,
    "bfloat16": DataType.DT_BFLOAT16,
    "int32": DataType.DT_INT32,
    "int64": DataType.DT_INT64,
}


def to_ff_dtype(dtype) -> DataType:
    if isinstance(dtype, DataType):
        return dtype
    if dtype is None:
        return DataType.DT_FLOAT
    return _STR_DTYPES[str(dtype)]


class KerasTensor:
    """shape[0] is the batch dim (None until compile)."""

    _guid = 0

    def __init__(
        self,
        shape: Tuple[Optional[int], ...],
        dtype=None,
        layer=None,
        inputs: Optional[List["KerasTensor"]] = None,
        name: str = "",
    ):
        KerasTensor._guid += 1
        self.guid = KerasTensor._guid
        self.shape = tuple(shape)
        self.dtype = to_ff_dtype(dtype)
        self.layer = layer  # producing layer (None for inputs)
        self.inputs = list(inputs or [])  # tensors consumed by that layer
        self.name = name or f"tensor_{self.guid}"
        self.ff_tensor = None  # resolved at compile time
        # for multi-output layers: which of the layer's outputs this is
        self.output_index = 0

    @property
    def batch_shape(self):
        return self.shape

    def __repr__(self):
        return f"KerasTensor(name={self.name}, shape={self.shape})"
