"""Input placeholder.

reference parity: python/flexflow/keras/layers/input_layer.py:22-60
(InputLayer, Input).
"""
from __future__ import annotations

from ..models.tensor import KerasTensor, to_ff_dtype
from .base_layer import Layer


class InputLayer(Layer):
    def __init__(self, shape=None, batch_size=None, dtype=None, **kwargs):
        super().__init__(**kwargs)
        self.shape = tuple(shape or ())
        self.batch_size = batch_size
        self.dtype = to_ff_dtype(dtype)
        self.output = KerasTensor(
            (batch_size,) + self.shape, dtype=self.dtype, layer=self,
            name=f"{self.name}_out",
        )

    def compute_output_shape(self, input_shapes):
        return (self.batch_size,) + self.shape

    def _build(self, ffmodel, ff_inputs):
        batch = ffmodel.config.batch_size if self.batch_size is None else self.batch_size
        return ffmodel.create_tensor([batch] + list(self.shape), self.dtype)


def Input(shape=None, batch_size=None, dtype=None, name=None) -> KerasTensor:
    return InputLayer(shape=shape, batch_size=batch_size, dtype=dtype, name=name).output
