"""Sequential model.

reference parity: python/flexflow/keras/models/sequential.py.
"""
from __future__ import annotations

from .base_model import BaseModel


class Sequential(BaseModel):
    def __init__(self, layers=None, name: str = "sequential"):
        super().__init__(name=name)
        self._pending = []
        for layer in layers or []:
            self.add(layer)

    def add(self, layer) -> None:
        from ..layers.input_layer import Input, InputLayer

        if not self._pending and not self.inputs:
            shape = getattr(layer, "input_shape", None)
            if isinstance(layer, InputLayer):
                self.inputs = [layer.output]
                self.outputs = [layer.output]
                return
            if shape is None:
                raise ValueError(
                    "first layer needs input_shape= (or add an InputLayer)"
                )
            from ..layers.core import Embedding

            dtype = "int32" if isinstance(layer, Embedding) else None
            t = Input(shape=tuple(shape), dtype=dtype)
            self.inputs = [t]
            self.outputs = [t]
        self._pending.append(layer)
        self._layers.append(layer)
        self.outputs = [layer(self.outputs[0])]
