"""Functional Model.

reference parity: python/flexflow/keras/models/model.py.
"""
from __future__ import annotations

from .base_model import BaseModel
from .tensor import KerasTensor


class Model(BaseModel):
    def __init__(self, inputs, outputs, name: str = "model"):
        super().__init__(name=name)
        self.inputs = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
        self.outputs = list(outputs) if isinstance(outputs, (list, tuple)) else [outputs]
        # collect layers (topological, deduped)
        seen = set()

        def walk(t: KerasTensor):
            for i in t.inputs:
                walk(i)
            if t.layer is not None and id(t.layer) not in seen:
                seen.add(id(t.layer))
                self._layers.append(t.layer)

        for t in self.outputs:
            walk(t)
