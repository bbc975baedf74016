"""Keras Layer base (counterpart of flexflow_tpu/keras/layers/base_layer.py).

reference parity: python/flexflow/keras/layers/base_layer.py:20 (Layer). A
layer is a symbolic node: __call__ records the dataflow on KerasTensors; the
model's compile() walks the graph and asks each layer to emit the port's
FFModel layer-API calls via _build().
"""
from __future__ import annotations

import re
from typing import Dict, List, Sequence

from ..models.tensor import KerasTensor


def _snake(name: str) -> str:
    s = re.sub(r"(?<!^)(?=[A-Z])", "_", name).lower()
    return s


class Layer:
    _class_counts: Dict[str, int] = {}

    def __init__(self, name: str = None, **kwargs):
        cls = _snake(type(self).__name__)
        self._auto_named = name is None
        if name is None:
            idx = Layer._class_counts.get(cls, 0)
            Layer._class_counts[cls] = idx + 1
            name = f"{cls}_{idx}" if idx else cls
        self.name = name
        self.input_shape = kwargs.pop("input_shape", None)
        self._built_ops = []  # FFModel ops created at build time
        self._nparams = 0

    # -- symbolic call --------------------------------------------------
    def __call__(self, inputs):
        ins = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
        for i, t in enumerate(ins):
            if not isinstance(t, KerasTensor):
                raise TypeError(f"{self.name}: input {i} is not a KerasTensor")
        out_shape = self.compute_output_shape([t.shape for t in ins])
        out = KerasTensor(
            out_shape, dtype=self.output_dtype(ins), layer=self, inputs=ins,
            name=f"{self.name}_out",
        )
        return out

    def output_dtype(self, inputs: Sequence[KerasTensor]):
        return inputs[0].dtype if inputs else None

    def compute_output_shape(self, input_shapes: List[tuple]) -> tuple:
        raise NotImplementedError

    # -- build: emit FFModel ops ---------------------------------------
    def _build(self, ffmodel, ff_inputs):
        """Return the FFModel output Tensor (or list of them)."""
        raise NotImplementedError

    def count_params(self) -> int:
        return self._nparams

    def __repr__(self):
        return f"<{type(self).__name__} {self.name}>"
