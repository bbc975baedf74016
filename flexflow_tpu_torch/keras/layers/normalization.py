"""Normalization layers.

reference parity: python/flexflow/keras/layers/normalization.py:23
(BatchNormalization); LayerNormalization is a capability extension matching
the core layer_norm op.
"""
from __future__ import annotations

from .base_layer import Layer


class BatchNormalization(Layer):
    def __init__(self, relu: bool = False, **kwargs):
        # keras semantics: plain BN; reference's batch_norm fuses an optional
        # relu (model.h:412) so we expose the same knob
        super().__init__(**kwargs)
        self.relu = relu

    def compute_output_shape(self, input_shapes):
        return input_shapes[0]

    def _build(self, ffmodel, ff_inputs):
        self._nparams = 2 * ff_inputs[0].dims[1]
        return ffmodel.batch_norm(ff_inputs[0], relu=self.relu, name=self.name)


class LayerNormalization(Layer):
    def __init__(self, axis=-1, epsilon: float = 1e-5, center: bool = True,
                 scale: bool = True, **kwargs):
        super().__init__(**kwargs)
        self.axis = axis if isinstance(axis, (list, tuple)) else [axis]
        self.epsilon = epsilon
        self.affine = center or scale

    def compute_output_shape(self, input_shapes):
        return input_shapes[0]

    def _build(self, ffmodel, ff_inputs):
        return ffmodel.layer_norm(
            ff_inputs[0], list(self.axis), self.affine, self.epsilon,
            name=self.name,
        )
