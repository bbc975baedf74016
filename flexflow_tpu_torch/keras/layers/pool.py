"""Pooling layers (NCHW).

reference parity: python/flexflow/keras/layers/pool.py:24-117.
"""
from __future__ import annotations

from ...ffconst import PoolType
from .base_layer import Layer
from .convolutional import _pair, _padding


class Pooling2D(Layer):
    pool_type = PoolType.POOL_MAX

    def __init__(self, pool_size=(2, 2), strides=None, padding="valid", **kwargs):
        super().__init__(**kwargs)
        self.pool_size = _pair(pool_size)
        self.strides = _pair(strides) if strides is not None else self.pool_size
        self.padding = _padding(padding, self.pool_size, self.strides)

    def compute_output_shape(self, input_shapes):
        b, c, h, w = input_shapes[0]
        kh, kw = self.pool_size
        sh, sw = self.strides
        ph, pw = self.padding
        return (b, c, (h + 2 * ph - kh) // sh + 1, (w + 2 * pw - kw) // sw + 1)

    def _build(self, ffmodel, ff_inputs):
        return ffmodel.pool2d(
            ff_inputs[0], self.pool_size[0], self.pool_size[1],
            self.strides[0], self.strides[1],
            self.padding[0], self.padding[1],
            pool_type=self.pool_type, name=self.name,
        )


class MaxPooling2D(Pooling2D):
    pool_type = PoolType.POOL_MAX


class AveragePooling2D(Pooling2D):
    pool_type = PoolType.POOL_AVG
