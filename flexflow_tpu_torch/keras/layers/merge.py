"""Merge layers: Concatenate, Add, Subtract, Multiply, Maximum, Minimum.

reference parity: python/flexflow/keras/layers/merge.py:23-152.
"""
from __future__ import annotations

from .base_layer import Layer


class _Merge(Layer):
    def compute_output_shape(self, input_shapes):
        return input_shapes[0]

    def _binary_name(self):
        raise NotImplementedError

    def _build(self, ffmodel, ff_inputs):
        fn = getattr(ffmodel, self._binary_name())
        out = ff_inputs[0]
        for t in ff_inputs[1:]:
            out = fn(out, t, name=self.name)
        return out


class Concatenate(_Merge):
    def __init__(self, axis: int = 1, **kwargs):
        super().__init__(**kwargs)
        self.axis = axis

    def compute_output_shape(self, input_shapes):
        s = list(input_shapes[0])
        ax = self.axis % len(s)
        s[ax] = sum(shape[ax] for shape in input_shapes)
        return tuple(s)

    def _build(self, ffmodel, ff_inputs):
        return ffmodel.concat(ff_inputs, self.axis, name=self.name)


def concatenate(tensors, axis: int = 1):
    return Concatenate(axis=axis)(tensors)


class Add(_Merge):
    def _binary_name(self):
        return "add"


def add(tensors):
    return Add()(tensors)


class Subtract(_Merge):
    def _binary_name(self):
        return "subtract"


def subtract(tensors):
    return Subtract()(tensors)


class Multiply(_Merge):
    def _binary_name(self):
        return "multiply"


def multiply(tensors):
    return Multiply()(tensors)


class Maximum(_Merge):
    def _binary_name(self):
        return "max"


class Minimum(_Merge):
    def _binary_name(self):
        return "min"
