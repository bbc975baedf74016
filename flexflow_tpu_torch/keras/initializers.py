"""Keras initializer wrappers.

reference parity: python/flexflow/keras/initializers.py.
"""
from __future__ import annotations

from ..runtime.initializers import (
    ConstantInitializer,
    GlorotUniformInitializer,
    NormInitializer,
    UniformInitializer,
    ZeroInitializer,
)


class Initializer:
    def to_ff(self):
        raise NotImplementedError


class DefaultInitializer(Initializer):
    def to_ff(self):
        return None


class Zeros(Initializer):
    def to_ff(self):
        return ZeroInitializer()


class GlorotUniform(Initializer):
    def __init__(self, seed: int = 0):
        self.seed = seed

    def to_ff(self):
        return GlorotUniformInitializer(seed=self.seed)


class RandomUniform(Initializer):
    def __init__(self, minval=-0.05, maxval=0.05, seed: int = 0):
        self.minval, self.maxval, self.seed = minval, maxval, seed

    def to_ff(self):
        return UniformInitializer(self.seed, self.minval, self.maxval)


class RandomNormal(Initializer):
    def __init__(self, mean=0.0, stddev=0.05, seed: int = 0):
        self.mean, self.stddev, self.seed = mean, stddev, seed

    def to_ff(self):
        return NormInitializer(self.seed, self.mean, self.stddev)


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def to_ff(self):
        return ConstantInitializer(self.value)


def to_ff_initializer(identifier):
    if identifier is None:
        return None
    if isinstance(identifier, Initializer):
        return identifier.to_ff()
    if isinstance(identifier, str):
        return {
            "zeros": ZeroInitializer(),
            "glorot_uniform": GlorotUniformInitializer(seed=0),
            "random_uniform": UniformInitializer(0, -0.05, 0.05),
            "random_normal": NormInitializer(0, 0.0, 0.05),
        }[identifier]
    return identifier  # already a core initializer
