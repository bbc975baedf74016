"""Weight initializers (counterpart of flexflow_tpu/runtime/initializers.py).

Each one is a function of an explicit `torch.Generator`. The numbers are
not jax.random's: weights that must match the JAX package are carried
across with `params_from_jax` (model.py), not redrawn. The constructors
are JAX's, the seed first: it is stored and not read, as in JAX, where
the op's key decides the values (here the model's generator).
"""
from __future__ import annotations

import math

import torch


class Initializer:
    def __call__(self, generator: torch.Generator, shape, dtype):
        raise NotImplementedError


class GlorotUniformInitializer(Initializer):
    """Glorot/Xavier uniform; ops pass explicit fans for rank > 2 layouts
    (attention's (e, h, d)), the default covers rank-2 (in, out)."""

    def __init__(self, seed: int = 0, fan_in: int = 0, fan_out: int = 0):
        self.seed = seed
        self.fan_in = fan_in
        self.fan_out = fan_out

    def __call__(self, generator, shape, dtype):
        fan_in, fan_out = self.fan_in, self.fan_out
        if not (fan_in and fan_out):
            if len(shape) >= 2:
                fan_in, fan_out = math.prod(shape[:-1]), shape[-1]
            elif len(shape) == 1:
                fan_in = fan_out = shape[0]
            else:
                fan_in = fan_out = 1
        scale = math.sqrt(6.0 / max(1, fan_in + fan_out))
        u = torch.rand(tuple(shape), generator=generator, dtype=torch.float32)
        return ((2.0 * u - 1.0) * scale).to(dtype)


class UniformInitializer(Initializer):
    def __init__(self, seed: int = 0, min_val: float = -0.1,
                 max_val: float = 0.1):
        self.seed = seed
        self.min_val = min_val
        self.max_val = max_val

    def __call__(self, generator, shape, dtype):
        u = torch.rand(tuple(shape), generator=generator, dtype=torch.float32)
        return (self.min_val + (self.max_val - self.min_val) * u).to(dtype)


class NormInitializer(Initializer):
    def __init__(self, seed: int = 0, mean: float = 0.0,
                 stddev: float = 1.0):
        self.seed = seed
        self.mean = mean
        self.stddev = stddev

    def __call__(self, generator, shape, dtype):
        z = torch.randn(tuple(shape), generator=generator, dtype=torch.float32)
        return (self.mean + self.stddev * z).to(dtype)


class ZeroInitializer(Initializer):
    def __call__(self, generator, shape, dtype):
        return torch.zeros(tuple(shape), dtype=dtype)


class ConstantInitializer(Initializer):
    def __init__(self, value: float):
        self.value = value

    def __call__(self, generator, shape, dtype):
        return torch.full(tuple(shape), self.value, dtype=dtype)


DefaultInitializer = GlorotUniformInitializer
