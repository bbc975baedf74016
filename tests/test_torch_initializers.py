"""The weight initializers (flexflow_tpu_torch/runtime/initializers.py)
against the JAX package's (flexflow_tpu/runtime/initializers.py).

Each initializer is built with the same positional arguments in both
packages (JAX's signatures: the seed first, stored and not read) and
draws a weight of the same shape, the JAX one from a jax.random key, the
port's from a torch.Generator. The values differ; their bounds and
moments must agree: the same attributes, the same bound for the uniform
draws (the largest |w| within 1% of it), means and standard deviations
within 2% of the spread, exact values for the constant ones.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.runtime import initializers as jinit
from flexflow_tpu_torch.runtime import initializers as pinit

SHAPE = (512, 512)

# (class name, positional arguments, weight shape, the draw's kind and its
# parameters: ("uniform", lo, hi), ("normal", mean, std), ("exact", v))
CASES = {
    # fan_in 1024 with fan_out 0: both fans from the shape
    "glorot-seed-fan_in": ("GlorotUniformInitializer", (7, 1024),
                           (1024, 1024), ("glorot", 1024, 1024)),
    "glorot-default": ("GlorotUniformInitializer", (), SHAPE,
                       ("glorot", 512, 512)),
    "glorot-explicit-fans": ("GlorotUniformInitializer", (3, 20, 30), SHAPE,
                             ("glorot", 20, 30)),
    "uniform-keras": ("UniformInitializer", (0, -0.05, 0.05), SHAPE,
                      ("uniform", -0.05, 0.05)),
    "uniform-offset": ("UniformInitializer", (5, 0.5, 2.0), SHAPE,
                       ("uniform", 0.5, 2.0)),
    "uniform-default": ("UniformInitializer", (), SHAPE,
                        ("uniform", -0.1, 0.1)),
    "norm-keras": ("NormInitializer", (0, 0.0, 0.05), SHAPE,
                   ("normal", 0.0, 0.05)),
    "norm-shifted": ("NormInitializer", (1, 2.0, 0.5), SHAPE,
                     ("normal", 2.0, 0.5)),
    "constant": ("ConstantInitializer", (0.25,), SHAPE, ("exact", 0.25)),
    "zero": ("ZeroInitializer", (), SHAPE, ("exact", 0.0)),
}


def _check(w, kind):
    if kind[0] == "exact":
        assert np.all(w == kind[1])
        return
    if kind[0] == "glorot":
        b = math.sqrt(6.0 / (kind[1] + kind[2]))
        kind = ("uniform", -b, b)
    if kind[0] == "uniform":
        lo, hi = kind[1], kind[2]
        span = hi - lo
        assert w.min() >= lo and w.max() <= hi
        assert w.min() <= lo + 0.01 * span and w.max() >= hi - 0.01 * span
        mean, std = (lo + hi) / 2, span / math.sqrt(12.0)
    else:
        mean, std = kind[1], kind[2]
        span = std
    assert abs(w.mean() - mean) <= 0.02 * span
    assert abs(w.std() - std) <= 0.02 * std


@pytest.mark.parametrize("case", list(CASES))
def test_initializer_bounds_and_moments_match_jax(case):
    name, args, shape, kind = CASES[case]
    ji = getattr(jinit, name)(*args)
    pi = getattr(pinit, name)(*args)
    assert vars(pi) == vars(ji)
    wj = np.asarray(ji(jax.random.PRNGKey(0), shape, jnp.float32))
    wp = pi(torch.Generator().manual_seed(0), shape, torch.float32).numpy()
    assert wj.shape == wp.shape == shape and wp.dtype == np.float32
    _check(wj, kind)
    _check(wp, kind)


def test_keras_spellings_construct_in_both_packages():
    """The JAX Keras frontend's calls (keras/initializers.py) construct in
    the port with the same fields."""
    calls = [("GlorotUniformInitializer", (), {"seed": 3}),
             ("UniformInitializer", (0, -0.05, 0.05), {}),
             ("NormInitializer", (0, 0.0, 0.05), {}),
             ("NormInitializer", (), {"seed": 1})]
    for name, args, kw in calls:
        assert vars(getattr(pinit, name)(*args, **kw)) == \
            vars(getattr(jinit, name)(*args, **kw))
