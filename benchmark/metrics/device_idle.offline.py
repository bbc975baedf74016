"""The device's idle share of the traced slice: 1 - the union of its
kernels' and copies' intervals over the slice's length (device trace)."""
from benchmark.readers import idle_pct


def read(obs):
    return idle_pct(obs)
