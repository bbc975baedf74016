"""The device's idle share of the traced slice: 1 - the union of its
kernels' and copies' intervals over the slice's length (device trace),
in the bert-large.train-s128 cell.
Each training cell reports its own, which moves that cell's
train_tokens_per_s.s128."""
from benchmark.readers import idle_pct


def read(obs):
    return idle_pct(obs)
