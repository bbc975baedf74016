"""Tokens of the optimizer steps completed in the window over the
window's length (host clock), in the bert-large.train-s128 cell.
Each training cell reports its own, so that each has its own bound."""
from benchmark.readers import train_tokens_per_s


def read(obs):
    return train_tokens_per_s(obs)
