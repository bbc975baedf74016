"""The training step's share of the card's bf16 peak over the traced
slice (device trace's marker), in the bert-large.train-s512 cell.
Each training cell reports its own, which moves that cell's
train_tokens_per_s.s512."""
from benchmark.readers import train_mfu_pct


def read(obs):
    return train_mfu_pct(obs)
