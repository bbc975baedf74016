"""Attention backward's share of its roofline in the traced slice
(device trace), in the bert-large.train-s128 cell.
Each training cell reports its own, which moves that cell's
train_tokens_per_s.s128."""
from benchmark.readers import attn_bwd_roofline_pct


def read(obs):
    return attn_bwd_roofline_pct(obs)
