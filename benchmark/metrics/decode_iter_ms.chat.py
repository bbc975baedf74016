"""The mean length of the program's `serve.decode` spans in the window:
one decode iteration's dispatch, its graph replay and the read-back of
its tokens (program spans)."""
from benchmark.readers import decode_iter_ms


def read(obs):
    return decode_iter_ms(obs)
