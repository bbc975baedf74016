"""The mean number of slots a decode iteration stepped in the window
(the `slots` of the program's `serve.decode` spans)."""
from benchmark.readers import decode_spans


def read(obs):
    spans = decode_spans(obs)
    if not spans:
        return None
    return sum(e["args"]["slots"] for e in spans) / len(spans)
