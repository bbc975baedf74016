"""The decode iterations' share of the card's bf16 peak: their model
operations (every stepped request's token at its position) over the
summed length of the `serve.decode` spans (program spans)."""
from benchmark.readers import decode_flops, decode_spans, peak_share_pct


def read(obs):
    spans = decode_spans(obs)
    return peak_share_pct(decode_flops(obs),
                          sum(e["dur"] for e in spans) / 1e6)
