"""The window's share of the card's bf16 peak: the model operations of
every prompt token prefilled and every token decoded in the window
(program spans) over the window's length."""
from benchmark.readers import decode_flops, peak_share_pct, prefill_flops


def read(obs):
    if not obs.spans:
        return None
    return peak_share_pct(decode_flops(obs) + prefill_flops(obs),
                          obs.window_s)
