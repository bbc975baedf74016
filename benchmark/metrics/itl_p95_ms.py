"""The 95th percentile of the gaps between consecutive output tokens,
over every gap of every finished request of the window (the handles'
token times, host clock)."""
from benchmark.readers import p95_ms


def read(obs):
    gaps = [b - a for r in obs.requests if r.finished
            for a, b in zip(r.token_times, r.token_times[1:])]
    return p95_ms(gaps)
