"""The 95th percentile of time to first token over every request of the
window that finished, each timed from when it was due (host clock)."""
from benchmark.readers import p95_ms


def read(obs):
    return p95_ms([r.first - r.due for r in obs.requests if r.finished])
