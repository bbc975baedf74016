"""The 95th percentile of the time requests of the window waited in the
batcher's queue (each handle's queue_wait_s, set by the program's
admission controller when the scheduler took it)."""
from benchmark.readers import p95_ms


def read(obs):
    return p95_ms([r.queue_wait_s for r in obs.requests
                   if r.queue_wait_s is not None])
