"""Output tokens emitted inside the window over the window's length
(the handles' token times, host clock)."""


def read(obs):
    lo, hi = obs.window
    n = sum(1 for r in obs.requests for t in r.token_times if lo <= t < hi)
    return n / obs.window_s if n and obs.window_s > 0 else None
