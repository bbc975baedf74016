"""Bounded-exponential-backoff retry for transient step failures (a
host-only copy of flexflow_tpu/elastic/retry.py).

Only errors that classify as transient (elastic/faults.py::classify_error)
are retried; topology loss re-raises immediately (a retry against a smaller
mesh cannot succeed — that path belongs to the coordinator), and unknown
errors re-raise too (masking a real bug behind retries is worse than
failing). Retries and their delays are recorded in the event log.
"""
from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Optional

from .events import RETRY, EventLog
from .faults import CLASS_TRANSIENT, classify_error


class RetriesExhausted(RuntimeError):
    """A transient failure persisted past the retry budget; the last
    underlying error is the __cause__."""


@dataclasses.dataclass
class RetryPolicy:
    """max_retries attempts AFTER the first failure; delay before retry k
    (0-based) is min(base_delay_s * backoff**k, max_delay_s), plus up to
    jitter_frac of itself in uniform jitter (decorrelates replicas that
    fail together)."""

    max_retries: int = 3
    base_delay_s: float = 0.05
    backoff: float = 2.0
    max_delay_s: float = 5.0
    jitter_frac: float = 0.0

    def delay_s(self, attempt: int, rng: Optional[random.Random] = None
                ) -> float:
        d = min(self.base_delay_s * self.backoff ** attempt,
                self.max_delay_s)
        if self.jitter_frac > 0.0:
            r = rng.random() if rng is not None else random.random()
            d *= 1.0 + self.jitter_frac * r
        return d


def call_with_retry(fn: Callable, policy: RetryPolicy,
                    events: Optional[EventLog] = None, step: int = -1,
                    classify=classify_error, sleep=time.sleep,
                    rng: Optional[random.Random] = None):
    """Run fn(); retry in place on transient errors per `policy`. Anything
    non-transient propagates untouched on the first occurrence. `rng`
    (a seeded random.Random) makes the jitter — and with it a drill's
    whole retry timeline — reproducible; without one the policy falls back
    to the global random stream."""
    attempt = 0
    while True:
        try:
            return fn()
        except Exception as exc:
            if classify(exc) != CLASS_TRANSIENT:
                raise
            if attempt >= policy.max_retries:
                raise RetriesExhausted(
                    f"step {step}: transient failure persisted through "
                    f"{policy.max_retries} retries: {exc}") from exc
            delay = policy.delay_s(attempt, rng)
            if events is not None:
                events.record(RETRY, step=step, attempt=attempt + 1,
                              delay_s=delay, error=f"{type(exc).__name__}: "
                                                   f"{exc}")
            sleep(delay)
            attempt += 1
