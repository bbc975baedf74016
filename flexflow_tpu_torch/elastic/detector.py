"""Failure detection around the train step's dispatch (the port's copy of
flexflow_tpu/elastic/detector.py).

The detector produces the wrapper FFModel applies to the step the
elastic coordinator dispatches (config.elastic_step_wrapper, FFModel
`_elastic_step`). Each dispatch:

 1. fires any scheduled faults (FaultInjector.check, before the step,
    so the weights are untouched when a retry re-dispatches);
 2. runs the step under the retry policy: transient errors back off
    and re-dispatch in place, topology loss is recorded and escalated to
    the coordinator, unknown errors propagate;
 3. feeds the dispatch wall time into an EWMA — a step slower than
    `slow_factor` times the moving average is flagged as a slow-link/
    degraded-step event (detection only; recovery policy for slowness is
    the operator's call, unlike topology loss which the coordinator acts
    on).
"""
from __future__ import annotations

import random
import time
from typing import Callable, Optional

from .events import DETECT_SLOW, DETECT_TOPOLOGY, EventLog
from .faults import (CLASS_TOPOLOGY, FaultInjector, TopologyLoss,
                     classify_error)
from .retry import RetryPolicy, call_with_retry


class FailureDetector:
    """Classifying, latency-watching wrapper around step dispatch.

    `current_step` is maintained by the training loop (the coordinator sets
    it before each optimizer step) so events carry step numbers even though
    the step fn knows nothing about steps.
    """

    def __init__(self, events: Optional[EventLog] = None,
                 injector: Optional[FaultInjector] = None,
                 retry_policy: Optional[RetryPolicy] = None,
                 slow_factor: float = 3.0, ewma_alpha: float = 0.3,
                 warmup_steps: int = 2, clock=time.perf_counter,
                 rng: Optional[random.Random] = None):
        self.events = events if events is not None else EventLog()
        self.injector = injector
        self.retry_policy = retry_policy or RetryPolicy()
        # seeded by the coordinator (config.seed) so retry jitter — and
        # with it drill timelines — is deterministic per run
        self.rng = rng
        self.slow_factor = slow_factor
        self.ewma_alpha = ewma_alpha
        self.warmup_steps = warmup_steps  # first dispatches build caches
        self.current_step = 0
        self._clock = clock
        self._ewma_s: Optional[float] = None
        self._observed = 0

    # -- the Executor hook -------------------------------------------------
    def wrap(self, fn: Callable) -> Callable:
        """config.elastic_step_wrapper: step fn -> guarded fn."""

        def dispatched(*args, **kwargs):
            return self.dispatch(lambda: fn(*args, **kwargs))

        return dispatched

    def dispatch(self, thunk: Callable):
        step = self.current_step

        def attempt():
            # the timing window opens BEFORE fault injection so an injected
            # slow-link stall lands inside the measured dispatch time —
            # that is the whole point of the slow_link fault class
            t0 = self._clock()
            if self.injector is not None:
                self.injector.check(step)
            out = thunk()
            self._observe(self._clock() - t0, step)
            return out

        try:
            return call_with_retry(attempt, self.retry_policy,
                                   events=self.events, step=step,
                                   rng=self.rng)
        except Exception as exc:
            if classify_error(exc) == CLASS_TOPOLOGY:
                lost = getattr(exc, "lost_chips", ())
                self.events.record(DETECT_TOPOLOGY, step=step,
                                   chips=list(lost),
                                   error=f"{type(exc).__name__}: {exc}")
                if not isinstance(exc, TopologyLoss):
                    # normalize real runtime errors so the coordinator
                    # handles one exception type
                    raise TopologyLoss(lost, str(exc)) from exc
            raise

    # -- latency monitor ---------------------------------------------------
    def reset_latency(self) -> None:
        """Forget the EWMA and re-enter warmup. The coordinator calls this
        after a recovery rebuild: the new model's first dispatches include
        a fresh build (kernels, caches), which against the old mesh's EWMA
        would read as a spurious slow-link event (and then poison the
        average)."""
        self._ewma_s = None
        self._observed = 0

    def _observe(self, dt_s: float, step: int) -> None:
        self._observed += 1
        if self._observed <= self.warmup_steps:
            return  # compile-time outliers would poison the EWMA
        if self._ewma_s is None:
            self._ewma_s = dt_s
            return
        if dt_s > self.slow_factor * self._ewma_s and self._ewma_s > 0:
            self.events.record(
                DETECT_SLOW, step=step, dt_s=round(dt_s, 6),
                ewma_s=round(self._ewma_s, 6),
                factor=round(dt_s / self._ewma_s, 2))
        self._ewma_s = (1 - self.ewma_alpha) * self._ewma_s \
            + self.ewma_alpha * dt_s
