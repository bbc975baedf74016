"""Training watchdog: catch numeric blow-ups before they poison state
(a host-only copy of flexflow_tpu/elastic/watchdog.py).

A per-step health check with a two-stage response:

    ok       — finite loss within `spike_factor` x the EMA: commit.
    skip     — a bad step: the caller discards this step's update and
               moves past the batch.
    rollback — `max_consecutive_bad` bad steps in a row: skipping is not
               healing it, restore the last-good checkpoint and resume.

Every verdict lands in the elastic EventLog (`watchdog.bad_step`,
`watchdog.skip`, `watchdog.rollback`) and in process-wide counters the
serving /metrics endpoint exports as `ff_watchdog_*`.

`FFModel.fit(watchdog=...)` runs the checks on every committed loss (a
K-step dispatch's mean loss under `steps_per_execution=K`) but cannot
revert a step: the update is already in the weights, so a rollback
verdict raises the typed `NumericBlowup`. The elastic coordinator
(elastic/coordinator.py) computes each step into temporaries, so it
skips a bad step's update and rolls back to the newest verified
checkpoint.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

from ..obs.registry import REGISTRY
from .events import (WATCHDOG_BAD_STEP, WATCHDOG_ROLLBACK, WATCHDOG_SKIP,
                     EventLog)

# verdicts
OK = "ok"
SKIP = "skip"
ROLLBACK = "rollback"

# process-wide watchdog counters, exported on the serving /metrics endpoint
# as ff_watchdog_<kind>_total, backed by the obs metrics registry
_COUNTER_PREFIX = "ff_watchdog_"


def _bump(kind: str) -> None:
    REGISTRY.counter(f"{_COUNTER_PREFIX}{kind}_total",
                     f"Training watchdog events: {kind}").inc()


def watchdog_counters() -> Dict[str, int]:
    """Snapshot of the process-wide watchdog counters: bad_steps, skips,
    rollbacks."""
    return REGISTRY.counters_with_prefix(_COUNTER_PREFIX)


def reset_watchdog_counters() -> None:
    REGISTRY.reset_all(prefix=_COUNTER_PREFIX)


class NumericBlowup(RuntimeError):
    """Training hit a numeric blow-up (NaN/Inf loss or a sustained spike)
    in a loop that has no checkpoint to roll back to."""


@dataclasses.dataclass
class WatchdogPolicy:
    """Thresholds for the health check.

    spike_factor: a finite loss above spike_factor * EMA(loss) counts as a
        bad step (10x by default — generous enough for normal optimization
        noise, tight enough to catch divergence).
    ema_alpha: EMA smoothing for the loss baseline.
    warmup_steps: good steps observed before spike checks arm (the first
        losses of a fresh model are legitimately wild). NaN/Inf is ALWAYS
        bad, warmup or not.
    max_consecutive_bad: bad steps in a row before skip escalates to
        rollback."""

    spike_factor: float = 10.0
    ema_alpha: float = 0.3
    warmup_steps: int = 3
    max_consecutive_bad: int = 3

    def __post_init__(self):
        if self.spike_factor <= 1.0:
            raise ValueError(
                f"spike_factor={self.spike_factor}: must be > 1")
        if self.max_consecutive_bad < 1:
            raise ValueError(
                f"max_consecutive_bad={self.max_consecutive_bad}: "
                "must be >= 1")


class TrainingWatchdog:
    """Stateful per-step health check. One instance per training run; the
    coordinator resets the consecutive-bad counter after a rollback (the
    EMA baseline survives — it was built from good steps)."""

    def __init__(self, policy: Optional[WatchdogPolicy] = None,
                 events: Optional[EventLog] = None):
        self.policy = policy or WatchdogPolicy()
        self.events = events if events is not None else EventLog()
        self._ema: Optional[float] = None
        self._good_steps = 0
        self.consecutive_bad = 0

    def _classify(self, loss: float) -> Optional[str]:
        """None when healthy, else a short reason string."""
        if not math.isfinite(loss):
            return "non-finite loss"
        if (self._good_steps >= self.policy.warmup_steps
                and self._ema is not None and self._ema > 0
                and loss > self.policy.spike_factor * self._ema):
            return (f"loss spike {loss:.4g} > {self.policy.spike_factor}x "
                    f"EMA {self._ema:.4g}")
        return None

    def check(self, step: int, loss: float) -> str:
        """Observe one step's loss; returns OK / SKIP / ROLLBACK. The
        caller acts on the verdict (discard the update on SKIP, restore
        the last-good checkpoint on ROLLBACK)."""
        loss = float(loss)
        reason = self._classify(loss)
        if reason is None:
            self._good_steps += 1
            self.consecutive_bad = 0
            self._ema = (loss if self._ema is None
                         else (1 - self.policy.ema_alpha) * self._ema
                         + self.policy.ema_alpha * loss)
            return OK
        self.consecutive_bad += 1
        _bump("bad_steps")
        self.events.record(WATCHDOG_BAD_STEP, step=step, loss=loss,
                           reason=reason,
                           consecutive=self.consecutive_bad)
        if self.consecutive_bad >= self.policy.max_consecutive_bad:
            # a VERDICT only — the rollback event/counter is recorded by
            # note_rollback at the site that actually restores a
            # checkpoint, so a guard() abort never reports a recovery
            # that did not happen
            self.consecutive_bad = 0
            return ROLLBACK
        _bump("skips")
        self.events.record(WATCHDOG_SKIP, step=step, loss=loss,
                           reason=reason)
        return SKIP

    def note_rollback(self, restored_step: int) -> None:
        """Record that a rollback was actually PERFORMED (the last-good
        checkpoint at `restored_step` was restored). Called by the elastic
        coordinator after the restore succeeds."""
        _bump("rollbacks")
        self.events.record(WATCHDOG_ROLLBACK, step=restored_step)

    def guard(self, step: int, loss: float) -> None:
        """The no-rollback-available flavor (plain FFModel.fit): SKIP is
        tolerated (flagged in events/counters; the update is already in
        the weights), ROLLBACK raises NumericBlowup."""
        if self.check(step, loss) == ROLLBACK:
            raise NumericBlowup(
                f"step {step}: {self.policy.max_consecutive_bad} "
                "consecutive bad steps (non-finite or spiking loss) and no "
                "checkpoint to roll back to — train under an "
                "ElasticCoordinator with a checkpoint_dir for automatic "
                "rollback, or lower the learning rate")
