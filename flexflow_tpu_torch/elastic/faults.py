"""Deterministic fault injection for the elastic runtime (the port's copy
of flexflow_tpu/elastic/faults.py).

A `FaultPlan` scripts failures against optimizer-step numbers; the
`FaultInjector` fires them at dispatch time, BEFORE the step runs: the
failures these model (a lost rank, a wedged link, a compile hiccup)
surface at dispatch too, and raising before the step leaves the
weights and the optimizer state untouched, so a retry can re-dispatch
the same arguments. Every rank of a mesh runs the same plan, so a fault
fires on every rank at the same step.

Five fault classes, mirroring what a runbook distinguishes:
- transient (compile hiccup, queue timeout): retryable in place ->
  `TransientFault`, handled by elastic/retry.py.
- slow link (a degraded link): no error at all, just latency, injected
  as a dispatch-time stall; elastic/detector.py's EWMA flags it.
- chip loss (a rank leaves the job): topology changed, retrying is
  useless -> `TopologyLoss`, escalated to the elastic coordinator for
  re-planning. A lost rank leaves `ElasticCoordinator.fit` at once.
- nan step (blown-up gradient): no error either, the step "succeeds"
  with a non-finite loss; consumed after the dispatch (`take_nan_step`)
  and caught by the training watchdog (elastic/watchdog.py).
- corrupt checkpoint (torn write): silent on-disk rot of the newest
  checkpoint file, torn by the rank that writes the checkpoints (the
  others record the event); discovered only when a restore verifies
  checksums (runtime/durability.py falls back to an older verified
  checkpoint).
- poison live state (silent in-memory rot): the survivors' live training
  state is corrupted without any error surfacing; discovered only when
  the zero-disk recovery path verifies the tree (resharding/executor.py
  verify_live_tree), which must then fall back to the checkpoint restore.

`classify_error` maps REAL runtime exceptions onto the same taxonomy by
the JAX package's two message-pattern lists, so the detector treats an
injected fault and a runtime error uniformly.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Iterable, List, Optional, Sequence, Tuple

import torch

from .events import (FAULT_CHIP_LOSS, FAULT_CORRUPT_CKPT, FAULT_NAN_STEP,
                     FAULT_POISON_LIVE, FAULT_SLOW_LINK, FAULT_TRANSIENT,
                     EventLog)

# fault kinds (FaultPlan entries)
TRANSIENT = "transient"
SLOW_LINK = "slow_link"
CHIP_LOSS = "chip_loss"
# durability faults: nan_step poisons the observed loss of an
# optimizer step (a blown-up gradient), exercising the training watchdog's
# skip/rollback path; corrupt_checkpoint truncates the newest on-disk
# checkpoint (a torn write), exercising the verified-fallback restore.
NAN_STEP = "nan_step"
CORRUPT_CKPT = "corrupt_checkpoint"
# live-resharding fault: silent corruption of survivor-resident
# training state — the poison lands in live device arrays (not on disk),
# so the zero-disk recovery path's verification must catch it and fall
# back to the checkpoint restore. Non-raising; applied via the injector's
# poison_hook (the ElasticCoordinator owns the state being poisoned).
POISON_LIVE = "poison_live_state"

# error classes (classify_error results)
CLASS_TRANSIENT = "transient"
CLASS_TOPOLOGY = "topology"
CLASS_UNKNOWN = "unknown"


class TransientFault(RuntimeError):
    """Retryable failure: the topology is intact, re-dispatch may succeed
    (the role of a compile hiccup or a DEADLINE_EXCEEDED)."""


class TopologyLoss(RuntimeError):
    """Non-retryable failure: devices left the mesh. Carries the lost chip
    ids so the coordinator can build the survivor spec."""

    def __init__(self, lost_chips: Sequence[int], message: str = ""):
        self.lost_chips: Tuple[int, ...] = tuple(sorted(set(lost_chips)))
        super().__init__(
            message or f"lost chips {list(self.lost_chips)}")


@dataclasses.dataclass
class Fault:
    """One scripted fault. `at_step` is the optimizer step it fires on;
    `times` is how many consecutive dispatch attempts it affects (a
    transient with times=2 fails the first dispatch AND the first retry,
    then clears)."""

    kind: str
    at_step: int
    chips: Tuple[int, ...] = ()
    stall_s: float = 0.0  # slow_link: injected dispatch-time stall
    times: int = 1

    def __post_init__(self):
        if self.kind not in (TRANSIENT, SLOW_LINK, CHIP_LOSS, NAN_STEP,
                             CORRUPT_CKPT, POISON_LIVE):
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.kind == CHIP_LOSS and not self.chips:
            raise ValueError("chip_loss fault needs a non-empty chips list")


class FaultPlan:
    """An ordered script of faults, consumed as steps dispatch. Spent
    faults (times exhausted) never refire — a chip_loss fires once and the
    recovered run continues on the survivors."""

    def __init__(self, faults: Iterable[Fault] = ()):
        self.faults: List[Fault] = list(faults)

    # -- builders ---------------------------------------------------------
    @classmethod
    def kill_chips(cls, at_step: int, chips: Sequence[int]) -> "FaultPlan":
        return cls([Fault(CHIP_LOSS, at_step, chips=tuple(chips))])

    def add_transient(self, at_step: int, times: int = 1) -> "FaultPlan":
        self.faults.append(Fault(TRANSIENT, at_step, times=times))
        return self

    def add_slow_link(self, at_step: int, stall_s: float,
                      times: int = 1) -> "FaultPlan":
        self.faults.append(Fault(SLOW_LINK, at_step, stall_s=stall_s,
                                 times=times))
        return self

    def add_chip_loss(self, at_step: int,
                      chips: Sequence[int]) -> "FaultPlan":
        self.faults.append(Fault(CHIP_LOSS, at_step, chips=tuple(chips)))
        return self

    def add_nan_step(self, at_step: int, times: int = 1) -> "FaultPlan":
        self.faults.append(Fault(NAN_STEP, at_step, times=times))
        return self

    def add_corrupt_checkpoint(self, at_step: int) -> "FaultPlan":
        self.faults.append(Fault(CORRUPT_CKPT, at_step))
        return self

    def add_poison_live(self, at_step: int) -> "FaultPlan":
        self.faults.append(Fault(POISON_LIVE, at_step))
        return self

    def take(self, step: int) -> List[Fault]:
        """The next armed fault for `step`, charged one firing, as a 0/1-
        element list. One at a time: a fault that raises must leave later
        same-step faults armed (uncharged) for the retry's re-dispatch,
        not silently consume them."""
        for f in self.faults:
            if f.at_step == step and f.times > 0:
                f.times -= 1
                return [f]
        return []

    def pending(self) -> List[Fault]:
        return [f for f in self.faults if f.times > 0]


class FaultInjector:
    """Fires the plan's faults into step dispatch. The detector calls
    `check(step)` right before invoking the step."""

    def __init__(self, plan: FaultPlan, events: Optional[EventLog] = None,
                 sleep=time.sleep):
        self.plan = plan
        self.events = events if events is not None else EventLog()
        self._sleep = sleep
        # set by the ElasticCoordinator so corrupt_checkpoint faults know
        # which directory's newest checkpoint to tear, and whether this
        # rank is the one that writes it (the others only record)
        self.checkpoint_dir: Optional[str] = None
        self.tears = lambda: True
        # set by the ElasticCoordinator: poison_live_state faults call
        # this to NaN-poison the live training state in place
        self.poison_hook = None

    def take_nan_step(self, step: int) -> bool:
        """Consume an armed nan_step fault for `step`, if any. Called by
        the training loop AFTER the dispatch (a blown-up gradient surfaces
        in the step's outputs, not at dispatch time like the other fault
        classes) — the loop poisons the observed loss so the watchdog sees
        exactly what a real NaN step produces."""
        for f in self.plan.faults:
            if f.kind == NAN_STEP and f.at_step == step and f.times > 0:
                f.times -= 1
                self.events.record(FAULT_NAN_STEP, step=step)
                return True
        return False

    def _corrupt_newest_checkpoint(self, step: int) -> None:
        """Truncate the newest ckpt_*.npz in checkpoint_dir to half its
        size — exactly the torn file a crash mid-write (pre-durability)
        would have left. Only the writing rank (`tears`) truncates; every
        rank records the event."""
        d = self.checkpoint_dir
        names = ([] if d is None else
                 sorted(n for n in os.listdir(d)
                        if n.startswith("ckpt_") and n.endswith(".npz")))
        if not names:
            self.events.record(FAULT_CORRUPT_CKPT, step=step, path=None)
            return
        path = os.path.join(d, names[-1])
        size = os.path.getsize(path)
        if self.tears():
            with open(path, "r+b") as f:
                f.truncate(size // 2)
        self.events.record(FAULT_CORRUPT_CKPT, step=step, path=path,
                           truncated_to=size // 2)

    def check(self, step: int) -> None:
        # each armed fault fires AT MOST ONCE per dispatch attempt (times
        # counts consecutive dispatches affected, so a slow_link with
        # times=3 stalls three dispatches, not one dispatch three times),
        # and a raising fault stops here — later same-step faults stay
        # armed (uncharged) for the retry's re-dispatch
        for f in list(self.plan.faults):
            if f.at_step != step or f.times <= 0:
                continue
            if f.kind == NAN_STEP:
                continue  # consumed post-dispatch via take_nan_step
            f.times -= 1
            if f.kind == CORRUPT_CKPT:
                # non-raising side effect: the dispatch proceeds, the rot
                # is only discovered when a restore verifies checksums
                self._corrupt_newest_checkpoint(step)
            elif f.kind == POISON_LIVE:
                # non-raising: silent live-state rot, discovered only when
                # a zero-disk recovery verifies the survivors' tree
                self.events.record(FAULT_POISON_LIVE, step=step)
                if self.poison_hook is not None:
                    self.poison_hook()
            elif f.kind == SLOW_LINK:
                self.events.record(FAULT_SLOW_LINK, step=step,
                                   stall_s=f.stall_s)
                self._sleep(f.stall_s)
            elif f.kind == TRANSIENT:
                self.events.record(FAULT_TRANSIENT, step=step)
                raise TransientFault(
                    f"injected transient failure at step {step}")
            elif f.kind == CHIP_LOSS:
                self.events.record(FAULT_CHIP_LOSS, step=step,
                                   chips=list(f.chips))
                raise TopologyLoss(
                    f.chips, f"injected loss of chips {list(f.chips)} at "
                             f"step {step}")


# substrings of real runtime errors worth classifying; checked against
# str(exc) lower-cased. Topology patterns win over transient ones. The
# first lines of each are the JAX package's (XLA's runtime vocabulary);
# the rest are what torch.distributed's backends raise for the same
# events:
# - a peer gone: gloo's "Connection closed by peer ... remote worker
#   crashing" (tcp/pair.cc), NCCL's "remote process exited";
# - NCCL's "communicator was aborted": ncclCommAbort runs when a rank's
#   watchdog has seen a peer fail or hang, and an aborted communicator
#   serves no further collective, so retrying the step on it cannot
#   succeed. Topology, like the dead peer it follows (and it wins over
#   the transient "aborted" below, which is XLA's ABORTED status);
# - NCCL's "Watchdog caught collective operation timeout": the watchdog
#   aborts the communicator after the timeout (and by default ends the
#   process), so this is topology for the same reason;
# - gloo's "Timed out waiting <n>ms for recv operation"
#   (tcp/unbound_buffer.cc): transient, like XLA's DEADLINE_EXCEEDED, so
#   the step is retried once in place. But gloo closes the timed-out pair,
#   and the retry on that group fails with "Application timeout caused
#   pair closure" (tcp/pair.cc), which is topology: the failure then
#   goes to the coordinator, as a lost peer does.
_TOPOLOGY_PATTERNS = (
    "data_loss", "device unhealthy", "chip reboot", "preempt",
    "slice has been terminated", "failed to connect", "connection reset",
    "device or resource busy", "halted",
    "connection closed by peer", "remote process exited",
    "communicator was aborted", "collective operation timeout",
    "timeout caused pair closure",
)
_TRANSIENT_PATTERNS = (
    "deadline_exceeded", "deadline exceeded", "unavailable", "aborted",
    "resource_exhausted", "resource exhausted", "compilation failure",
    "failed to compile", "too many requests", "cancelled",
    "timed out waiting",
)


def classify_error(exc: BaseException) -> str:
    """Map an exception to CLASS_TRANSIENT / CLASS_TOPOLOGY / CLASS_UNKNOWN.
    Injected faults classify by type, and so does a device out of memory
    (`torch.cuda.OutOfMemoryError`: transient, as XLA's
    RESOURCE_EXHAUSTED); other real errors by message pattern."""
    if isinstance(exc, TopologyLoss):
        return CLASS_TOPOLOGY
    if isinstance(exc, (TransientFault, torch.cuda.OutOfMemoryError)):
        return CLASS_TRANSIENT
    msg = str(exc).lower()
    for pat in _TOPOLOGY_PATTERNS:
        if pat in msg:
            return CLASS_TOPOLOGY
    for pat in _TRANSIENT_PATTERNS:
        if pat in msg:
            return CLASS_TRANSIENT
    return CLASS_UNKNOWN
