"""Chaos injection for the serving fleet: scripted replica faults.

The serving-side sibling of `elastic/faults.py` (training's FaultPlan /
FaultInjector): a seeded, deterministic schedule of replica faults that
serve-bench's `--chaos` leg drives against a live fleet, so the failover
path is exercised by CI instead of trusted. Four fault kinds:

 - ``crash``      — at generated-token N, the replica's scheduler raises
   `InjectedCrash` (a `ReplicaLost`): the loop dies exactly like a real
   scheduler bug (`_fail_all` fails its slots, the thread exits, the
   HealthMonitor's liveness probe sees a dead thread).
 - ``hang``       — at token N, the scheduler stalls `stall_s` seconds
   mid-loop: heartbeats stop while the thread stays alive, the
   monitor's heartbeat probe escalates SUSPECT → DEAD. The stall sleeps
   in slices and exits early once the batcher is aborted, so a
   condemned thread never outlives the test.
 - ``straggle``   — from token N, each of the next `iterations`
   scheduler iterations pays an extra `stall_s` (× k step latency):
   the busy-gap EWMA inflates and the monitor's relative straggler
   score flags the replica SUSPECT against the fleet median.
 - ``flaky_submit`` — the replica's next `submits` admissions raise
   `QueueFull`: the router's rejection fall-through re-routes to a
   sibling, which must remain invisible to callers.

Faults are injected through two seams only — the batcher's per-iteration
``fault_hook`` and a wrapper around ``Replica.submit`` — so nothing in
the serving path knows chaos exists. Every firing increments
``ff_fleet_fault_injected_total{kind}`` and records a FLEET_FAULT event.

`FleetFaultPlan.randomized(seed, ...)` derives the whole schedule from
one numpy Generator: the same seed yields an identical fault sequence
(kind, replica, trigger token, stall) — the determinism contract the
chaos tests pin.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from ...elastic import events as ev
from ...obs.registry import MetricsRegistry
from ..sched.admission import QueueFull
from .health import ReplicaLost

FAULT_KINDS = ("crash", "hang", "straggle", "flaky_submit")


class InjectedCrash(ReplicaLost):
    """A scripted crash-at-token-N fault killed the replica's
    scheduler. Subclasses ReplicaLost so the fleet's failover machinery
    treats it exactly like a real replica death."""


@dataclasses.dataclass(frozen=True)
class FleetFault:
    """One scripted fault. `at_token` triggers against the replica's
    lifetime generated-token count (`ContinuousBatcher.tokens_emitted`);
    `stall_s` is the hang duration / per-iteration straggle tax;
    `iterations` bounds a straggle; `submits` bounds a flaky_submit."""

    kind: str
    replica: str
    at_token: int = 0
    stall_s: float = 0.0
    iterations: int = 1
    submits: int = 1

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"fault kind {self.kind!r}: choose from {FAULT_KINDS}")

    def describe(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


class FleetFaultPlan:
    """An ordered, deterministic schedule of FleetFaults (builder API
    plus a seeded `randomized` constructor)."""

    def __init__(self, faults: Sequence[FleetFault] = ()):
        self.faults: List[FleetFault] = list(faults)

    # -- builders ----------------------------------------------------------
    def crash(self, replica: str, at_token: int = 0) -> "FleetFaultPlan":
        self.faults.append(FleetFault("crash", replica, at_token=at_token))
        return self

    def hang(self, replica: str, at_token: int = 0,
             stall_s: float = 1.0) -> "FleetFaultPlan":
        self.faults.append(FleetFault("hang", replica, at_token=at_token,
                                      stall_s=stall_s))
        return self

    def straggle(self, replica: str, at_token: int = 0,
                 stall_s: float = 0.05,
                 iterations: int = 50) -> "FleetFaultPlan":
        self.faults.append(FleetFault("straggle", replica,
                                      at_token=at_token, stall_s=stall_s,
                                      iterations=iterations))
        return self

    def flaky_submit(self, replica: str, submits: int = 3) -> "FleetFaultPlan":
        self.faults.append(FleetFault("flaky_submit", replica,
                                      submits=submits))
        return self

    @classmethod
    def randomized(cls, seed: int, replicas: Sequence[str],
                   n_faults: int = 3, kinds: Sequence[str] = FAULT_KINDS,
                   max_token: int = 40, max_stall_s: float = 0.5,
                   ) -> "FleetFaultPlan":
        """Seeded schedule: every choice comes from ONE
        np.random.default_rng(seed) stream, so the same (seed, replicas,
        knobs) yields an IDENTICAL fault sequence — serve-bench chaos
        runs are reproducible by seed."""
        for k in kinds:
            if k not in FAULT_KINDS:
                raise ValueError(
                    f"fault kind {k!r}: choose from {FAULT_KINDS}")
        rng = np.random.default_rng(int(seed))
        replicas = list(replicas)
        plan = cls()
        for _ in range(int(n_faults)):
            kind = kinds[int(rng.integers(len(kinds)))]
            rep = replicas[int(rng.integers(len(replicas)))]
            tok = int(rng.integers(max_token + 1))
            stall = round(float(rng.uniform(0.01, max_stall_s)), 4)
            if kind == "crash":
                plan.crash(rep, at_token=tok)
            elif kind == "hang":
                plan.hang(rep, at_token=tok, stall_s=stall)
            elif kind == "straggle":
                plan.straggle(rep, at_token=tok, stall_s=stall,
                              iterations=int(rng.integers(5, 30)))
            else:
                plan.flaky_submit(rep, submits=int(rng.integers(1, 5)))
        return plan

    def describe(self) -> List[Dict[str, object]]:
        """The schedule as plain dicts — what the determinism test
        compares across two same-seed plans, and what the bench report
        records."""
        return [f.describe() for f in self.faults]

    def for_replica(self, name: str) -> List[FleetFault]:
        return [f for f in self.faults if f.replica == name]


class ChaosEngine:
    """Arms a FleetFaultPlan against a live Router's replicas.

    `arm(router)` installs a per-iteration `fault_hook` on each targeted
    replica's batcher and wraps its `submit` for flaky_submit faults;
    `disarm()` restores both. Firing records land in `self.fired` (in
    firing order), `ff_fleet_fault_injected_total{kind}`, and the
    elastic EventLog.
    """

    def __init__(self, plan: FleetFaultPlan,
                 registry: Optional[MetricsRegistry] = None,
                 event_log: Optional[ev.EventLog] = None):
        self.plan = plan
        self.registry = MetricsRegistry() if registry is None else registry
        self.events = event_log
        self.fired: List[Dict[str, object]] = []
        self._lock = threading.Lock()
        self._count: Dict[int, int] = {}   # id(fault) -> times fired
        self._hooked: Dict[str, object] = {}    # name -> batcher
        self._wrapped: Dict[str, tuple] = {}    # name -> (replica, submit)
        self._c_faults = self.registry.counter(
            "ff_fleet_fault_injected_total",
            "Chaos faults injected into fleet replicas, by kind",
            labels=("kind",))

    # -- wiring ------------------------------------------------------------
    def arm(self, router) -> None:
        for name in router.replica_names():
            faults = self.plan.for_replica(name)
            if not faults:
                continue
            rep = router.replica(name)
            hook_faults = [f for f in faults if f.kind != "flaky_submit"]
            flaky = [f for f in faults if f.kind == "flaky_submit"]
            if hook_faults:
                rep.batcher.fault_hook = self._make_hook(name, hook_faults)
                self._hooked[name] = rep.batcher
            if flaky:
                self._wrap_submit(name, rep, flaky)

    def disarm(self) -> None:
        for batcher in self._hooked.values():
            batcher.fault_hook = None
        self._hooked.clear()
        for name, (rep, orig) in self._wrapped.items():
            rep.submit = orig
        self._wrapped.clear()

    # -- firing ------------------------------------------------------------
    def _record(self, fault: FleetFault, token: int) -> None:
        entry = {"kind": fault.kind, "replica": fault.replica,
                 "token": int(token), "at_token": fault.at_token,
                 "t": time.monotonic()}
        with self._lock:
            self.fired.append(entry)
        self._c_faults.inc(kind=fault.kind)
        if self.events is not None:
            details = dict(entry)
            details["fault"] = details.pop("kind")  # record()'s own kw
            self.events.record(ev.FLEET_FAULT, **details)

    def _times(self, fault: FleetFault) -> int:
        with self._lock:
            return self._count.get(id(fault), 0)

    def _bump(self, fault: FleetFault) -> int:
        with self._lock:
            n = self._count.get(id(fault), 0) + 1
            self._count[id(fault)] = n
            return n

    @staticmethod
    def _stall(batcher, seconds: float) -> None:
        """Sleep `seconds` on the scheduler thread in slices, bailing
        out once the batcher is aborted — a condemned (already failed
        over) replica's thread must not outlive its eviction by the
        full stall."""
        deadline = time.monotonic() + seconds
        while batcher._running and time.monotonic() < deadline:
            time.sleep(min(0.02, max(0.0, deadline - time.monotonic())))

    def _make_hook(self, name: str, faults: List[FleetFault]):
        def hook(batcher) -> None:
            tok = batcher.tokens_emitted
            for f in faults:
                if tok < f.at_token:
                    continue
                if f.kind == "crash":
                    if self._times(f) == 0:
                        self._bump(f)
                        self._record(f, tok)
                        raise InjectedCrash(
                            f"chaos: replica {name!r} crashed at token"
                            f" {tok} (scripted at >= {f.at_token})")
                elif f.kind == "hang":
                    if self._times(f) == 0:
                        self._bump(f)
                        self._record(f, tok)
                        self._stall(batcher, f.stall_s)
                elif f.kind == "straggle":
                    if self._times(f) < f.iterations:
                        if self._bump(f) == 1:
                            self._record(f, tok)
                        self._stall(batcher, f.stall_s)
        return hook

    def _wrap_submit(self, name: str, rep, faults: List[FleetFault]) -> None:
        orig = rep.submit
        budget = sum(f.submits for f in faults)
        fault = faults[0]

        def flaky(prompt_ids, max_new_tokens, eos_id=None, seed=0):
            if self._times(fault) < budget:
                self._bump(fault)
                self._record(fault, getattr(rep.batcher, "tokens_emitted",
                                            0))
                raise QueueFull(rep.queue_depth(),
                                rep.batcher.admission.max_queue)
            return orig(prompt_ids, max_new_tokens, eos_id=eos_id,
                        seed=seed)

        rep.submit = flaky
        self._wrapped[name] = (rep, orig)
