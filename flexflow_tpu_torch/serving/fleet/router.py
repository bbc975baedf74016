"""Router: prefix-affine request routing over N serving replicas.

The fleet's front door. A request is routed by the SAME addresses the
PrefixCache files prefix pages under — `prefix_route_key` (kvpool.py) is
a pure function of (tokens, page_size), so the router and every replica
agree on a prompt's key without exchanging state:

 1. AFFINE: probe each READY replica's prefix cache
    (`Replica.prefix_probe`); the deepest owner of the prompt's shared
    prefix wins — its TTFT is O(suffix), everyone else's is O(prompt).
 2. STICKY: no replica owns pages yet (e.g. the tenant's first burst is
    still prefilling), but the routing key was seen before — route to
    the replica the key was assigned to, so one tenant's flood warms ONE
    cache instead of spraying cold prefills across the fleet.
 3. LEAST-LOADED: cold key (or no full page) — lowest
    `Replica.load_score()` wins.

Admission is SLO-aware and fleet-wide: with `slo_ttft_s` set, a
candidate whose PREDICTED time-to-first-token
(`ContinuousBatcher.predicted_ttft_s`: queue backlog x measured prefill
rate + the chunk-interleave term) exceeds the budget is skipped, and
when EVERY ready replica predicts over budget the request is shed with
`SLOExceeded` — same typed-429 contract as the queue/pool rejections, so
server.py maps it with zero changes. Replica-level `QueueFull` /
`PoolSaturated` fall through to the next candidate and only propagate
when the whole fleet rejects.

Drain with connection handoff: `drain(name)` marks the replica DRAINING
(no new routes) and re-homes its QUEUED requests — submit the duplicate
to a sibling FIRST, then cancel the original; whichever copy already
reached a slot wins, so a request is never in zero places. The caller's
`FleetRequest` handle rebinds transparently (greedy/seeded decode is a
pure function of (prompt, seed), never of the replica that runs it, so a
handoff is token-invisible).

Failover (`fail_over(name)`) is the ABRUPT-death version of drain,
driven by the HealthMonitor's DEAD verdict: the replica is evicted, its
batcher aborted (every in-flight request FENCED — the emitted-token
snapshot frozen against a hung-then-resumed scheduler thread), and each
unfinished request is re-dispatched to a survivor by replaying
prompt ‖ already-emitted-tokens as a forced prefix. The replay is
token-EXACT, not merely token-plausible: greedy decode is argmax over
the same prefix, and sampled decode draws fold_in(PRNGKey(seed), pos)
keys at ABSOLUTE cache positions — the replayed request reaches any
position with the identical prefix and identical key, so its
continuation tokens equal the fault-free run's. Chunked prefill plus the
prefix-page band make the replay cheap (the prompt's shared pages are
usually resident on the survivor). Re-dispatch runs under a per-request
retry budget with exponential backoff and a deadline; exhaustion
surfaces a typed `ReplicaLost` to the caller instead of a hang.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ...elastic import events as ev
from ...obs.registry import MetricsRegistry
from ...obs.tracing import (current_context, get_tracer, root_context,
                            use_context)
from ..sched.admission import (AdmissionError, PoolSaturated, QueueFull,
                               SLOExceeded)
from ..sched.continuous import RequestCancelled
from ..sched.kvpool import prefix_route_chain
from .health import ReplicaLost
from .replica import Replica, ReplicaState

_HANDOFF_REBIND_TIMEOUT_S = 10.0


class FleetUnavailable(AdmissionError):
    """No READY replica to route to (all draining/stopped/failed)."""

    http_status = 503
    reason = "no_ready_replica"

    def __init__(self, detail: str = ""):
        super().__init__(
            "fleet has no ready replica" + (f": {detail}" if detail else ""))


class FleetRequest:
    """The caller's handle for one routed request: a GenRequest proxy
    that survives drain handoff AND failover. A drain handoff only ever
    happens while the inner request is still QUEUED (zero tokens
    emitted), so a plain rebind restarts the stream cleanly. A FAILOVER
    can land mid-decode: the tokens the dead incarnation already emitted
    become `_base` (the replayed prefix), the new inner produces only
    the continuation, and `stream()`/`result()` stitch the two so the
    caller sees one uninterrupted, token-exact sequence."""

    def __init__(self, prompt: np.ndarray, max_new_tokens: int, eos_id,
                 seed: int):
        self.prompt = prompt
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = eos_id
        self.seed = int(seed)
        self.t_submit = time.monotonic()
        self.route = ""          # routing decision label (affine/...)
        self.handoffs = 0
        self.failovers = 0
        # the request's TraceContext (obs/tracing.py), captured at
        # Router.submit — failover replays and drain handoffs run under
        # it, so every incarnation's spans share ONE trace_id
        self.trace_ctx = None
        self._cv = threading.Condition()
        self._inner = None
        self._replica: Optional[str] = None
        self._version = 0
        # failover state: tokens/timestamps from DEAD incarnations (the
        # replayed prefix), the first-token time captured at the fence
        # (TTFT stays honest across a rebind), the terminal error when
        # the retry budget is exhausted, and the finalized flag for
        # requests whose budget/EOS completed at fence time
        self._base: List[int] = []
        self._base_times: List[float] = []
        self._t_first: Optional[float] = None
        self._lost: Optional[BaseException] = None
        self._final = False

    # -- router side -------------------------------------------------------
    def _bind(self, replica_name: str, inner) -> None:
        with self._cv:
            if self._inner is not None:
                self.handoffs += 1
            self._inner = inner
            self._replica = replica_name
            self._version += 1
            self._cv.notify_all()

    def _rebind(self, replica_name: str, inner, base: List[int],
                base_times: List[float],
                t_first: Optional[float]) -> None:
        """Failover bind: `inner` is the survivor's replay request,
        `base` the full token prefix already emitted by dead
        incarnations (which the replay carried in its prompt)."""
        with self._cv:
            self.failovers += 1
            self._base = list(base)
            self._base_times = list(base_times)
            if self._t_first is None:
                self._t_first = t_first
            self._inner = inner
            self._replica = replica_name
            self._version += 1
            self._cv.notify_all()

    def _handoff_rebind(self, replica_name: str, inner, base: List[int],
                        base_times: List[float],
                        t_first: Optional[float]) -> None:
        """Disagg KV-handoff bind (fleet/disagg.py): `inner` is the
        decode replica's imported continuation, `base` the token(s) the
        prefill replica emitted before parking. Counts as a handoff,
        not a failover — nothing died; the stream stitches exactly like
        a failover rebind (base ‖ continuation)."""
        with self._cv:
            self.handoffs += 1
            self._base = list(base)
            self._base_times = list(base_times)
            if self._t_first is None:
                self._t_first = t_first
            self._inner = inner
            self._replica = replica_name
            self._version += 1
            self._cv.notify_all()

    def _finalize(self, base: List[int], base_times: List[float],
                  t_first: Optional[float]) -> None:
        """The fence snapshot already completed the request (budget hit
        or EOS emitted just before the crash): finish it locally, no
        replay needed."""
        with self._cv:
            self._base = list(base)
            self._base_times = list(base_times)
            if self._t_first is None:
                self._t_first = t_first
            self._final = True
            self._inner = None
            self._version += 1
            self._cv.notify_all()

    def _terminate(self, err: BaseException) -> None:
        """Failover gave up (retry budget/deadline exhausted, or no
        survivor): the request is lost and consumers get the typed
        error instead of hanging."""
        with self._cv:
            self._lost = err
            self._cv.notify_all()

    def _snapshot(self):
        with self._cv:
            return self._inner, self._version

    def _state(self):
        with self._cv:
            return (self._inner, self._version, list(self._base),
                    self._final, self._lost)

    def _await_rebind(self, version: int) -> bool:
        """Wait for a rebind/finalize after a cancel/loss error; False
        when none arrives (timeout or terminal loss) — the caller then
        raises a typed error instead of spinning."""
        with self._cv:
            self._cv.wait_for(lambda: self._version != version
                              or self._lost is not None,
                              timeout=_HANDOFF_REBIND_TIMEOUT_S)
            return self._version != version

    def _no_rebind_error(self, cause: BaseException) -> BaseException:
        with self._cv:
            if self._lost is not None:
                return self._lost
        if isinstance(cause, ReplicaLost):
            return cause
        return ReplicaLost(
            f"replica {self._replica!r} lost this request and no rebind"
            f" arrived within {_HANDOFF_REBIND_TIMEOUT_S}s")

    # -- consumer API (GenRequest contract) --------------------------------
    @property
    def trace_id(self) -> Optional[str]:
        return self.trace_ctx.trace_id if self.trace_ctx is not None \
            else None

    @property
    def replayed_tokens(self) -> int:
        """Tokens emitted by DEAD incarnations and carried into the
        failover replay prompt (0 = the request was still queued or
        prefilling when its replica died — it never decoded there)."""
        with self._cv:
            return len(self._base)

    @property
    def replica(self) -> Optional[str]:
        with self._cv:
            return self._replica

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            inner, version, base, final, lost = self._state()
            if final:
                return np.asarray(base, np.int32)
            if lost is not None:
                raise lost
            left = None if deadline is None \
                else max(0.0, deadline - time.monotonic())
            try:
                out = np.asarray(inner.result(timeout=left), np.int32)
                if base:
                    out = np.concatenate(
                        [np.asarray(base, np.int32), out])
                return out
            except (RequestCancelled, ReplicaLost) as e:
                # a drain handoff cancelled the queued inner, or its
                # replica died: wait for the rebind (or the finalize)
                # and retry on the new incarnation
                if not self._await_rebind(version):
                    raise self._no_rebind_error(e) from e

    def stream(self, timeout: Optional[float] = None):
        sent = 0  # tokens yielded so far, across all incarnations
        while True:
            inner, version, base, final, lost = self._state()
            # catch up on replayed-prefix tokens the dead incarnation
            # emitted but this consumer had not yet received (the
            # fence's FIFO guarantee: everything emitted precedes the
            # error in the old stream, so `sent` never exceeds the base)
            while sent < len(base):
                yield base[sent]
                sent += 1
            if final:
                return
            if lost is not None:
                raise lost
            try:
                for tok in inner.stream(timeout=timeout):
                    sent += 1
                    yield tok
                return
            except (RequestCancelled, ReplicaLost) as e:
                if not self._await_rebind(version):
                    raise self._no_rebind_error(e) from e
                # rebound: loop re-snapshots and resumes at `sent`

    def done(self) -> bool:
        inner, _, _, final, lost = self._state()
        if final or lost is not None:
            return True
        if inner is None:
            return False
        err = inner.error
        if isinstance(err, (RequestCancelled, ReplicaLost)):
            # fenced/cancelled but pending rebind — result() would
            # block for the new incarnation, so the request is NOT done
            return False
        return inner.done()

    @property
    def id(self):
        inner, _ = self._snapshot()
        return None if inner is None else inner.id

    @property
    def tokens(self) -> List[int]:
        inner, _, base, _, _ = self._state()
        if inner is None:
            return base
        return base + inner.tokens

    @property
    def error(self):
        inner, _, _, final, lost = self._state()
        if lost is not None:
            return lost
        if final or inner is None:
            return None
        err = inner.error
        if isinstance(err, (RequestCancelled, ReplicaLost)):
            return None  # pending rebind, not a terminal failure
        return err

    @property
    def token_times(self) -> List[float]:
        with self._cv:
            inner, times = self._inner, list(self._base_times)
        if inner is None:
            return times
        return times + inner.token_times

    @property
    def cache_hit(self) -> bool:
        inner, _ = self._snapshot()
        return False if inner is None else inner.cache_hit

    @property
    def prefix_tokens(self) -> int:
        inner, _ = self._snapshot()
        return 0 if inner is None else inner.prefix_tokens

    @property
    def queue_wait_s(self):
        inner, _ = self._snapshot()
        return None if inner is None else inner.queue_wait_s

    @property
    def t_done(self):
        inner, _ = self._snapshot()
        return None if inner is None else inner.t_done

    @property
    def t_first_token(self):
        with self._cv:
            if self._t_first is not None:
                return self._t_first
            inner = self._inner
        return None if inner is None else inner.t_first_token

    @property
    def ttft_s(self) -> Optional[float]:
        """Submit-to-first-token measured from the ROUTER's submit time:
        a handoff's re-queue wait stays inside the number, and a
        failover keeps the DEAD incarnation's first-token time (the
        caller saw that token — the blip lands in ITL, not TTFT)."""
        t = self.t_first_token
        if t is None:
            return None
        return t - self.t_submit


class Router:
    """N replicas behind one prefix-affine, SLO-admitted front door.

    policy: "affine" (the default three-stage route above),
    "least_loaded" (skip affinity — the cold-path order only), or
    "round_robin" (the serve-bench baseline the affine win is asserted
    against). All three share the same SLO shedding and rejection
    fall-through.
    """

    POLICIES = ("affine", "least_loaded", "round_robin")

    def __init__(self, policy: str = "affine",
                 slo_ttft_s: Optional[float] = None, route_depth: int = 1,
                 registry: Optional[MetricsRegistry] = None,
                 on_load_failure: Optional[Callable] = None,
                 max_affinity_keys: int = 65536,
                 degraded_slo_factor: float = 0.5,
                 event_log: Optional[ev.EventLog] = None):
        if policy not in self.POLICIES:
            raise ValueError(
                f"policy={policy!r}: choose from {self.POLICIES}")
        self.policy = policy
        self.slo_ttft_s = None if slo_ttft_s is None else float(slo_ttft_s)
        if int(route_depth) < 1:
            raise ValueError(f"route_depth={route_depth}: need >= 1")
        self.route_depth = int(route_depth)
        self.max_affinity_keys = max(1, int(max_affinity_keys))
        # graceful degradation (fail_over): while lost capacity is not
        # yet respawned, the SLO budget is MULTIPLIED by this (<1 =
        # tighter) — the shrunken fleet sheds excess demand at the door
        # instead of queueing everyone past their deadline
        if not 0.0 < float(degraded_slo_factor) <= 1.0:
            raise ValueError(
                f"degraded_slo_factor={degraded_slo_factor}: need (0, 1]")
        self.degraded_slo_factor = float(degraded_slo_factor)
        # disaggregated serving: the DisaggCoordinator (fleet/disagg.py)
        # installs its priced-transfer predictor here so the SLO gate
        # charges prefill-role candidates the KV-handoff leg the request
        # will pay before its decode stream starts (prompt_len -> s)
        self.predicted_handoff_s: Optional[Callable[[int], float]] = None
        # the owning DisaggCoordinator, when this router fronts a
        # disaggregated fleet (repository.py sets it): shutdown() stops
        # the handoff plane FIRST so queued handoffs resume locally
        # before the replicas they would resume on are stopped
        self.disagg = None
        self.registry = MetricsRegistry() if registry is None else registry
        self.events = event_log
        # called with (name, exception) when a replica factory fails —
        # server.py wires this to record_load_failure so fleet load
        # failures extend ff_model_load_failures_total and /healthz
        self.on_load_failure = on_load_failure
        self._lock = threading.RLock()
        self._replicas: Dict[str, Replica] = {}
        self._failed_loads: Dict[str, str] = {}
        # replicas declared DEAD and evicted, not yet respawned: the
        # autoscaler reads this to respawn from its factory, health()
        # reports degraded while it is non-empty. _lost_roles remembers
        # each casualty's serving role so role-scoped autoscalers (one
        # per pool in a disaggregated fleet) respawn only their own
        self._lost_replicas: Dict[str, str] = {}
        self._lost_roles: Dict[str, str] = {}
        # route key -> replica name, LRU-bounded at max_affinity_keys
        # (lifetime-unique tenants must not grow router memory without
        # bound); _homes mirrors it as a per-replica key count so the
        # least-loaded tie-break reads O(replicas), not O(keys)
        self._affinity: "OrderedDict[str, str]" = OrderedDict()
        self._homes: Dict[str, int] = {}
        self._outstanding: Dict[str, List[FleetRequest]] = {}
        self._rr = itertools.count()
        self._page_size: Optional[int] = None
        self._c_requests = self.registry.counter(
            "ff_fleet_requests_total", "Requests routed, by replica",
            labels=("replica",))
        self._c_routes = self.registry.counter(
            "ff_fleet_routes_total",
            "Routing decisions by kind (affine/sticky/least_loaded/"
            "round_robin)", labels=("decision",))
        self._c_shed = self.registry.counter(
            "ff_fleet_shed_total",
            "Requests shed at the fleet door, by typed reason",
            labels=("reason",))
        self._c_handoffs = self.registry.counter(
            "ff_fleet_handoffs_total",
            "Queued requests re-homed off a draining replica")
        self._c_failover_requests = self.registry.counter(
            "ff_fleet_failover_requests_total",
            "In-flight requests processed by fail_over, by outcome"
            " (replayed/finalized/finished/lost)", labels=("outcome",))
        self._c_failover_retries = self.registry.counter(
            "ff_fleet_failover_retries_total",
            "Failover re-dispatch attempts that hit an admission"
            " rejection and backed off")
        self._c_failovers = self.registry.counter(
            "ff_fleet_failover_total",
            "Replica failovers executed, by eviction reason",
            labels=("reason",))
        self._g_replicas = self.registry.gauge(
            "ff_fleet_replicas", "Replicas by lifecycle state",
            labels=("state",))
        self._sync_replica_gauge()

    # -- membership --------------------------------------------------------
    def add_replica(self, name: str, replica_or_factory) -> Optional[Replica]:
        """Add a READY replica. `replica_or_factory` is a built Replica
        or a zero-arg factory; a factory failure is recorded (the fleet
        keeps serving on what it has, `health()` turns degraded, and the
        on_load_failure hook feeds ff_model_load_failures_total) instead
        of raised. Returns the replica, or None when the load failed."""
        name = str(name)
        if callable(replica_or_factory) \
                and not isinstance(replica_or_factory, Replica):
            try:
                replica = replica_or_factory()
            except Exception as exc:
                with self._lock:
                    self._failed_loads[name] = \
                        f"{type(exc).__name__}: {exc}"
                if self.on_load_failure is not None:
                    self.on_load_failure(name, exc)
                self._sync_replica_gauge()
                return None
        else:
            replica = replica_or_factory
        ps = replica.batcher.pool.page_size
        with self._lock:
            if name in self._replicas:
                raise ValueError(f"replica {name!r} already registered")
            if self._page_size is None:
                self._page_size = ps
            elif ps != self._page_size:
                # routing keys are computed per page_size: a mismatched
                # replica would never match the fleet's keys
                raise ValueError(
                    f"replica {name!r} page_size={ps} != fleet page_size"
                    f"={self._page_size}; prefix-affine routing needs one"
                    " page geometry")
            self._replicas[name] = replica
            self._failed_loads.pop(name, None)
            self._outstanding.setdefault(name, [])
        self._c_requests.inc(0, replica=name)
        self._sync_replica_gauge()
        return replica

    def replica(self, name: str) -> Replica:
        with self._lock:
            return self._replicas[name]

    def replica_names(self) -> List[str]:
        with self._lock:
            return sorted(self._replicas)

    def replica_registries(self) -> Dict[str, MetricsRegistry]:
        """{replica name: its private MetricsRegistry} — what the fleet
        /metrics merges through obs.render_merged."""
        with self._lock:
            return {n: r.registry for n, r in self._replicas.items()}

    def _ready(self) -> List[Tuple[str, Replica]]:
        with self._lock:
            return [(n, r) for n, r in self._replicas.items()
                    if r.state is ReplicaState.READY]

    def _sync_replica_gauge(self) -> None:
        with self._lock:
            counts = {s.value: 0 for s in ReplicaState}
            for r in self._replicas.values():
                counts[r.state.value] += 1
            counts["failed_load"] = len(self._failed_loads)
            # DEAD replicas are evicted from _replicas immediately; the
            # gauge shows the ones whose capacity is still missing
            counts[ReplicaState.DEAD.value] += len(self._lost_replicas)
        for state, n in counts.items():
            self._g_replicas.set(n, state=state)

    # -- routing -----------------------------------------------------------
    def _assign_affinity(self, key: str, name: str) -> None:
        """Record `key`'s home (lock held): LRU move-to-end, evicting the
        coldest key past max_affinity_keys, with `_homes` kept in step."""
        old = self._affinity.pop(key, None)
        if old is not None:
            self._drop_home(old)
        self._affinity[key] = name
        self._homes[name] = self._homes.get(name, 0) + 1
        while len(self._affinity) > self.max_affinity_keys:
            _, evicted = self._affinity.popitem(last=False)
            self._drop_home(evicted)

    def _drop_home(self, name: str) -> None:
        n = self._homes.get(name, 0) - 1
        if n > 0:
            self._homes[name] = n
        else:
            self._homes.pop(name, None)

    def _route_order(self, prompt_len: int, key: str, chain: List[str],
                     ready: List[Tuple[str, Replica]]):
        """Candidate (name, replica, shared_tokens) list in routing
        order, plus the decision label for the FIRST candidate. The
        least-loaded order tie-breaks on how many affinity keys already
        call the replica home — cold tenants spread across the fleet
        instead of piling onto whichever replica sorts first. Affine
        probes reuse the routing `chain` (hashed once per request) so an
        N-replica probe never re-hashes the prompt N times."""
        with self._lock:
            homes = dict(self._homes)
        by_load = sorted(ready, key=lambda nr: (nr[1].load_score(),
                                                homes.get(nr[0], 0),
                                                nr[0]))
        if self.policy == "round_robin":
            i = next(self._rr) % len(ready)
            order = ready[i:] + ready[:i]
            return [(n, r, 0) for n, r in order], "round_robin"
        if self.policy == "affine":
            probes = [(n, r, r.prefix_probe_chain(chain, prompt_len))
                      for n, r in by_load]
            best = max((p for _, _, p in probes), default=0)
            if best > 0:
                # deepest owner first; ties already load-ordered
                probes.sort(key=lambda nrp: -nrp[2])
                return probes, "affine"
            if key:
                with self._lock:
                    sticky = self._affinity.get(key)
                    if sticky is not None:
                        self._affinity.move_to_end(key)  # key is active
                if sticky is not None:
                    for i, (n, r, _) in enumerate(probes):
                        if n == sticky:
                            return ([probes[i]] + probes[:i]
                                    + probes[i + 1:]), "sticky"
            return probes, "least_loaded"
        return [(n, r, 0) for n, r in by_load], "least_loaded"

    def submit(self, prompt_ids, max_new_tokens: int, eos_id=None,
               seed: int = 0) -> FleetRequest:
        """Route and admit one request. Raises a typed AdmissionError —
        SLOExceeded when every ready replica predicts TTFT over budget,
        FleetUnavailable when nothing is READY, or the last replica-level
        rejection when the whole fleet refuses."""
        prompt = np.asarray(prompt_ids, np.int32)
        if prompt.ndim == 2 and prompt.shape[0] == 1:
            prompt = prompt[0]
        if prompt.ndim != 1:
            raise ValueError(
                f"fleet routing takes ONE prompt per request — expected"
                f" shape (L,) or (1, L), got {prompt.shape}")
        ready = self._ready()
        if not ready:
            self._c_shed.inc(reason=FleetUnavailable.reason)
            raise FleetUnavailable(f"{len(self._replicas)} registered")
        # disaggregated serving: decode-role replicas receive work only
        # through the KV-handoff plane (fleet/disagg.py) — fresh traffic
        # routes to prefill/unified replicas. They stay a last resort:
        # if every non-decode replica is gone, a decode-role batcher
        # still serves both phases end to end (zero-drop beats purity).
        front = [(n, r) for n, r in ready if r.role != "decode"]
        if front:
            ready = front
        chain = prefix_route_chain(prompt, self._page_size) \
            if self._page_size else []
        key = chain[min(self.route_depth, len(chain)) - 1] if chain else ""
        order, decision = self._route_order(prompt.size, key, chain, ready)
        tracer = get_tracer()
        ctx = current_context()
        if tracer.enabled and ctx is None:
            # no caller context (the chaos bench and tests drive the
            # router directly): every request still gets its own trace
            # root, so failover continuity is checkable end to end
            ctx = root_context()
        with use_context(ctx), \
                tracer.span("fleet.route", decision=decision,
                            candidates=len(order)):
            # SLO gate: drop candidates predicting over budget; if that
            # empties the list, shed with the fleet-wide minimum. While
            # failed-over capacity is missing the budget TIGHTENS by
            # degraded_slo_factor: the shrunken fleet sheds excess
            # demand at the door instead of queueing everyone past
            # their deadline (graceful degradation, docs/serving.md)
            slo = self.slo_ttft_s
            if slo is not None:
                with self._lock:
                    if self._lost_replicas:
                        slo *= self.degraded_slo_factor
                hand = self.predicted_handoff_s
                preds = [r.predicted_ttft_s(prompt.size, shared_tokens=sh)
                         + (hand(prompt.size)
                            if hand is not None and r.role == "prefill"
                            else 0.0)
                         for _, r, sh in order]
                kept = [c for c, p in zip(order, preds) if p <= slo]
                if not kept:
                    self._c_shed.inc(reason=SLOExceeded.reason)
                    raise SLOExceeded(min(preds), slo,
                                      scope=f"fleet of {len(order)}")
                order = kept
            last_err: Optional[AdmissionError] = None
            for name, rep, _ in order:
                try:
                    inner = rep.submit(prompt, max_new_tokens,
                                       eos_id=eos_id, seed=seed)
                except (QueueFull, PoolSaturated) as e:
                    last_err = e
                    continue
                fr = FleetRequest(prompt, max_new_tokens, eos_id, seed)
                fr.route = decision
                fr.trace_ctx = ctx
                fr._bind(name, inner)
                with self._lock:
                    if key:
                        self._assign_affinity(key, name)
                    pend = self._outstanding.setdefault(name, [])
                    pend[:] = [f for f in pend if not f.done()]
                    pend.append(fr)
                self._c_requests.inc(replica=name)
                self._c_routes.inc(decision=decision)
                return fr
            self._c_shed.inc(reason=last_err.reason)
            raise last_err

    def cancel(self, fr: FleetRequest) -> bool:
        """Best-effort cancel of a still-queued FleetRequest (the
        all-or-nothing fan-in path in server.py). False once it reached
        a slot or its replica is gone."""
        inner, _ = fr._snapshot()
        name = fr.replica
        with self._lock:
            rep = self._replicas.get(name)
        if rep is None or inner is None:
            return False
        return rep.cancel(inner)

    # -- disagg handoff (fleet/disagg.py) ----------------------------------
    def outstanding_for(self, name: str) -> List[FleetRequest]:
        """Live FleetRequests currently homed on `name` — how the
        DisaggCoordinator maps a parked GenRequest back to the caller's
        fleet handle (GenRequest ids are per-batcher, so the match is
        by inner identity, not id)."""
        with self._lock:
            return [f for f in self._outstanding.get(name, ())
                    if not f.done()]

    def rebind_handoff(self, fr: FleetRequest, to_name: str, inner,
                       base: List[int], base_times: List[float],
                       t_first: Optional[float]) -> None:
        """Move a FleetRequest onto its decode replica after a KV
        handoff: rebind the caller's handle to the imported continuation
        and re-home it in the outstanding map, so a later drain or
        failover of the DECODE replica finds it there. Must run BEFORE
        the prefill side releases the parked original (release_parked
        finishes the old inner — a consumer snapshotting in between
        would see a finished stream with no continuation bound)."""
        fr._handoff_rebind(to_name, inner, base, base_times, t_first)
        with self._lock:
            for pend in self._outstanding.values():
                pend[:] = [f for f in pend if f is not fr]
            self._outstanding.setdefault(to_name, []).append(fr)
        self._c_handoffs.inc()

    # -- drain / removal ---------------------------------------------------
    def drain(self, name: str) -> Dict[str, int]:
        """Mark a replica DRAINING and hand its QUEUED requests off to
        siblings. Zero-drop ordering: the duplicate is submitted to the
        new replica BEFORE the original is cancelled, and whichever copy
        already reached a slot wins — the request is never in zero
        places. Active (decoding) requests finish where they are."""
        with self._lock:
            rep = self._replicas.get(name)
            if rep is None:
                # already evicted (fail_over raced this drain): its
                # in-flight work was replayed elsewhere, nothing to
                # re-home
                return {"handed_off": 0, "kept": 0}
            rep.mark_draining()
            pending = [f for f in self._outstanding.get(name, ())
                       if not f.done()]
            # affinity entries pointing at the drained replica go stale:
            # drop them so sticky routing re-learns a live home
            self._affinity = OrderedDict(
                (k, v) for k, v in self._affinity.items() if v != name)
            self._homes.pop(name, None)
        self._sync_replica_gauge()
        handed = kept = 0
        tracer = get_tracer()
        for fr in pending:
            inner, _ = fr._snapshot()
            if fr.replica != name or inner.done():
                continue
            with use_context(fr.trace_ctx), \
                    tracer.span("fleet.handoff", replica=name):
                try:
                    new = self.submit(fr.prompt, fr.max_new_tokens,
                                      eos_id=fr.eos_id, seed=fr.seed)
                except AdmissionError:
                    kept += 1  # siblings full: it stays queued here and
                    continue   # the draining batcher still finishes it
                new_inner, _ = new._snapshot()
                if rep.cancel(inner):
                    # original was still queued: the duplicate takes
                    # over. Track the CALLER's handle on the new home —
                    # not the router-internal duplicate wrapper — so a
                    # later drain of THAT replica re-homes fr again
                    # instead of rebinding a wrapper nobody holds
                    fr._bind(new.replica, new_inner)
                    with self._lock:
                        pend = self._outstanding.setdefault(new.replica, [])
                        pend[:] = [f for f in pend if f is not new]
                        pend.append(fr)
                    self._c_handoffs.inc()
                    handed += 1
                else:
                    # original already reached a slot: discard the
                    # duplicate (best-effort; if it too was scheduled it
                    # decodes into the void, bounded by max_new_tokens)
                    self.replica(new.replica).cancel(new_inner)
                    with self._lock:
                        pend = self._outstanding.get(new.replica)
                        if pend is not None:
                            pend[:] = [f for f in pend if f is not new]
                    kept += 1
        return {"handed_off": handed, "kept": kept}

    def remove(self, name: str, timeout: Optional[float] = 60.0) -> None:
        """Drain (if not already), wait for the replica to empty, stop
        it, and forget it. Its registry stops rendering on /metrics.
        The drain-wait exits early when the HealthMonitor declares the
        replica DEAD mid-drain — its remaining work is failed over to
        survivors, so spinning until TimeoutError on sequences that
        will never finish here would be wrong."""
        self.drain(name)
        with self._lock:
            rep = self._replicas.get(name)
        if rep is None:
            return  # fail_over already evicted it
        deadline = None if timeout is None else time.monotonic() + timeout
        while rep.live_sequences() or rep.queue_depth():
            if rep.state in (ReplicaState.STOPPED, ReplicaState.DEAD):
                break  # died mid-drain: fail_over re-homed the work
            if not rep.scheduler_alive():
                break  # crashed mid-drain: handled below
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"replica {name!r} not drained within {timeout}s"
                    f" ({rep.live_sequences()} live,"
                    f" {rep.queue_depth()} queued)")
            time.sleep(0.01)
        if rep.state is ReplicaState.DEAD:
            # a DEAD batcher was already aborted; stop() would join a
            # possibly-hung scheduler thread for its full timeout
            pass
        elif not rep.scheduler_alive() \
                and rep.state is not ReplicaState.STOPPED:
            # the scheduler CRASHED while we drained: live hitting zero
            # here means its slots were FAILED, not finished — racing
            # the HealthMonitor to stop+forget the replica would discard
            # work the failover machinery can still replay token-exactly
            self.fail_over(name, reason="scheduler_crashed")
            return
        else:
            rep.stop()
        with self._lock:
            self._replicas.pop(name, None)
            self._outstanding.pop(name, None)
        self._c_requests.remove(replica=name)
        self._sync_replica_gauge()

    # -- failover ----------------------------------------------------------
    def fail_over(self, name: str, reason: str = "dead",
                  error: Optional[BaseException] = None,
                  retry_budget: int = 3, backoff_s: float = 0.05,
                  deadline_s: float = 30.0) -> Dict[str, int]:
        """Evict a DEAD replica and re-dispatch its in-flight requests
        to survivors, token-exactly. The HealthMonitor's default
        on_dead callback.

        Order matters: (1) under the lock the replica leaves the
        routing tables (no new traffic can land), (2) `kill` aborts its
        batcher — FENCING every in-flight GenRequest, which atomically
        freezes the emitted-token snapshot against a hung-then-resumed
        scheduler thread, (3) each unfinished request is replayed on a
        survivor as prompt ‖ emitted-tokens with the remaining budget
        (same seed: sampled decode folds the key at absolute positions,
        so the continuation is identical to the fault-free run), under
        `retry_budget` attempts with exponential `backoff_s` and a
        `deadline_s` cap; exhaustion terminates the caller's handle
        with a typed ReplicaLost. Requests the fence caught already
        complete (budget/EOS) are finalized locally without a replay.

        Returns {"replayed", "finalized", "finished", "lost"} counts."""
        with self._lock:
            rep = self._replicas.pop(name, None)
            if rep is None:
                return {"replayed": 0, "finalized": 0, "finished": 0,
                        "lost": 0}
            pending = [f for f in self._outstanding.pop(name, [])]
            # affinity entries pointing at the dead replica go stale
            self._affinity = OrderedDict(
                (k, v) for k, v in self._affinity.items() if v != name)
            self._homes.pop(name, None)
            self._lost_replicas[name] = reason
            self._lost_roles[name] = rep.role
        err = error if error is not None else ReplicaLost(
            f"replica {name!r} declared dead ({reason})")
        rep.kill(err)
        self._c_requests.remove(replica=name)
        self._c_failovers.inc(reason=reason)
        self._sync_replica_gauge()
        counts = {"replayed": 0, "finalized": 0, "finished": 0, "lost": 0}
        tracer = get_tracer()
        for fr in pending:
            inner, _ = fr._snapshot()
            if inner is None or fr.replica != name:
                continue  # finalized or already re-homed elsewhere
            snap = inner._fence(err)
            if snap is None:  # finished cleanly before the death
                counts["finished"] += 1
                self._c_failover_requests.inc(outcome="finished")
                continue
            toks, times = snap
            with fr._cv:
                base = fr._base + toks
                base_times = fr._base_times + times
                t_first = fr._t_first
            if t_first is None:
                t_first = inner.t_first_token
            done_by_budget = len(base) >= fr.max_new_tokens
            done_by_eos = (fr.eos_id is not None and toks
                           and toks[-1] == fr.eos_id)
            if done_by_budget or done_by_eos:
                # the fence landed between the final emit and the
                # retire: the snapshot IS the complete answer
                fr._finalize(base, base_times, t_first)
                counts["finalized"] += 1
                self._c_failover_requests.inc(outcome="finalized")
                continue
            replay = fr.prompt if not base else np.concatenate(
                [fr.prompt, np.asarray(base, np.int32)])
            remaining = fr.max_new_tokens - len(base)
            new = None
            last_err: Optional[BaseException] = None
            give_up = time.monotonic() + deadline_s
            # the replay CONTINUES the original trace: the survivor's
            # submit sees fr's context, so both incarnations' spans
            # stitch under one trace_id in the merged timeline
            with use_context(fr.trace_ctx), \
                    tracer.span("fleet.failover", replica=name,
                                replayed_tokens=len(base)):
                for attempt in range(retry_budget + 1):
                    try:
                        new = self.submit(replay, remaining,
                                          eos_id=fr.eos_id, seed=fr.seed)
                        break
                    except AdmissionError as e:
                        last_err = e
                        pause = backoff_s * (2 ** attempt)
                        if (attempt >= retry_budget
                                or time.monotonic() + pause > give_up):
                            break
                        self._c_failover_retries.inc()
                        time.sleep(pause)
            if new is None:
                fr._terminate(ReplicaLost(
                    f"failover of request from dead replica {name!r}"
                    f" exhausted {retry_budget + 1} attempts"
                    f" ({type(last_err).__name__}: {last_err})"))
                counts["lost"] += 1
                self._c_failover_requests.inc(outcome="lost")
                continue
            new_inner, _ = new._snapshot()
            # track the CALLER's handle on the new home, not the
            # router-internal replay wrapper (same rule as drain)
            fr._rebind(new.replica, new_inner, base, base_times, t_first)
            with self._lock:
                pend = self._outstanding.setdefault(new.replica, [])
                pend[:] = [f for f in pend if f is not new]
                pend.append(fr)
            counts["replayed"] += 1
            self._c_failover_requests.inc(outcome="replayed")
            if self.events is not None:
                self.events.record(ev.FLEET_FAILOVER, replica=name,
                                   to=new.replica,
                                   replayed_tokens=len(base),
                                   remaining=remaining)
        return counts

    def lost_replicas(self) -> Dict[str, str]:
        """{name: reason} of failed-over replicas whose capacity has not
        been respawned yet — the Autoscaler's respawn work list."""
        with self._lock:
            return dict(self._lost_replicas)

    def lost_replica_roles(self) -> Dict[str, str]:
        """{name: role} of failed-over replicas — lets a role-scoped
        autoscaler respawn only its own pool's casualties."""
        with self._lock:
            return dict(self._lost_roles)

    def clear_lost(self, name: str) -> None:
        """Forget a lost replica (its replacement is up): health()
        returns to "ok" and the SLO budget un-tightens."""
        with self._lock:
            self._lost_replicas.pop(name, None)
            self._lost_roles.pop(name, None)
        self._sync_replica_gauge()

    def shutdown(self) -> None:
        if self.disagg is not None:
            self.disagg.stop()
        with self._lock:
            reps = list(self._replicas.values())
        for r in reps:
            r.stop()
        self._sync_replica_gauge()

    # -- reporting ---------------------------------------------------------
    def health(self) -> Dict[str, object]:
        """Aggregate fleet health: "ok" only when every replica is READY
        and nothing failed to load or died unreplaced; "degraded" while
        any replica drains, a load failure is outstanding, or a
        failed-over replica's capacity is missing (cleared when the
        autoscaler respawns it); "down" with zero ready."""
        with self._lock:
            reps = dict(self._replicas)
            failed = dict(self._failed_loads)
            lost = dict(self._lost_replicas)
        per = {n: r.health() for n, r in sorted(reps.items())}
        ready = sum(1 for h in per.values() if h["state"] == "ready")
        if ready == 0:
            status = "down"
        elif failed or lost or any(h["state"] != "ready"
                                   for h in per.values()):
            status = "degraded"
        else:
            status = "ok"
        return {"status": status, "ready": ready, "replicas": per,
                "failed_loads": failed, "lost_replicas": lost}

    def stats(self) -> Dict[str, object]:
        with self._lock:
            reps = dict(self._replicas)
            affinity = len(self._affinity)
        return {
            "policy": self.policy,
            "slo_ttft_s": self.slo_ttft_s,
            "affinity_keys": affinity,
            "health": self.health(),
            "replicas": {n: r.stats() for n, r in sorted(reps.items())},
        }
