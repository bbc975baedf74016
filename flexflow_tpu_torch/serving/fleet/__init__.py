"""Serving fleet: N model replicas behind one router (the port's copy of
flexflow_tpu/serving/fleet/, host-only code over the port's
ContinuousBatcher; its device work is the batcher's, the KV handoff's
export and import included).

It composes the single-replica pieces (ContinuousBatcher, PagedKVPool
and PrefixCache, `request_resize`, AdmissionController, the metric
families) into the serving tier:

 - `Replica` (replica.py): one model behind its own batcher + private
   MetricsRegistry + lifecycle state (READY/DRAINING/STOPPED/DEAD).
 - `Router` (router.py): prefix-cache-AFFINE routing — the PrefixCache's
   rolling page-block hashes (`prefix_route_key`) are the routing key,
   so a request lands on the replica that already owns its shared
   prefix, falling back to sticky-key then least-loaded when cold — with
   fleet-wide SLO admission that sheds by PREDICTED TTFT
   (`SLOExceeded`, same typed-429 contract as queue/pool rejections),
   drain-with-handoff replica removal, and token-EXACT in-flight
   failover off DEAD replicas (`fail_over`: fence + replay
   prompt ‖ emitted-tokens on a survivor).
 - `Autoscaler` (autoscaler.py): watches queue depth, page utilization,
   and registry-read p99 TTFT, grows/shrinks individual replica meshes
   via `request_resize` (zero drops, token-identical), adds/drains
   whole replicas under sustained load swings, and RESPAWNS replicas
   the monitor declared dead.
 - `HealthMonitor` (health.py): heartbeat + EWMA straggler
   probes scoring each replica READY → SUSPECT → DEAD
   (`ff_fleet_health_state`), with the DEAD verdict driving
   `Router.fail_over`.
 - `DisaggCoordinator` (disagg.py): the disaggregated
   prefill/decode plane — `role="prefill"` replicas park each request
   after its first token, and the coordinator ships the finished KV
   pages to a `role="decode"` replica as a priced, FFTA06x-gated,
   64 MB-chunked TRANSFER (reusing `plan_slot_migration` + the machine
   model's tier pricing), token-identical to unified serving with
   `resume_parked` as the zero-drop fallback.
 - `ChaosEngine` / `FleetFaultPlan` (chaos.py): seeded,
   deterministic replica fault injection (crash-at-token-N / hang /
   straggle / flaky-submit), so the failover path is exercised, not
   trusted (bench.py `run_fleet_chaos`).

The fleet's merged observability — one /metrics with a `replica` label,
one aggregated /healthz — is `obs.registry.render_merged` over
`Router.replica_registries()` plus `Router.health()`; server.py wires
both when a fleet is registered.

Several replicas may share one model on one card: each batcher owns its
caches and graphs, and captures them on its own scheduler thread
(runtime/graphs.py `gc_paused`; core/op.py caches a weight's cast once,
outside any capture). Give each replica `num_slots`: a derived count
would claim the whole card for each.
"""
from .autoscaler import Autoscaler
from .chaos import (FAULT_KINDS, ChaosEngine, FleetFault, FleetFaultPlan,
                    InjectedCrash)
from .disagg import DisaggCoordinator, HandoffFailed
from .health import HealthMonitor, HealthState, ReplicaLost
from .replica import Replica, ReplicaState
from .router import FleetRequest, FleetUnavailable, Router

__all__ = ["Autoscaler", "ChaosEngine", "DisaggCoordinator", "FAULT_KINDS",
           "FleetFault", "FleetFaultPlan", "FleetRequest",
           "FleetUnavailable", "HandoffFailed", "HealthMonitor",
           "HealthState", "InjectedCrash", "Replica", "ReplicaLost",
           "ReplicaState", "Router"]
