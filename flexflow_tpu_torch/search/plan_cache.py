"""Content-addressed plan cache + background pre-planning for the Unity
search (docs/search.md).

Every elastic recovery, drift re-plan, and fleet resize used to pay a
cold full Unity search — enumeration plus simulation of every feasible
mesh factorization — even when the graph was unchanged and the machine
moved by one pod. This module makes the search incremental:

 - `plan_key(graph, config, machine, batch_size, n_devices)` — a
   canonical content hash over everything the search's answer depends
   on: the PCG (ops, shapes, dtypes, params, weights — pre-rewrite),
   the machine spec INCLUDING any fitted-profile overlay (the overlay
   replaces chip constants and latency terms, so the post-overlay
   fingerprint changes when a refit lands), the batch size, the device
   count, and the search knobs (budget/alpha/axis flags/memory
   search/kernel tier/substitution file content).
 - `PlanCache` — an in-memory LRU of serialized SearchResults keyed by
   that hash, with optional disk persistence (`--plan-cache-dir`). A
   hit skips enumeration entirely (`candidates_simulated == 0`); the
   adopted plan is still re-validated through the analysis gate before
   use (search/unity.py::_adopt_cached_plan). Near-miss lookups
   (`get_warm`: same graph + knobs, different machine/batch/devices)
   seed the warm-started refinement instead of a cold enumeration.
 - `BackgroundPlanner` — a single worker thread that pre-computes plans
   for anticipated topologies (the elastic coordinator's survivor
   sets, the fleet autoscaler's next resize target) so the plan is a
   cache HIT by the time the event fires and the search leaves the
   recovery pause entirely.
 - `plan_distance_us` — the reshard-awareness term of a re-plan off a
   LIVE plan, priced through the port's resharding planner (a live plan
   is resharding.plan_of of a running model, which the elastic
   coordinator's re-plans set, elastic/coordinator.py).

Metrics: ff_search_cache_{hits,misses,evictions}_total,
ff_search_warm_starts_total, and the ff_search_wall_time_ms histogram
labeled by mode=(hit|warm|cold).

The port's copy of flexflow_tpu/search/plan_cache.py, in the JAX
package's file format: the fingerprints canonicalize the port's op
params and config knobs as JAX's do, so a plan either package caches is
an exact hit in the other. The config's `device` (port-only) is left out
of the knob leg: the plan depends on the machine spec, which has its own
leg, not on where the process runs. `use_native_search` is keyed as it
is set: both packages' native cores are the same C++ core, so a plan
either package searched natively is an exact hit in the other.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import math
import os
import queue
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Tuple

_log = logging.getLogger("flexflow_tpu_torch.search.plan_cache")

# search wall-time histogram buckets: searches span ~1 ms (cache hit)
# to minutes (cold joint search on a big graph)
SEARCH_WALL_BUCKETS_MS = (1.0, 5.0, 25.0, 100.0, 500.0, 2500.0,
                          10000.0, 60000.0, 300000.0)


# -- canonical fingerprints -------------------------------------------------

def _canon(v) -> Any:
    """JSON-able, process-independent canonical form of a param value.
    Objects without a stable value representation degrade to their type
    name — two graphs differing ONLY in such an object hash alike, which
    the name-binding + analysis gate on adoption still catches."""
    if v is None or isinstance(v, (bool, int, str)):
        return v
    if isinstance(v, float):
        return repr(v)
    if isinstance(v, (list, tuple)):
        return [_canon(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _canon(v[k]) for k in sorted(v, key=str)}
    if hasattr(v, "value") and type(v).__module__ != "builtins":  # enums
        return [type(v).__name__, _canon(v.value)]
    return f"<{type(v).__name__}>"


def _digest(obj) -> str:
    return hashlib.sha256(
        json.dumps(obj, sort_keys=True, default=str).encode()).hexdigest()


def graph_fingerprint(graph) -> str:
    """Content hash of the PCG: per-op (name, type, input/output
    dims+dtypes, weight specs, params) in topo order. Computed on the
    PRE-rewrite graph at search entry, so a rebuilt model (fresh guids,
    same architecture) fingerprints identically — the property the
    elastic coordinator's pre-computed plans rely on."""
    parts = []
    for op in graph.topo_order():
        parts.append([
            op.name, op.op_type.value,
            [[list(t.dims), t.dtype.value] for t in op.inputs],
            [[list(t.dims), t.dtype.value] for t in op.outputs],
            [[getattr(w._weight_spec, "name", str(i)), list(w.dims),
              w.dtype.value] for i, w in enumerate(op.weights)],
            _canon(dict(op.params)),
        ])
    return _digest(parts)


def machine_fingerprint(machine) -> str:
    """Content hash of the machine AFTER any fitted-profile overlay was
    applied (make_machine_model overlays before anyone sees the model,
    and apply_overlay replaces the ChipSpec / latency coefficients in
    place) — so a refit bumps the fingerprint and stale plans miss."""
    d: Dict[str, Any] = {
        "class": type(machine).__name__,
        "num_chips": int(machine.num_chips),
        "chip": _canon(dataclasses.asdict(machine.chip)),
        "dispatch_overhead_us": repr(machine.dispatch_overhead_us),
        "collective_latency_us": repr(machine.collective_latency_us),
        "step_time_scale": repr(machine.step_time_scale),
    }
    tiers = getattr(machine, "tiers", None)
    if tiers:
        d["tiers"] = [_canon(dataclasses.asdict(t)) for t in tiers]
        d["tier_scales"] = _canon(dict(getattr(machine, "tier_scales",
                                               {}) or {}))
    conn = getattr(machine, "connection", None)
    if conn is not None:
        d["connection"] = [[int(x) for x in row] for row in conn]
        d["link_gbps"] = repr(machine.link_gbps)
        d["segment_bytes"] = repr(machine.segment_bytes)
        d["routing"] = machine.routing
    return _digest(d)


# config fields whose value changes what the search returns — the knob
# leg of the cache key. plan-cache control knobs themselves are included
# where they change the RESULT (warm start may accept a tolerance-worse
# plan), excluded where they only control caching (dir/capacity).
SEARCH_KNOB_FIELDS = (
    "search_budget", "search_alpha", "base_optimize_threshold",
    "refine_top_k", "joint_search", "strategy_search", "mcmc_budget",
    "mcmc_propagate", "only_data_parallel", "enable_parameter_parallel",
    "enable_attribute_parallel", "enable_sequence_parallel",
    "enable_pipeline_parallel", "pipeline_microbatches",
    "enable_inplace_optimizations", "search_overlap_backward_update",
    "analysis_prune", "memory_search", "memory_budget_mb",
    "optimizer_state_factor", "allow_mixed_precision",
    "grad_bucket_bytes", "kernel_impl", "kernel_residual_threshold",
    "use_native_search", "measure_op_costs", "search_warm_start",
    "warm_fallback_tolerance", "replan_distance_weight",
)


def _file_digest(path: Optional[str]) -> Optional[str]:
    if not path or not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def knobs_fingerprint(config) -> str:
    knobs = {f: _canon(getattr(config, f, None))
             for f in SEARCH_KNOB_FIELDS}
    # rule files and fitted profiles change the result by CONTENT, so
    # hash the bytes, not the path (same file moved = same plans;
    # edited in place = different plans)
    knobs["substitution_json"] = _file_digest(
        getattr(config, "substitution_json_path", None))
    knobs["fitted_profile"] = _file_digest(
        getattr(config, "fitted_profile_file", None))
    return _digest(knobs)


@dataclasses.dataclass(frozen=True)
class PlanKey:
    """The cache key: content hashes for the graph/machine/knob legs
    plus the two plain integers the search is parameterized on."""

    graph_hash: str
    machine_hash: str
    knobs_hash: str
    batch_size: int
    n_devices: int

    @property
    def full(self) -> str:
        return _digest([self.graph_hash, self.machine_hash,
                        self.knobs_hash, self.batch_size, self.n_devices])

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def plan_key(graph, config, machine, batch_size: int, n_devices: int,
             graph_hash: Optional[str] = None) -> PlanKey:
    """Build the PlanKey. `graph_hash` overrides the graph leg — the
    background pre-planner holds a POST-rewrite graph and passes the
    original pre-rewrite hash so the stored entry lands where the
    recovery-time fresh-graph lookup will look."""
    return PlanKey(
        graph_hash=graph_hash or graph_fingerprint(graph),
        machine_hash=machine_fingerprint(machine),
        knobs_hash=knobs_fingerprint(config),
        batch_size=int(batch_size), n_devices=int(n_devices))


# -- the cache --------------------------------------------------------------

class PlanCache:
    """In-memory LRU of serialized plans with optional disk persistence.

    Values are the plain-dict serialization of a SearchResult
    (search/unity.py::result_to_dict — the export_strategy format plus
    provenance), NOT live SearchResults: strategies are keyed by op
    NAME so an entry binds onto any rebuild of the same graph, and the
    dict round-trips through JSON for the disk tier unchanged.
    Thread-safe: the background pre-planner writes while compiles read.
    """

    def __init__(self, capacity: int = 32,
                 cache_dir: Optional[str] = None, registry=None):
        self.capacity = max(1, int(capacity))
        self.cache_dir = cache_dir
        self._mem: "OrderedDict[str, Tuple[PlanKey, Dict]]" = OrderedDict()
        self._lock = threading.RLock()
        if registry is None:
            from ..obs.registry import REGISTRY as registry  # noqa: N813
        self._c_hits = registry.counter(
            "ff_search_cache_hits_total",
            "Plan-cache hits (enumeration skipped)", labels=("tier",))
        self._c_misses = registry.counter(
            "ff_search_cache_misses_total", "Plan-cache misses")
        self._c_evictions = registry.counter(
            "ff_search_cache_evictions_total",
            "Plan-cache in-memory LRU evictions (disk entries persist)")
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)

    # -- disk tier ---------------------------------------------------------
    def _path(self, key: PlanKey) -> Optional[str]:
        if not self.cache_dir:
            return None
        # the graph and knob legs are embedded in the filename so the
        # near-miss scan (get_warm) can skip non-matching entries from
        # the directory listing alone, without opening them
        return os.path.join(
            self.cache_dir,
            f"plan_{key.graph_hash[:16]}_{key.knobs_hash[:16]}"
            f"_{key.full[:16]}.json")

    def _disk_load(self, key: PlanKey) -> Optional[Dict]:
        path = self._path(key)
        if not path or not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                entry = json.load(f)
            if entry.get("key") != key.to_dict():
                return None  # filename collision or stale format
            return entry.get("plan")
        except (OSError, ValueError) as exc:
            _log.warning("plan cache: unreadable entry %s (%s)", path, exc)
            return None

    def _disk_store(self, key: PlanKey, plan: Dict) -> None:
        path = self._path(key)
        if not path:
            return
        tmp = path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump({"key": key.to_dict(), "plan": plan}, f)
            os.replace(tmp, path)
        except OSError as exc:
            _log.warning("plan cache: could not persist %s (%s)", path, exc)

    def _disk_iter(self, graph_prefix: Optional[str] = None,
                   knobs_prefix: Optional[str] = None):
        """Iterate disk entries; with prefixes given, non-matching files
        are skipped from the directory listing alone (the filename
        embeds the graph/knob legs) — the get_warm scan stays O(1) file
        reads per matching candidate, not per cache entry."""
        if not self.cache_dir or not os.path.isdir(self.cache_dir):
            return
        for name in sorted(os.listdir(self.cache_dir)):
            if not (name.startswith("plan_") and name.endswith(".json")):
                continue
            parts = name[len("plan_"):-len(".json")].split("_")
            if graph_prefix is not None and len(parts) == 3:
                if (parts[0] != graph_prefix
                        or (knobs_prefix is not None
                            and parts[1] != knobs_prefix)):
                    continue
            try:
                with open(os.path.join(self.cache_dir, name)) as f:
                    entry = json.load(f)
            except (OSError, ValueError):
                continue
            kd = entry.get("key") or {}
            try:
                yield PlanKey(**kd), entry.get("plan") or {}
            except TypeError:
                continue

    # -- lookup ------------------------------------------------------------
    def get_entry(self, key: PlanKey) -> Optional[Tuple[str, Dict]]:
        """Exact-key lookup WITHOUT hit/miss accounting: memory first,
        then disk (a disk hit is promoted into memory). Returns
        (tier, plan). The caller counts via note_hit/note_miss once the
        entry actually ADOPTED — a stale entry that fails to bind must
        land in the miss column, not the hit one."""
        with self._lock:
            hit = self._mem.get(key.full)
            if hit is not None:
                self._mem.move_to_end(key.full)
                return "memory", dict(hit[1])
            plan = self._disk_load(key)
            if plan is not None:
                self._insert(key, plan)
                return "disk", dict(plan)
            return None

    def get(self, key: PlanKey, count: bool = True) -> Optional[Dict]:
        """get_entry + immediate accounting — for callers that adopt
        unconditionally (tests, tools)."""
        entry = self.get_entry(key)
        if count:
            if entry is not None:
                self.note_hit(entry[0])
            else:
                self.note_miss()
        return entry[1] if entry is not None else None

    def note_hit(self, tier: str) -> None:
        self._c_hits.inc(tier=tier)

    def note_miss(self) -> None:
        self._c_misses.inc()

    def get_warm(self, key: PlanKey) -> Optional[Dict]:
        """Near-miss lookup for warm starting: an entry with the SAME
        graph and knobs but a different machine/batch/device count —
        the shrunk/grown machine, the refreshed fitted profile, the
        changed batch. Prefers the candidate whose device count is
        closest (log-ratio) to the requested one, most recent first."""
        best: Optional[Tuple[float, Dict]] = None
        with self._lock:
            # memory tier snapshotted under the lock; the disk scan runs
            # UNLOCKED below so a slow directory never blocks concurrent
            # get/put (the background pre-planner writes while compiles
            # read)
            seen = set()
            candidates: List[Tuple[PlanKey, Dict]] = []
            for k, plan in reversed(self._mem.values()):
                candidates.append((k, plan))
                seen.add(k.full)
        for k, plan in self._disk_iter(
                graph_prefix=key.graph_hash[:16],
                knobs_prefix=key.knobs_hash[:16]):
            if k.full not in seen:
                candidates.append((k, plan))
        for k, plan in candidates:
            if k.full == key.full:
                continue
            if (k.graph_hash != key.graph_hash
                    or k.knobs_hash != key.knobs_hash):
                continue
            d = abs(math.log2(max(1, k.n_devices))
                    - math.log2(max(1, key.n_devices)))
            d += 0.1 * abs(math.log2(max(1, k.batch_size))
                           - math.log2(max(1, key.batch_size)))
            if best is None or d < best[0]:
                best = (d, dict(plan))
        return best[1] if best else None

    # -- store -------------------------------------------------------------
    def put(self, key: PlanKey, plan: Dict) -> None:
        with self._lock:
            self._insert(key, plan)
            self._disk_store(key, plan)

    def _insert(self, key: PlanKey, plan: Dict) -> None:
        self._mem[key.full] = (key, dict(plan))
        self._mem.move_to_end(key.full)
        while len(self._mem) > self.capacity:
            self._mem.popitem(last=False)
            self._c_evictions.inc()

    def invalidate(self, key: PlanKey) -> None:
        """Drop an entry that failed to bind/validate on adoption."""
        with self._lock:
            self._mem.pop(key.full, None)
            path = self._path(key)
            if path and os.path.exists(path):
                try:
                    os.remove(path)
                except OSError:
                    pass

    def clear(self) -> None:
        with self._lock:
            self._mem.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._mem)


# -- process-wide instance --------------------------------------------------

_CACHE: Optional[PlanCache] = None
_CACHE_CONF: Optional[Tuple] = None
_CACHE_LOCK = threading.Lock()


def get_plan_cache(config) -> Optional[PlanCache]:
    """The process-wide cache, (re)configured from the config's
    plan-cache knobs. None when caching is disabled. The instance is
    rebuilt when the dir/capacity change; entries survive config clones
    (the elastic coordinator's per-build configs) otherwise."""
    if not getattr(config, "plan_cache", True):
        return None
    global _CACHE, _CACHE_CONF
    conf = (getattr(config, "plan_cache_dir", None),
            int(getattr(config, "plan_cache_capacity", 32)))
    with _CACHE_LOCK:
        if _CACHE is None or _CACHE_CONF != conf:
            _CACHE = PlanCache(capacity=conf[1], cache_dir=conf[0])
            _CACHE_CONF = conf
        return _CACHE


def reset_plan_cache() -> None:
    """Drop the process-wide cache (tests; the conftest autouse fixture
    calls this so searches never hit a previous test's entries)."""
    global _CACHE, _CACHE_CONF
    with _CACHE_LOCK:
        _CACHE = None
        _CACHE_CONF = None


def observe_search_wall(wall_ms: float, mode: str, registry=None) -> None:
    """One search's wall time into the mode-labeled histogram — the
    measurement behind 'warm re-planning is >= 5x faster than cold'."""
    if registry is None:
        from ..obs.registry import REGISTRY as registry  # noqa: N813
    registry.histogram(
        "ff_search_wall_time_ms",
        "Unity search wall time by mode (hit = plan-cache adoption,"
        " warm = seeded local refinement, cold = full enumeration)",
        labels=("mode",), buckets=SEARCH_WALL_BUCKETS_MS,
    ).observe(float(wall_ms), mode=mode)


def count_warm_start(registry=None) -> None:
    if registry is None:
        from ..obs.registry import REGISTRY as registry  # noqa: N813
    registry.counter(
        "ff_search_warm_starts_total",
        "Searches answered by warm-started refinement of a cached"
        " near-miss plan").inc()


# -- plan distance (reshard-aware re-planning) ------------------------------

def _candidate_weight_plan(graph, strategies, mesh_axes,
                           device_ids) -> "object":
    """A ShardingPlan for the candidate's WEIGHTS under `strategies`,
    built without compiling: the same per-op sharding rules
    FFModel._assign_strategy applies (TP shards the registered weight
    dim over 'model', row-TP the linear kernel's in-features, EP the
    stacked expert dim; dp/ap/sp leave weights replicated)."""
    from ..ffconst import OpType
    from ..resharding.plan import ArraySpec, MeshSpec, ShardingPlan
    from .simulator import TP_WEIGHT_SHARD_DIMS

    mesh = MeshSpec(device_ids=tuple(int(i) for i in device_ids),
                    axes=tuple((str(k), int(v))
                               for k, v in (mesh_axes or {}).items()))
    # the runtime clamps a searched ep to the mesh's expert axis
    # (model.py _assign_strategy: min(s.ep, axes['expert'])) — the priced
    # candidate must claim the same degree, or a cached ep plan
    # transplanted onto a pod-loss survivor mesh prices a reshard the
    # runtime will never perform
    ep_cap = int((mesh_axes or {}).get("expert", 1))
    arrays: Dict[str, Any] = {}
    for op in graph.topo_order():
        s = strategies.get(op.guid)
        if s is None:
            continue
        for w in op.weights:
            wname = getattr(w._weight_spec, "name", None)
            if wname is None:
                continue
            degrees = [1] * len(w.dims)
            axes: List[Optional[str]] = [None] * len(w.dims)
            op_ep = min(int(getattr(s, "ep", 1)), ep_cap)
            if (op.op_type == OpType.EXPERTS and op_ep > 1
                    and w.dims[0] % op_ep == 0):
                degrees[0], axes[0] = op_ep, "expert"
            elif s.tp > 1:
                shard_dim = ({"kernel": 0} if s.tp_row
                             else TP_WEIGHT_SHARD_DIMS.get(op.op_type))
                if shard_dim and wname in shard_dim:
                    d = shard_dim[wname] % len(w.dims)
                    if w.dims[d] % s.tp == 0:
                        degrees[d], axes[d] = s.tp, "model"
            arrays[f"params/{op.name}/{wname}"] = ArraySpec(
                degrees=tuple(degrees), axes=tuple(axes))
    return ShardingPlan(mesh=mesh, arrays=arrays)


def plan_distance_us(graph, live_plan, strategies, mesh_axes, machine,
                     n_devices: int, device_ids=None) -> float:
    """Predicted cost (us) of redistributing the LIVE weights from
    `live_plan` (resharding.plan_of of the running model) onto the
    candidate plan — priced through the same resharding/cost.py terms
    an actual recovery pays. The warm re-plan's objective adds this,
    weighted by --replan-distance-weight, so a marginally-cheaper step
    never wins by triggering a massive reshard. Unplannable moves
    (shape/spec mismatch) degrade to a bytes/bandwidth estimate.
    `device_ids`: the candidate's real device set — defaults to
    0..n-1, but re-plans must pass the survivor ids so an unchanged
    layout prices as a noop rather than a cross-mesh transfer."""
    from ..resharding.cost import step_cost_us
    from ..resharding.plan import ReshardPlanError, plan_move

    ids = (list(device_ids)[:int(n_devices)] if device_ids
           else list(range(int(n_devices))))
    cand = _candidate_weight_plan(graph, strategies, mesh_axes, ids)
    peak = int(0.25 * machine.memory_budget_bytes())
    total = 0.0
    for op in graph.topo_order():
        for w in op.weights:
            wname = getattr(w._weight_spec, "name", None)
            if wname is None:
                continue
            path = f"params/{op.name}/{wname}"
            itemsize = w.dtype.np_dtype.itemsize
            try:
                move = plan_move(path, tuple(int(d) for d in w.dims),
                                 itemsize, str(w.dtype.value), live_plan,
                                 cand, peak, machine=machine)
            except ReshardPlanError:
                bytes_ = w.num_elements() * itemsize
                total += machine.p2p_time_us(bytes_)
                continue
            if move.noop:
                continue
            per_round = sum(
                step_cost_us(s, machine,
                             n_devices=len(cand.mesh.device_ids))
                for s in move.steps)
            total += max(1, move.rounds) * per_round
    return total


# -- background pre-planning ------------------------------------------------

class BackgroundPlanner:
    """One worker thread pre-computing plans off the critical path.

    `submit(tag, fn)` enqueues a job; the daemon worker runs jobs
    serially (plan searches are CPU-bound — parallel workers would
    contend with the training/serving threads they exist to unblock)
    and parks for `idle_timeout_s` before exiting; the next submit
    restarts it. `join()` drains the queue — tests and the CI drill
    use it to assert the pre-computed plan landed in the cache."""

    def __init__(self, name: str = "ff-plan-precompute",
                 idle_timeout_s: float = 5.0):
        self.name = name
        self.idle_timeout_s = float(idle_timeout_s)
        self._q: "queue.Queue[Tuple[str, Any]]" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._idle = threading.Event()
        self._idle.set()
        # bounded: a long-lived coordinator re-anticipates after every
        # recovery/drift re-plan for the life of the job — only the
        # tail is ever read
        self.completed: "deque" = deque(maxlen=256)

    def submit(self, tag: str, fn) -> None:
        with self._lock:
            self._idle.clear()
            self._q.put((tag, fn))
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._loop, name=self.name, daemon=True)
                self._thread.start()

    def _loop(self) -> None:
        while True:
            try:
                tag, fn = self._q.get(timeout=self.idle_timeout_s)
            except queue.Empty:
                # exit-vs-submit race: a submit may have enqueued
                # between the timeout and here — only retire under the
                # lock, with the queue provably empty, and null the
                # thread handle so the next submit restarts cleanly
                with self._lock:
                    if self._q.empty():
                        self._thread = None
                        return
                continue
            t0 = time.perf_counter()
            rec: Dict[str, Any] = {"tag": tag}
            try:
                rec["result"] = fn()
            except Exception as exc:  # noqa: BLE001 — a failed precompute
                # must never take anything down; the event-time search
                # just runs cold as it always did
                rec["error"] = f"{type(exc).__name__}: {exc}"
                _log.warning("background plan %r failed: %s", tag, exc)
            rec["wall_ms"] = (time.perf_counter() - t0) * 1e3
            self.completed.append(rec)
            self._q.task_done()
            # idle is only set under the lock with the queue provably
            # empty: a submit that raced in between re-clears AFTER our
            # set (its clear is also under the lock), so join() can
            # never report idle while a queued job is unprocessed
            with self._lock:
                if self._q.empty():
                    self._idle.set()

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait for the queue to drain; True when idle."""
        return self._idle.wait(timeout=timeout)
