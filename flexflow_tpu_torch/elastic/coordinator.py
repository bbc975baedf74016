"""Elastic coordinator: survive a lost rank by re-planning on the survivors
(the port's counterpart of flexflow_tpu/elastic/coordinator.py).

Recovery state machine (the JAX package's):

    TRAIN --transient--> RETRY (in place, bounded backoff) --> TRAIN
    TRAIN --bad numerics--> WATCHDOG (elastic/watchdog.py):
        a NaN/Inf or spiking loss first SKIPs the offending batch (the
        step is computed into temporaries, FFModel `_elastic_step`, and
        never commits: weights, optimizer state and step count stay as
        they were); after max_consecutive_bad bad steps in a row,
        ROLLBACK to the newest VERIFIED checkpoint (runtime/durability.py)
        and replay from its step;
    TRAIN --topology loss--> RECOVER:
        1. shrink: drop the lost ranks from the rank list and from the
           topology spec (renumbered survivor spec);
        2. re-plan: rebuild the model on the survivors — compile() re-runs
           the Unity search (search/unity.py) against the smaller
           machine, on the survivors' leader, so the parallel strategy is
           re-derived, not merely truncated;
        3. restore — LIVE when possible, disk otherwise:
           a. live (resharding/): when the survivors still hold every
              shard of the pre-loss state (FFTA063 coverage check over the
              old plan) AND the live tree verifies clean on every
              survivor, `redistribute` moves the shards among the
              survivors from the old layout to the re-planned one — zero
              disk I/O, and resume from the FAILING step;
           b. disk: otherwise restore the latest verified checkpoint
              (runtime/checkpoint.py) into the new model, each rank
              cutting its shards in place, resuming from the
              checkpointed step.
           Both paths label the `elastic.recover>restore` span and the
           ff_recovery_restore_total counter with source=live|disk;
        4. resume: continue the SAME fit() call.

On torch.distributed a chip is a rank: every rank of `config.device_ids`
(default: the world) builds the same coordinator and runs the same fit
with the same FaultPlan, one process per mesh position. At a chip-loss
fault every rank records it; a rank whose global rank is lost leaves
`fit` at once (`departed` says at which step) and takes part in nothing
after that: no group, no collective, no checkpoint write. The survivors
make their own process group (runtime/distributed.py `group_of`) and
everything after the loss runs over it or over the rebuilt mesh's
groups; a survivor that waited on a lost rank would hang. Every
decision that could differ between ranks is agreed over that group
before it is taken (the live tree's verification; the step wall the
drift detector reads is the slowest rank's), so the survivors' event
logs and histories agree. The checkpoints are written by the mesh's
leader into the one shared `checkpoint_dir`.

The training loop here is the plain single-step path (one dispatch per
optimizer step): each dispatch is a clean retry/recovery boundary.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import random
import tempfile
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..obs.registry import REGISTRY
from ..obs.tracing import get_tracer
from ..runtime import distributed
from ..runtime.checkpoint import CheckpointError
from ..runtime.durability import DurableCheckpointer
from .detector import FailureDetector
from .events import (CHECKPOINT, DRIFT_BREACH, DRIFT_REFIT, DRIFT_REPLAN,
                     DRIFT_SEARCH, PLAN_ANALYSIS, PLAN_PRECOMPUTE,
                     RECOVERY_DONE, RECOVERY_LIVE_FALLBACK,
                     RECOVERY_RESTORE, RECOVERY_SEARCH, RECOVERY_START,
                     EventLog)
from .faults import FaultInjector, FaultPlan, TopologyLoss
from .retry import RetryPolicy
from .watchdog import OK, ROLLBACK, SKIP, TrainingWatchdog

_log = logging.getLogger("flexflow_tpu_torch.elastic")


def ring_topology_spec(num_chips: int, gbps: float = 45.0) -> Dict:
    """Default topology spec when the config names no machine-model file:
    a bidirectional 1-D ring (NetworkedMachineModel's own default)."""
    links = [[i, (i + 1) % num_chips, gbps] for i in range(num_chips)] \
        if num_chips > 1 else []
    return {"num_chips": num_chips, "links": links}


def shrink_topology_spec(spec: Dict, lost_positions: Sequence[int]) -> Dict:
    """Survivor spec: drop the lost chips (positions within the spec's
    0..n-1 numbering), renumber the survivors densely, and keep only links
    with both endpoints alive. A loss can leave the survivor set with few
    or NO intact links — NetworkedMachineModel.from_json handles the
    empty-links case by falling back to its default ring at 45 GB/s.

    Hierarchical ("tiers") specs shrink too: losing whole outermost-tier
    groups keeps the hierarchy with a smaller outer degree, so recovery
    re-plans stay tier-aware. A PARTIAL-group loss breaks tier
    uniformity, which this spec format cannot express: the survivors
    degrade to a flat ring at the innermost tier's bandwidth — logged
    loudly, because tier pricing and the FFTA07x gate disarm until a full
    restart re-reads the original spec."""
    if spec.get("tiers"):
        tiers = [dict(t) for t in spec["tiers"]]
        inner = 1
        for t in tiers[:-1]:
            inner *= int(t["degree"])
        outer = int(tiers[-1]["degree"])
        lost = set(lost_positions)
        lost_groups = {p // inner for p in lost}
        if all(g * inner + i in lost
               for g in lost_groups for i in range(inner)):
            tiers[-1]["degree"] = max(1, outer - len(lost_groups))
            out = dict(spec)
            out["tiers"] = tiers
            out["num_chips"] = inner * tiers[-1]["degree"]
            return out
        survivors = inner * outer - len(lost)
        _log.warning(
            "chip loss %s is not whole outermost-tier groups: the %d "
            "survivors degrade to a FLAT ring spec (tier-aware pricing "
            "and the FFTA07x gate disarm until restart)",
            sorted(lost), survivors)
        return ring_topology_spec(survivors,
                                  gbps=float(tiers[0].get("gbps", 45.0)))
    lost = set(lost_positions)
    n = spec["num_chips"]
    survivors = [i for i in range(n) if i not in lost]
    renum = {old: new for new, old in enumerate(survivors)}
    links = [[renum[i], renum[j], g]
             for i, j, g in spec.get("links", [])
             if i in renum and j in renum]
    out = {"num_chips": len(survivors), "links": links}
    for key in ("segment_mb", "routing"):
        if key in spec:
            out[key] = spec[key]
    return out


class RecoveryFailed(RuntimeError):
    """Recovery could not restore a runnable training state."""


def _rank() -> Optional[int]:
    """This process's global rank; None without torch.distributed (one
    process: the chips of `device_ids` are then only the plan's)."""
    import torch.distributed as dist

    return dist.get_rank() if distributed.is_initialized() else None


def _write_json(path: str, obj) -> None:
    """Write `obj` atomically: every rank writes the same spec files into
    the shared directory while others may be reading them."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


class ElasticCoordinator:
    """Owns the model lifecycle across failures, on every rank of
    `config.device_ids` (default: every rank of the world; one process
    without torch.distributed).

    model_builder: Callable[[FFConfig], FFModel] — builds AND compiles a
    fresh model for a given config, on every live rank. It must be
    deterministic in the model architecture (op names key the
    checkpoint) while the config's rank set and machine model vary
    between calls. The coordinator clones the base config per build
    (dataclasses.replace) with:
      - device_ids = the current survivor ranks,
      - machine_model_file = the (shrunken) survivor topology spec,
      - elastic_step_wrapper = the failure detector's dispatch guard.

    checkpoint_dir must be one directory every rank sees; None makes a
    temporary one on the leader and shares its path with the others.
    """

    def __init__(self, model_builder: Callable, config,
                 fault_plan: Optional[FaultPlan] = None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 5,
                 retry_policy: Optional[RetryPolicy] = None,
                 events: Optional[EventLog] = None,
                 max_recoveries: int = 2,
                 keep_checkpoints: int = 3,
                 watchdog="auto",
                 max_rollbacks: int = 4,
                 drift_detector=None,
                 drift_refit=None,
                 live_resharding: bool = True,
                 reshard_peak_bytes: Optional[int] = None,
                 preplan="auto"):
        self.model_builder = model_builder
        # background pre-planning: after every (re)build a worker thread
        # pre-computes plans for ANTICIPATED topologies into the plan
        # cache, so at event time the recovery's re-plan is a cache HIT.
        # Every rank pre-plans locally (after a loss any survivor may
        # lead the search), and a job runs no collective: its thread
        # would interleave with the training's collectives
        if preplan == "auto":
            preplan = (getattr(config, "search_budget", 0) > 0
                       and getattr(config, "plan_cache", True))
        self.preplan = bool(preplan)
        self.planner = None
        if self.preplan:
            from ..search.plan_cache import BackgroundPlanner

            self.planner = BackgroundPlanner()
        # zero-disk recovery (resharding/): reshard_peak_bytes bounds the
        # per-rank scratch of that move (default: a quarter of the
        # machine's per-chip memory)
        self.live_resharding = bool(live_resharding)
        self.reshard_peak_bytes = reshard_peak_bytes
        # calibration-drift feedback loop (obs/refit.py DriftDetector):
        # on a breach within ITS budget, `drift_refit(model,
        # measured_step_us) -> fitted-profile path` (when given) and a
        # re-plan through the recovery pipeline
        self.drift_detector = drift_detector
        self.drift_refit = drift_refit
        self._fitted_profile_path: Optional[str] = None
        self._drift_replans = 0
        self.events = events if events is not None else EventLog()
        self.rank = _rank()
        # ranks are global torch.distributed ranks; the topology spec
        # numbers chips 0..n-1 in device_ids order
        self.device_ids: List[int] = (
            list(config.device_ids) if config.device_ids is not None
            else list(range(config.total_devices)))
        # set when this rank is lost: {"step", "lost_chips"}
        self.departed: Optional[Dict] = None
        # the last live restore's reshard: moves, bytes, rounds, wall
        self.last_reshard: Optional[Dict] = None
        self.checkpoint_dir = self._shared_dir(checkpoint_dir)
        self.checkpoint_every = max(1, checkpoint_every)
        self.max_recoveries = max_recoveries
        self.max_rollbacks = max_rollbacks
        self._ckpt = DurableCheckpointer(self.checkpoint_dir,
                                         keep_last=keep_checkpoints,
                                         events=self.events)
        self.watchdog: Optional[TrainingWatchdog] = (
            TrainingWatchdog(events=self.events) if watchdog == "auto"
            else watchdog)
        injector = (FaultInjector(fault_plan, events=self.events)
                    if fault_plan is not None else None)
        if injector is not None:
            # corrupt_checkpoint faults tear the newest file in OUR dir,
            # on the rank that writes it
            injector.checkpoint_dir = self.checkpoint_dir
            injector.tears = self._writes
            injector.poison_hook = self._poison_live_state
        # retry jitter draws from a per-run seeded stream
        self.detector = FailureDetector(
            events=self.events, injector=injector,
            retry_policy=retry_policy,
            rng=random.Random(getattr(config, "seed", 0)))
        if config.machine_model_file:
            with open(config.machine_model_file) as f:
                self._topo_spec = json.load(f)
            if "num_chips" not in self._topo_spec:
                from ..search.machine_model import spec_num_chips

                self._topo_spec["num_chips"] = spec_num_chips(
                    self._topo_spec)
        else:
            self._topo_spec = ring_topology_spec(len(self.device_ids))
        self._base_config = config
        self._recoveries = 0
        self._rollbacks = 0
        self._last_ckpt: Optional[tuple] = None  # (step, path)
        # the INITIAL build plans against the same explicit topology spec
        # recovery builds will use
        self.model = self.model_builder(self._config_for(
            self.device_ids, self._write_spec("topology_0.json")))
        self._preplan_anticipated()

    def _shared_dir(self, checkpoint_dir: Optional[str]) -> str:
        if checkpoint_dir is not None:
            return checkpoint_dir
        if len(self.device_ids) == 1 or self.rank is None:
            return tempfile.mkdtemp(prefix="ff_elastic_")
        import torch.distributed as dist

        box = [tempfile.mkdtemp(prefix="ff_elastic_")
               if self.rank == self.device_ids[0] else None]
        dist.broadcast_object_list(box, src=self.device_ids[0],
                                   group=distributed.group_of(
                                       self.device_ids))
        return box[0]

    def _writes(self) -> bool:
        """Whether this rank writes the checkpoints: the leader of the
        current rank list (the mesh's leader, core/machine.py)."""
        return self.rank is None or self.rank == self.device_ids[0]

    # -- background pre-planning -----------------------------------------
    def _anticipated_specs(self) -> List[tuple]:
        """(tag, survivor spec) for the topologies worth pre-planning:
        a tiered spec losing ONE whole outermost-tier group, a flat spec
        losing its last chip. Unanticipated losses miss the cache and
        search cold."""
        spec = self._topo_spec
        out: List[tuple] = []
        if spec.get("tiers"):
            if int(spec["tiers"][-1]["degree"]) > 1:
                inner = 1
                for t in spec["tiers"][:-1]:
                    inner *= int(t["degree"])
                n = int(spec["num_chips"])
                out.append(("pod_loss", shrink_topology_spec(
                    spec, list(range(n - inner, n)))))
        elif int(spec.get("num_chips", len(self.device_ids))) > 1:
            n = int(spec["num_chips"])
            out.append(("chip_loss", shrink_topology_spec(spec, [n - 1])))
        return out

    def _preplan_anticipated(self) -> None:
        """Queue background searches for the anticipated survivor
        topologies: unity_optimize on a CLONE of the compiled graph,
        keyed under the original pre-rewrite graph hash, so the
        recovery-time rebuild looks up exactly this entry. On every rank,
        in this process's plan cache; no collective."""
        if self.planner is None or self.model is None:
            return
        sr = getattr(self.model, "search_result", None)
        if sr is None or sr.graph_hash is None:
            return  # no searched plan to anticipate from
        from ..resharding import plan_of
        from ..search.machine_model import make_machine_model
        from ..search.unity import unity_optimize

        try:
            live_plan = plan_of(self.model)
        except Exception:  # noqa: BLE001 — distance term is optional
            live_plan = None
        for tag, spec in self._anticipated_specs():
            n = int(spec["num_chips"])
            spec_path = os.path.join(
                self.checkpoint_dir,
                f"anticipated_{tag}_{self._recoveries}.json")
            _write_json(spec_path, spec)
            cfg = self._config_for(self.device_ids[:n], spec_path)
            cfg.replan_live_plan = live_plan
            cfg.optimizer_state_factor = \
                self.model.config.optimizer_state_factor
            graph_clone = self.model.graph.clone()
            base_hash = sr.graph_hash

            def job(cfg=cfg, graph_clone=graph_clone, n=n, tag=tag,
                    base_hash=base_hash):
                t0 = time.perf_counter()
                machine = make_machine_model(cfg, n)
                res = unity_optimize(graph_clone, cfg, machine,
                                     cfg.batch_size, n,
                                     cache_graph_hash=base_hash)
                self.events.record(
                    PLAN_PRECOMPUTE, step=self.detector.current_step,
                    tag=tag, n_devices=n, cache=res.cache_mode,
                    cost_us=res.cost_us,
                    wall_ms=round((time.perf_counter() - t0) * 1e3, 3))
                return {"tag": tag, "n_devices": n,
                        "cache": res.cache_mode}

            self.planner.submit(f"anticipate:{tag}", job)

    def preplan_join(self, timeout: Optional[float] = None) -> bool:
        """Block until queued background plans land (tests, drills).
        True when the queue drained; trivially True with preplan off."""
        return self.planner.join(timeout) if self.planner else True

    def _write_spec(self, fname: str) -> str:
        path = os.path.join(self.checkpoint_dir, fname)
        _write_json(path, self._topo_spec)
        return path

    # -- config/model plumbing --------------------------------------------
    def _config_for(self, device_ids: List[int],
                    machine_model_file: Optional[str] = None):
        cfg = dataclasses.replace(
            self._base_config,
            device_ids=list(device_ids),
            num_devices=None,
            elastic_step_wrapper=self.detector.wrap)
        if machine_model_file is not None:
            cfg.machine_model_file = machine_model_file
        if self._fitted_profile_path is not None:
            cfg.fitted_profile_file = self._fitted_profile_path
        return cfg

    def _group(self, ranks: Optional[Sequence[int]] = None):
        """The process group of `ranks` (default the current ones), made
        by each of them at the same point (runtime/distributed.py
        group_of); None without torch.distributed."""
        if self.rank is None:
            return None
        return distributed.group_of(ranks or self.device_ids)

    def _agree_max(self, values: Sequence[float],
                   ranks: Optional[List[int]] = None) -> List[float]:
        """The elementwise maximum of `values` over `ranks` (default the
        current ones; each gives its own). Each of them calls it at the
        same point."""
        ranks = ranks or self.device_ids
        if len(ranks) == 1 or self.rank is None:
            return [float(v) for v in values]
        import torch.distributed as dist

        dev = distributed.device()
        if dev.type != "cuda" or distributed.host_staging():
            dev = torch.device("cpu")
        t = torch.tensor([float(v) for v in values], dtype=torch.float64,
                         device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self._group(ranks))
        return [float(v) for v in t.cpu()]

    # -- checkpointing -----------------------------------------------------
    def _save(self, step: int) -> str:
        path = self._ckpt.save(self.model, step=step)
        self._last_ckpt = (step, path)
        # a fresh checkpoint means sustained good progress since the last
        # restore point: refill the rollback budget (per incident)
        self._rollbacks = 0
        self.events.record(CHECKPOINT, step=step, path=path)
        return path

    def _restore_latest_verified(self, model, cause: Exception) -> tuple:
        """Restore the newest VERIFIED checkpoint into `model` (every rank
        reads and verifies the file and cuts its own shards), falling back
        through torn/corrupt ones. Returns (step, path); wraps total loss
        as RecoveryFailed."""
        try:
            return self._ckpt.restore_latest(model)
        except CheckpointError as ce:
            raise RecoveryFailed(
                f"no restorable checkpoint in {self.checkpoint_dir!r}: "
                f"{ce}") from cause

    def _record_plan_analysis(self, model, step: int) -> None:
        """Plan-sanitizer verdict on a rebuilt model for the event
        stream: compile()'s gate run when it happened, else a fresh
        run."""
        report = getattr(model, "_analysis_report", None)
        if report is None:
            report = model.analyze_plan()
        self.events.record(
            PLAN_ANALYSIS, step=step,
            errors=len(report.errors()), warnings=len(report.warnings()),
            counts=report.counts())

    def _restore_counter(self):
        return REGISTRY.counter(
            "ff_recovery_restore_total",
            "Recovery restores by source (live = zero-disk resharding,"
            " disk = checkpoint)", labels=("source",))

    @staticmethod
    def _validate_tree_match(expected: Dict, got: Dict, what: str,
                             cause: Exception) -> None:
        """The restored/live parameter tree must match the rebuilt
        model's architecture exactly (a non-deterministic builder must
        fail typed, not mis-train)."""
        if expected != got:
            missing = set(expected) - set(got)
            extra = set(got) - set(expected)
            raise RecoveryFailed(
                f"{what} does not match the rebuilt model's parameter"
                f" tree (missing ops: {sorted(missing)}, unexpected ops:"
                f" {sorted(extra)}) — the builder must produce the same"
                " architecture across rebuilds") from cause

    def _restore_validated(self, model, cause: Exception) -> tuple:
        """Restore the newest verified checkpoint into a freshly REBUILT
        `model`, validate the tree and check every shard's placement.
        Returns (ckpt_step, path, restore_ms): the DISK restore core of
        chip-loss recovery and drift re-planning."""
        expected = {name: set(ws) for name, ws in model.params.items()}
        t0 = time.perf_counter()
        with get_tracer().span("elastic.restore", source="disk"):
            ckpt_step, path = self._restore_latest_verified(model, cause)
            self._validate_tree_match(
                expected, {name: set(ws)
                           for name, ws in model.params.items()},
                "checkpoint", cause)
            reshard_params(model)
        self._restore_counter().inc(source="disk")
        return ckpt_step, path, (time.perf_counter() - t0) * 1e3

    # -- zero-disk (live-resharding) restore -------------------------------
    def _poison_live_state(self) -> None:
        """The poison_live_state fault's hook: NaN-rot the live training
        state in place — silent corruption of survivor-resident memory,
        which the zero-disk path's verify_live_tree must catch. The poison
        lands in the optimizer's lr (the step keeps dispatching, every
        later update is garbage); a model without an lr scalar gets its
        first parameter poisoned instead. In place, as real memory rot
        survives a step boundary."""
        m = self.model
        with torch.no_grad():
            if isinstance(m.opt_state, dict) and "lr" in m.opt_state:
                m.opt_state["lr"].fill_(float("nan"))
                return
            for entry in (m.params or {}).values():
                for t in entry.values():
                    t.fill_(float("nan"))
                    return

    @staticmethod
    def _live_tree(model) -> Dict:
        """The whole live training state of this rank (its shards), the
        optimizer's scalars included: what verification reads."""
        return {"params": model.params or {},
                "opt_state": model.opt_state or {},
                "state": model.state or {}}

    def _live_candidate(self, lost_positions: Sequence[int],
                        survivors: List[int]):
        """Decide whether a ZERO-DISK recovery is possible: the old plan's
        placement must leave every shard covered by survivors (FFTA063),
        and the live tree must verify clean on every survivor (agreed over
        the survivors' group). Returns (old_model, old_plan) or None (the
        routing reason recorded), decided BEFORE the rebuild."""
        from ..analysis import record_report, survivor_diagnostics
        from ..analysis.diagnostics import DiagnosticReport
        from ..resharding import flatten_tree, plan_of, verify_live_tree

        if not self.live_resharding:
            return None
        old_model = self.model
        if old_model is None or old_model.params is None:
            return None
        old_plan = plan_of(old_model)
        tree = self._live_tree(old_model)
        leaves = {path: np.ndim(leaf)
                  for path, leaf in flatten_tree(tree).items()}
        diags = survivor_diagnostics(old_plan, leaves, lost_positions)
        if diags:
            record_report(DiagnosticReport(diags, ["survivor_coverage"]))
            self.events.record(
                RECOVERY_LIVE_FALLBACK, step=self.detector.current_step,
                reason="coverage",
                uncovered=[d.message.split(":")[0] for d in diags[:3]],
                n_uncovered=len(diags))
            return None
        bad = verify_live_tree(tree)
        flags = self._agree_max([0.0 if bad is None else 1.0], survivors)
        if flags[0]:
            self.events.record(
                RECOVERY_LIVE_FALLBACK, step=self.detector.current_step,
                reason="verify",
                detail=bad or "another survivor's live tree")
            return None
        return old_model, old_plan

    def _restore_live(self, old_model, old_plan, model,
                      cause: Exception) -> float:
        """Zero-disk restore: redistribute the old model's live shards
        onto the re-planned model's layout among the survivors
        (resharding.redistribute, the FFTA06x-gated, peak-bounded
        schedule) and load them in place. Returns the restore wall ms;
        raises (the caller falls back to disk) on any failure."""
        from ..resharding import (live_tree, load_live_tree, plan_of,
                                  redistribute)
        from ..search.machine_model import make_machine_model

        t0 = time.perf_counter()
        with get_tracer().span("elastic.restore", source="live") as sp:
            self._validate_tree_match(
                {name: set(ws) for name, ws in model.params.items()},
                {name: set(ws)
                 for name, ws in (old_model.params or {}).items()},
                "live tree", cause)
            machine = make_machine_model(model.config,
                                         len(model.config.device_ids))
            peak = self.reshard_peak_bytes or int(
                0.25 * machine.memory_budget_bytes())
            ranks = list(model.config.device_ids)
            result = redistribute(
                live_tree(old_model), old_plan, plan_of(model),
                peak_bytes=peak, machine=machine, ranks=ranks,
                group=self._group(ranks) if len(ranks) > 1 else None)
            load_live_tree(model, result.tree)
            with torch.no_grad():
                for key, val in (old_model.opt_state or {}).items():
                    if not isinstance(val, dict):
                        model.opt_state[key].copy_(val)
            if old_model.state:
                # op state is whole on every rank
                model.load_state(old_model.state)
            model._step_count = old_model._step_count
            wall_ms = (time.perf_counter() - t0) * 1e3
            self.last_reshard = {
                "moves": len(result.schedule.moves),
                "bytes_moved": result.bytes_moved,
                "peak_scratch_bytes": result.observed_peak_bytes,
                "rounds": result.allgather_rounds + result.transfer_rounds,
                "wall_ms": wall_ms}
            sp.set(**{k: v for k, v in self.last_reshard.items()
                      if k != "wall_ms"})
        self._restore_counter().inc(source="live")
        return wall_ms

    def _rearm_drift(self, model) -> Optional[float]:
        """Re-anchor the drift detector (when one is armed) to `model`'s
        freshly priced prediction after ANY re-plan."""
        if self.drift_detector is None:
            return None
        from ..obs.calibration import predicted_step_us

        new_pred = predicted_step_us(model)
        if new_pred:
            self.drift_detector.rearm(new_pred)
        return new_pred

    def _rollback(self) -> int:
        """Watchdog-triggered rollback: reload the last-good (verified)
        checkpoint into the CURRENT model and resume from its step — the
        mesh is intact, only the numerics went bad."""
        self._rollbacks += 1
        if self._rollbacks > self.max_rollbacks:
            raise RecoveryFailed(
                f"rollback budget ({self.max_rollbacks}) exhausted "
                "without an intervening checkpoint of good progress — "
                "the blow-up recurs after every restore, so it is "
                "deterministic (bad hyperparameters or data), and "
                "replaying the same steps cannot heal it")
        err = RuntimeError("watchdog rollback")
        with get_tracer().span("elastic.rollback"):
            ckpt_step, path = self._restore_latest_verified(self.model, err)
        reshard_params(self.model)
        self.events.record(RECOVERY_RESTORE, step=ckpt_step, path=path)
        if self.watchdog is not None:
            self.watchdog.note_rollback(ckpt_step)
        return ckpt_step

    # -- recovery ----------------------------------------------------------
    def _recover(self, exc: TopologyLoss) -> int:
        """Shrink, re-search, restore, resume (on the survivors). Returns
        the step to resume from. One `elastic.recover` span with
        `elastic.replan` / `elastic.restore` nested inside."""
        with get_tracer().span("elastic.recover",
                               lost_chips=sorted(exc.lost_chips)) as sp:
            step = self._recover_inner(exc)
            sp.set(resume_step=step, survivors=len(self.device_ids))
            return step

    def _recover_inner(self, exc: TopologyLoss) -> int:
        self._recoveries += 1
        if self._recoveries > self.max_recoveries:
            raise RecoveryFailed(
                f"recovery budget ({self.max_recoveries}) exhausted") \
                from exc
        lost = set(exc.lost_chips)
        if not lost:
            # real runtime errors classify as topology loss by message
            # pattern but carry no rank ids; "recovering" onto the same
            # rank set would just re-hit the dead one
            raise RecoveryFailed(
                "topology loss did not identify the lost chips; cannot "
                "shrink the mesh — restart from the latest checkpoint "
                f"({self._last_ckpt[1] if self._last_ckpt else 'none'}) "
                "on known-good hardware") from exc
        self.events.record(RECOVERY_START,
                           step=self.detector.current_step,
                           chips=sorted(lost), recovery=self._recoveries)
        unknown = lost - set(self.device_ids)
        if unknown:
            raise RecoveryFailed(
                f"lost chips {sorted(unknown)} are not in the active "
                f"device set {self.device_ids}") from exc
        survivors = [d for d in self.device_ids if d not in lost]
        if not survivors:
            raise RecoveryFailed("no surviving devices") from exc
        if getattr(self.model.executor, "pipeline_plan", None) is not None:
            # nor can the JAX package's: its rebuilt stage mesh holds
            # another split of the layers, and its restore refuses the
            # checkpoint's tree (RecoveryFailed)
            raise RecoveryFailed(
                "a stage (pipeline) mesh cannot be shrunk onto the "
                "survivors: restart from the latest checkpoint on the "
                "full rank set") from exc
        lost_positions = [i for i, d in enumerate(self.device_ids)
                          if d in lost]
        # the survivors' group, made by each of them here, first; every
        # collective from now on runs over it or the rebuilt mesh's
        self._group(survivors)
        live = self._live_candidate(lost_positions, survivors)
        self._topo_spec = shrink_topology_spec(self._topo_spec,
                                               lost_positions)
        spec_path = self._write_spec(f"survivors_{self._recoveries}.json")
        replan_cfg = self._config_for(survivors, spec_path)
        if live is not None:
            from ..resharding import plan_of as _plan_of

            try:
                replan_cfg.replan_live_plan = _plan_of(self.model)
            except Exception:  # noqa: BLE001 — the distance term is
                pass           # optional; the re-plan proceeds without
        t_replan = time.perf_counter()
        with get_tracer().span("elastic.replan", n_devices=len(survivors)):
            model = self.model_builder(replan_cfg)
        replan_ms = (time.perf_counter() - t_replan) * 1e3
        sr = model.search_result
        self.events.record(
            RECOVERY_SEARCH, step=self.detector.current_step,
            n_devices=len(survivors), axes=dict(model.parallel_axes),
            cost_us=(sr.cost_us if sr is not None else None),
            search_ms=(round(sr.search_wall_ms, 3)
                       if sr is not None and sr.search_wall_ms is not None
                       else None),
            cache=(sr.cache_mode if sr is not None else None),
            replan_ms=round(replan_ms, 3))
        self._record_plan_analysis(model, self.detector.current_step)
        resume_step = None
        if live is not None:
            old_model, old_plan = live
            try:
                restore_ms = self._restore_live(old_model, old_plan,
                                                model, exc)
                resume_step = self.detector.current_step
                self.events.record(RECOVERY_RESTORE, step=resume_step,
                                   source="live", path=None,
                                   restore_ms=round(restore_ms, 3))
            except Exception as le:  # noqa: BLE001 — availability first:
                # ANY live-path failure degrades to the disk restore a
                # verified checkpoint still guarantees; recorded in full
                self.events.record(
                    RECOVERY_LIVE_FALLBACK,
                    step=self.detector.current_step, reason="restore",
                    error=type(le).__name__,
                    detail=str(le).splitlines()[0] if str(le) else "")
        if resume_step is None:
            if self._last_ckpt is None:
                raise RecoveryFailed(
                    "no checkpoint to restore from") from exc
            ckpt_step, path, restore_ms = self._restore_validated(model,
                                                                  exc)
            self.events.record(RECOVERY_RESTORE, step=ckpt_step,
                               source="disk", path=path,
                               restore_ms=round(restore_ms, 3))
            resume_step = ckpt_step
        self.model = model
        self.device_ids = survivors
        self.detector.reset_latency()
        self._rearm_drift(model)
        self.events.record(RECOVERY_DONE, step=resume_step,
                           n_devices=len(survivors))
        self._preplan_anticipated()
        return resume_step

    # -- drift-triggered re-plan -------------------------------------------
    def _replan_for_drift(self, step: int) -> int:
        """Budgeted calibration-drift re-plan: refit (when a
        `drift_refit` hook is given), re-search on the SAME ranks with the
        fitted profile overlaid, restore the newest verified checkpoint
        into the re-planned model, and resume from its step."""
        self._drift_replans += 1
        det = self.drift_detector
        measured = det.measured_step_us if det is not None else None
        if det is not None:
            det.note_replan()
        with get_tracer().span("refit.replan", step=step,
                               replan=self._drift_replans) as sp:
            if self.drift_refit is not None and measured:
                self._fitted_profile_path = self.drift_refit(
                    self.model, measured)
                self.events.record(DRIFT_REFIT, step=step,
                                   profile=self._fitted_profile_path)
            spec_path = self._write_spec(
                f"replan_{self._drift_replans}.json")
            replan_cfg = self._config_for(self.device_ids, spec_path)
            try:
                from ..resharding import plan_of as _plan_of

                replan_cfg.replan_live_plan = _plan_of(self.model)
            except Exception:  # noqa: BLE001 — optional term
                pass
            model = self.model_builder(replan_cfg)
            sr = model.search_result
            if sr is not None:
                self.events.record(
                    DRIFT_SEARCH, step=step,
                    n_devices=len(self.device_ids),
                    axes=dict(model.parallel_axes), cost_us=sr.cost_us,
                    search_ms=(round(sr.search_wall_ms, 3)
                               if sr.search_wall_ms is not None else None),
                    cache=sr.cache_mode)
            self._record_plan_analysis(model, step)
            ckpt_step, path, _restore_ms = self._restore_validated(
                model, RuntimeError("drift replan"))
            self.model = model
            new_pred = self._rearm_drift(model)
            self.events.record(
                DRIFT_REPLAN, step=step, resume_step=ckpt_step,
                predicted_step_us=new_pred, path=path)
            sp.set(resume_step=ckpt_step, predicted_step_us=new_pred)
        REGISTRY.counter(
            "ff_replan_total",
            "Calibration-drift-triggered budgeted re-plans").inc()
        self._preplan_anticipated()
        return ckpt_step

    # -- training ----------------------------------------------------------
    def fit(self, x, y, steps: Optional[int] = None, epochs: int = 1,
            batch_size: Optional[int] = None,
            verbose: bool = False) -> List[Dict[str, float]]:
        """Train for `steps` optimizer steps (or epochs * n//bs when steps
        is None), surviving scripted/real failures. Batches cycle through
        (x, y); every rank passes the whole batch and trains on its
        slice. Returns per-step {"step", "loss", ...metric} records for
        the steps that committed (a step rolled back by a recovery appears
        once, from its post-recovery execution; a step the watchdog
        skipped never commits and is absent). On a rank that is lost the
        call returns at the loss with the steps committed before it, and
        `departed` records the step and the lost ranks."""
        if isinstance(x, np.ndarray):
            x = [x]
        model = self.model
        bs = batch_size or model.config.batch_size
        n = x[0].shape[0]
        spe = n // bs
        if spe < 1:
            raise ValueError(f"dataset has {n} samples < batch size {bs}")
        total = steps if steps is not None else spe * epochs
        committed: Dict[int, Dict[str, float]] = {}
        self._save(0)  # recovery needs a restore point before any fault
        step = 0
        while step < total:
            model = self.model
            self.detector.current_step = step
            it = step % spe
            lo, hi = it * bs, (it + 1) * bs
            inputs, label = model._prep_step_batch(x, y, lo, hi)
            op_state = _copy_op_state(model)
            t_step0 = time.perf_counter()
            try:
                # into temporaries: nothing is applied until the verdict
                grads, mvals = model._elastic_step(inputs, label)
            except TopologyLoss as exc:
                get_tracer().instant("elastic.detect", step=step,
                                     lost_chips=sorted(exc.lost_chips))
                if self.rank is not None and self.rank in exc.lost_chips:
                    # this rank is the lost chip: it leaves now and takes
                    # part in nothing after the loss
                    self.departed = {"step": step,
                                     "lost_chips": sorted(exc.lost_chips)}
                    return [committed[i] for i in sorted(committed)]
                resume = self._recover(exc)
                get_tracer().instant("elastic.resume", step=resume)
                step = resume
                continue
            rec = {k: float(v) for k, v in mvals.items()}
            # the float() conversions sync the device, so this wall covers
            # the whole step; on a mesh the slowest rank's
            step_wall_us = (time.perf_counter() - t_step0) * 1e6
            injector = self.detector.injector
            if injector is not None and injector.take_nan_step(step):
                rec["loss"] = float("nan")
            if self.watchdog is not None and "loss" in rec:
                verdict = self.watchdog.check(step, rec["loss"])
            else:
                verdict = OK
            if verdict in (ROLLBACK, SKIP):
                # the bad update never commits: take back the walk's op
                # state writes; weights and optimizer state were untouched
                _restore_op_state(model, op_state)
            if verdict == ROLLBACK:
                step = self._rollback()
                continue
            if verdict == SKIP:
                step += 1
                continue
            model._commit_step(grads)
            del grads
            rec["step"] = step
            committed[step] = rec
            if verbose and self._writes():
                print(f"[elastic] step {step}: "
                      + " ".join(f"{k}={v:.4f}" for k, v in rec.items()
                                 if k != "step"))
            step += 1
            if step % self.checkpoint_every == 0 and step < total:
                self._save(step)
            if self.drift_detector is not None and step < total:
                step_wall_us = self._agree_max([step_wall_us])[0]
                if self.drift_detector.observe(step_wall_us):
                    det = self.drift_detector
                    self.events.record(DRIFT_BREACH, step=step,
                                       drift=det.drift,
                                       measured_step_us=det.measured_step_us)
                    step = self._replan_for_drift(step)
                    continue
        return [committed[i] for i in sorted(committed) if i < total]


def _copy_op_state(model) -> Dict:
    """A copy of the model's op state (batch norm's running statistics),
    which a training walk writes in place; {} for a graph without any."""
    return {op: {v: t.detach().clone() for v, t in ws.items()}
            for op, ws in (model.state or {}).items()}


def _restore_op_state(model, saved: Dict) -> None:
    if not saved:
        return
    live = model.state
    with torch.no_grad():
        for op, ws in saved.items():
            for v, t in ws.items():
                live[op][v].copy_(t)


def reshard_params(model) -> None:
    """Check that the restored training state sits where the model's plan
    puts it (JAX `reshard_params` re-places host arrays on the new mesh;
    the port's restores already write each rank's shard in place, so
    here it is the check that they did): every weight, optimizer tensor
    and op-state tensor on the model's device — for a single survivor
    that rank's own device — and each weight and moment of this rank
    shaped as its shard on the mesh. Raises RecoveryFailed otherwise."""
    dev = model.device
    shards = {op.name: op.shards for op in model.ops}
    trees = {"params": model.params or {}}
    for k, v in (model.opt_state or {}).items():
        trees[f"opt_state/{k}"] = v if isinstance(v, dict) else {"": {"": v}}
    trees["state"] = model.state or {}

    def same_device(t) -> bool:
        return t.device.type == dev.type and (
            dev.index is None or t.device.index == dev.index)

    for group, tree in trees.items():
        for op, ws in tree.items():
            for w, t in ws.items():
                if not same_device(t):
                    raise RecoveryFailed(
                        f"{group}/{op}/{w} is on {t.device}, the model on "
                        f"{dev}")
                pt = shards.get(op, {}).get(w)
                if group == "state" or pt is None:
                    continue
                want = tuple(d.size // d.degree for d in pt.dims)
                if tuple(t.shape) != want:
                    raise RecoveryFailed(
                        f"{group}/{op}/{w} has shape {tuple(t.shape)}, its "
                        f"shard on this rank is {want}")
