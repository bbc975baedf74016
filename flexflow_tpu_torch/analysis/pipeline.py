"""Pass pipeline: run the plan sanitizer over (Graph, strategies, machine).

Three call sites:
 - the Unity search prunes mesh factorizations that fail the per-candidate
   check (search/unity.py via `factorization_diagnostics` — cheaper still
   than a CHEAP_PASSES pipeline run, since a factorization is checkable
   without per-op strategies);
 - FFModel.compile()/fit() and the elastic re-plan path run ALL_PASSES as a
   pre-flight gate — errors raise PlanAnalysisError with the diagnostic
   list, warnings go to the log and the process-wide counters the serving
   /metrics endpoint exports;
 - `python -m flexflow_tpu_torch analyze` (analysis/cli.py) loads an
   exported strategy JSON and prints the report.

The port's copy of flexflow_tpu/analysis/pipeline.py.
"""
from __future__ import annotations

import logging
from typing import Dict, Optional, Sequence

from ..core.graph import Graph
from .diagnostics import DiagnosticReport, PlanAnalysisError, record_report
from .interp import pass_sharding_flow
from .passes import (AnalysisContext, default_strategies_for,
                     pass_collectives, pass_divisibility, pass_donation,
                     pass_hygiene, pass_memory_fit, pass_moe,
                     pass_tier_collectives)

_log = logging.getLogger("flexflow_tpu_torch.analysis")

PASS_REGISTRY = {
    "divisibility": pass_divisibility,
    "memory": pass_memory_fit,
    "collectives": pass_collectives,
    "tiers": pass_tier_collectives,
    "donation": pass_donation,
    "hygiene": pass_hygiene,
    "moe": pass_moe,
    "flow": pass_sharding_flow,
}

# the machine-model-free subset: a preset for analyze_plan(passes=...)
# callers that want a quick structural check without a MachineModel.
# "flow" is the sharding-flow verifier's layout-only subset (FFTA093/094
# edge composition + FFTA090 discharge when an executed schedule is in
# the context) — the full collective-program model checker runs where a
# schedule exists (plan_grad_sync_lowering / check_redistribution)
CHEAP_PASSES = ("divisibility", "collectives", "hygiene", "moe", "flow")
ALL_PASSES = tuple(PASS_REGISTRY)


def analyze_plan(graph: Graph,
                 strategies: Optional[Dict[int, object]] = None,
                 machine=None, config=None,
                 batch_size: Optional[int] = None,
                 n_devices: Optional[int] = None,
                 mesh_axes: Optional[Dict[str, int]] = None,
                 final_guid: Optional[int] = None,
                 reduction_strategies: Optional[Dict[str, dict]] = None,
                 executed_reductions: Optional[Dict[str, str]] = None,
                 executed_buckets: Optional[Dict[str, Optional[int]]] = None,
                 passes: Optional[Sequence[str]] = None) -> DiagnosticReport:
    """Run the pass pipeline; returns the DiagnosticReport (never raises).

    strategies=None with mesh_axes given analyzes the degrees a mesh-wide
    default assignment would realize (mirroring FFModel._assign_strategy),
    so a no-search compile is analyzable too."""
    if strategies is None and mesh_axes:
        strategies = default_strategies_for(graph, mesh_axes, batch_size)
    ctx = AnalysisContext(graph=graph, strategies=strategies,
                          mesh_axes=mesh_axes, machine=machine,
                          config=config, batch_size=batch_size,
                          n_devices=n_devices, final_guid=final_guid,
                          reduction_strategies=reduction_strategies,
                          executed_reductions=executed_reductions,
                          executed_buckets=executed_buckets)
    names = list(passes) if passes is not None else list(ALL_PASSES)
    report = DiagnosticReport(passes_run=names)
    for name in names:
        report.extend(PASS_REGISTRY[name](ctx))
    return report


def check_plan(graph: Graph, record: bool = True,
               **kwargs) -> DiagnosticReport:
    """analyze_plan + the gate semantics: warnings are logged, counters
    updated, and errors raise PlanAnalysisError carrying the report."""
    report = analyze_plan(graph, **kwargs)
    if record:
        record_report(report)
    for d in report.warnings():
        _log.warning("%s", d.format())
    if report.errors():
        raise PlanAnalysisError(report)
    return report


def check_redistribution(schedule, machine=None,
                         record: bool = True) -> DiagnosticReport:
    """The FFTA06x gate for live-resharding schedules
    (resharding/plan.py): redistribution_diagnostics with check_plan's
    gate semantics — warnings logged and counted, errors raise
    PlanAnalysisError carrying the report. Every schedule the elastic
    coordinator or the serving resize path is about to execute goes
    through here first. The sharding-flow verifier's program checker
    rides along (FFTA091/092, docs/analysis.md "Verifier"): the
    schedule's collective rounds must be SPMD-uniform and deadlock-free
    as a per-participant program, not just legal move-by-move."""
    from .interp import verify_reshard_program
    from .passes import redistribution_diagnostics

    report = DiagnosticReport(passes_run=["redistribution", "flow"])
    report.extend(redistribution_diagnostics(schedule, machine=machine))
    report.extend(verify_reshard_program(schedule))
    if record:
        record_report(report)
    for d in report.warnings():
        _log.warning("%s", d.format())
    if report.errors():
        raise PlanAnalysisError(report)
    return report
