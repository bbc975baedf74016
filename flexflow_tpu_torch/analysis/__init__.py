"""Plan sanitizer: static analysis over the PCG + strategy that rejects
illegal plans before any weight is drawn or step runs (the port's copy
of flexflow_tpu/analysis/; the resharding checks read the port's
resharding/ planner).

Public surface:
 - Diagnostic / DiagnosticReport / PlanAnalysisError / Severity — typed
   findings with stable FFTA0xx codes (docs/analysis.md catalogues them);
 - analyze_plan / check_plan — the pass pipeline over
   (Graph, strategies, MachineModel, config);
 - factorization_diagnostics — the cheap per-candidate check the Unity
   search prunes with;
 - diagnostic_counters — process-wide per-code counters, exported on the
   serving /metrics endpoint;
 - plan_memory_bytes — the memory model behind the FFTA010/011 fit gate,
   also used to size the serving KV-cache pool against HBM
   (serving/sched/kvpool.py);
 - check_redistribution / redistribution_diagnostics /
   survivor_diagnostics — the FFTA06x gate over live-resharding
   schedules (resharding/) and the shard-coverage check the elastic
   coordinator consults before a zero-disk recovery;
 - AbstractLayout / ShardingFlowInterpreter / CollectiveEvent /
   verify_grad_sync_program / verify_reshard_program — the FFTA09x
   sharding-flow verifier (interp.py): abstract interpretation of a
   plan over the PCG plus deadlock/uniformity model checking of the
   executed collective program (docs/analysis.md "Verifier").
"""
from .diagnostics import (CODE_CATALOG, Diagnostic, DiagnosticReport,
                          PlanAnalysisError, Severity, diagnostic_counters,
                          make_diag, record_report, reset_counters)
from .interp import (AbstractLayout, CollectiveEvent,
                     ShardingFlowInterpreter, build_grad_sync_program,
                     build_reshard_program, check_event_partitions,
                     check_program_uniformity, gradient_state,
                     participant_programs, pass_sharding_flow,
                     semantic_reduction_diagnostics,
                     verify_grad_sync_program, verify_reshard_program)
from .passes import (AnalysisContext, default_strategies_for,
                     factorization_diagnostics, plan_memory_bytes,
                     redistribution_diagnostics, survivor_diagnostics)
from .pipeline import (ALL_PASSES, CHEAP_PASSES, PASS_REGISTRY,
                       analyze_plan, check_plan, check_redistribution)

__all__ = [
    "ALL_PASSES",
    "AbstractLayout",
    "AnalysisContext",
    "CHEAP_PASSES",
    "CODE_CATALOG",
    "CollectiveEvent",
    "Diagnostic",
    "DiagnosticReport",
    "PASS_REGISTRY",
    "PlanAnalysisError",
    "Severity",
    "ShardingFlowInterpreter",
    "analyze_plan",
    "build_grad_sync_program",
    "build_reshard_program",
    "check_event_partitions",
    "check_plan",
    "check_program_uniformity",
    "check_redistribution",
    "default_strategies_for",
    "diagnostic_counters",
    "factorization_diagnostics",
    "gradient_state",
    "make_diag",
    "participant_programs",
    "pass_sharding_flow",
    "plan_memory_bytes",
    "record_report",
    "redistribution_diagnostics",
    "reset_counters",
    "semantic_reduction_diagnostics",
    "survivor_diagnostics",
    "verify_grad_sync_program",
    "verify_reshard_program",
]
