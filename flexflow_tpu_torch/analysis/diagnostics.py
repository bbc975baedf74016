"""Typed diagnostics for the plan sanitizer.

Every problem the static analysis passes find is a `Diagnostic` with a
stable `FFTA0xx` code, a severity, the op it anchors to, and a fix hint.
Stability contract: codes are append-only — a released code never changes
meaning, so scripts can grep logs and CI can assert exact codes
(docs/analysis.md catalogues them all with triggering examples).

The analog in the reference codebase is the scattered `assert`/`fprintf`
legality checking inside substitution.cc and graph.cc; here legality is a
first-class analyzable property (the position of "Synthesizing Optimal
Parallelism Placement and Reduction Strategies on Hierarchical Systems",
PAPERS.md, and the array-redistribution work arXiv:2112.01075).

The port's copy of flexflow_tpu/analysis/diagnostics.py, whole: the same
codes and texts, counted on the port's registry (obs/registry.py) as
`ff_plan_diagnostics_total`.
"""
from __future__ import annotations

import dataclasses
import enum
import json
from typing import Dict, List, Optional, Sequence


class Severity(enum.Enum):
    ERROR = "error"      # the plan is illegal: reject before XLA sees it
    WARNING = "warning"  # legal but degraded/suspicious: log, don't reject
    INFO = "info"


# code -> (default severity, one-line title). Append-only.
CODE_CATALOG: Dict[str, tuple] = {
    # -- divisibility / degree (FFTA00x) --
    "FFTA001": (Severity.ERROR,
                "partition degree does not divide the dimension it shards"),
    "FFTA002": (Severity.WARNING,
                "requested degree cannot be realized; op degrades to"
                " replicated"),
    "FFTA003": (Severity.ERROR,
                "op strategy degree exceeds the device count"),
    "FFTA004": (Severity.ERROR,
                "parallel axis unusable by this graph/config"),
    # -- memory fit (FFTA01x) --
    "FFTA010": (Severity.ERROR, "per-chip memory exceeds HBM capacity"),
    "FFTA011": (Severity.WARNING, "per-chip memory above 85% of HBM"),
    # -- collective legality (FFTA02x) --
    "FFTA020": (Severity.ERROR,
                "illegal reduction (row-parallel) strategy"),
    "FFTA021": (Severity.ERROR,
                "mesh-axis degree conflict across ops"),
    "FFTA022": (Severity.WARNING,
                "reshard ping-pong (gather then re-partition) on a chain"),
    "FFTA023": (Severity.ERROR,
                "mesh axes need more devices than available"),
    # -- aliasing / donation (FFTA03x) --
    "FFTA030": (Severity.WARNING,
                "buffer donation hazard under the elastic retry wrapper"),
    # -- graph hygiene (FFTA04x) --
    "FFTA040": (Severity.ERROR,
                "op consumes a tensor whose producer left the graph"),
    "FFTA041": (Severity.WARNING,
                "stale tensor_aliases chain (dangling replacement)"),
    "FFTA042": (Severity.WARNING,
                "op unreachable from the final output"),
    "FFTA043": (Severity.WARNING,
                "mixed input dtypes at an elementwise op boundary"),
    # -- strategy files (FFTA05x) --
    "FFTA050": (Severity.ERROR, "malformed strategy-file entry"),
    "FFTA051": (Severity.WARNING, "strategy entry matches no op"),
    "FFTA052": (Severity.WARNING, "strategy provenance mismatch"),
    # -- live resharding (FFTA06x, resharding/) --
    "FFTA060": (Severity.ERROR,
                "redistribution collective illegal on the target mesh"),
    "FFTA061": (Severity.ERROR,
                "redistribution peak scratch exceeds per-chip HBM or the"
                " requested bound"),
    "FFTA062": (Severity.WARNING,
                "redistribution peak scratch above 85% of per-chip HBM"),
    "FFTA063": (Severity.ERROR,
                "live shards unrecoverable from the surviving devices"),
    # -- cross-tier collective legality (FFTA07x, hierarchical machines,
    # docs/machine.md) --
    "FFTA070": (Severity.ERROR,
                "collective spans a tier boundary without a"
                " tier-decomposable reduction strategy"),
    "FFTA071": (Severity.WARNING,
                "per-step collective pushes heavy traffic across the"
                " outermost (DCN) tier"),
    "FFTA072": (Severity.ERROR,
                "explicit collective lowering diverges from the priced"
                " reduction plan (dropped or renamed sync)"),
    # -- mixture-of-experts legality (FFTA08x, docs/moe.md) --
    "FFTA080": (Severity.WARNING,
                "degenerate expert capacity: the unclamped rounding falls"
                " below top-k (moe_capacity raises it silently)"),
    "FFTA081": (Severity.ERROR,
                "expert-parallel degree does not divide the expert count"),
    "FFTA082": (Severity.ERROR,
                "load-balance loss requested without the full gate"
                " distribution wired (lambda_bal needs full_gate)"),
    "FFTA083": (Severity.WARNING,
                "router computed in a reduced-precision dtype; gate"
                " probabilities should stay float32"),
    "FFTA084": (Severity.WARNING,
                "capacity factor below 1.0 drops tokens even under a"
                " perfectly balanced router"),
    "FFTA085": (Severity.ERROR,
                "expert-parallel group spans the slow inter-pod tier:"
                " the routing all_to_all must stay pod-resident"),
    # -- sharding-flow verifier (FFTA09x, analysis/interp.py) --
    "FFTA090": (Severity.ERROR,
                "unreduced gradient use: a pending partial sum is never"
                " discharged by the executed collective schedule"),
    "FFTA091": (Severity.ERROR,
                "mismatched or non-covering axis_index_groups: participants"
                " of one group issue different collective sequences"),
    "FFTA092": (Severity.ERROR,
                "cross-group ordering cycle in the interleaved collective"
                " schedule (deadlock)"),
    "FFTA093": (Severity.ERROR,
                "layout-incompatible edge: the consumer's layout does not"
                " compose with the producer tensor it consumes"),
    "FFTA094": (Severity.ERROR,
                "donation/alias overwrite of a tensor still live in the"
                " abstract state"),
}


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding of a static analysis pass."""

    code: str
    message: str
    severity: Severity = Severity.ERROR
    op_guid: Optional[int] = None
    op_name: Optional[str] = None
    hint: Optional[str] = None

    def format(self) -> str:
        where = f" [{self.op_name or self.op_guid}]" if (
            self.op_name or self.op_guid is not None) else ""
        hint = f" (hint: {self.hint})" if self.hint else ""
        return f"{self.code} {self.severity.value}{where}: {self.message}{hint}"

    def to_dict(self) -> Dict:
        return {
            "code": self.code,
            "severity": self.severity.value,
            "message": self.message,
            "op_guid": self.op_guid,
            "op_name": self.op_name,
            "hint": self.hint,
        }


def make_diag(code: str, message: str, op=None,
              hint: Optional[str] = None,
              severity: Optional[Severity] = None) -> Diagnostic:
    """Diagnostic with the catalog's default severity for `code`."""
    if severity is None:
        severity = CODE_CATALOG[code][0]
    return Diagnostic(code=code, message=message, severity=severity,
                      op_guid=getattr(op, "guid", None),
                      op_name=getattr(op, "name", None), hint=hint)


class DiagnosticReport:
    """Result of a pass pipeline run: the diagnostics plus which passes ran."""

    def __init__(self, diagnostics: Sequence[Diagnostic] = (),
                 passes_run: Sequence[str] = ()):
        self.diagnostics: List[Diagnostic] = list(diagnostics)
        self.passes_run: List[str] = list(passes_run)

    def extend(self, diags: Sequence[Diagnostic]) -> None:
        self.diagnostics.extend(diags)

    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity is Severity.ERROR]

    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity is Severity.WARNING]

    def by_code(self, code: str) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.code == code]

    @property
    def ok(self) -> bool:
        """True when the plan is legal (warnings allowed)."""
        return not self.errors()

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for d in self.diagnostics:
            out[d.code] = out.get(d.code, 0) + 1
        return out

    def format(self) -> str:
        lines = [d.format() for d in self.diagnostics]
        lines.append(
            f"plan analysis: {len(self.errors())} error(s), "
            f"{len(self.warnings())} warning(s) "
            f"({', '.join(self.passes_run) or 'no passes run'})")
        return "\n".join(lines)

    def to_json(self) -> str:
        """Machine-readable report with a STABLE schema (consumed by the
        CI verify-plans job instead of grepping stdout). Schema contract,
        append-only like the code catalog: bump "schema" only when an
        existing key changes meaning — new keys may appear at any time.
        v1 keys: schema, ok, errors, warnings, counts, passes_run,
        diagnostics[{code, severity, message, op_guid, op_name, hint}]."""
        return json.dumps({
            "schema": 1,
            "ok": self.ok,
            "errors": len(self.errors()),
            "warnings": len(self.warnings()),
            "counts": self.counts(),
            "passes_run": self.passes_run,
            "diagnostics": [d.to_dict() for d in self.diagnostics],
        }, indent=2)

    def __len__(self) -> int:
        return len(self.diagnostics)


class PlanAnalysisError(RuntimeError):
    """A plan failed static analysis; carries the full diagnostic list."""

    def __init__(self, report: DiagnosticReport):
        self.report = report
        super().__init__("plan rejected by static analysis:\n"
                         + report.format())


# -- process-wide counters (exported on the serving /metrics endpoint) ----
# Backed by the obs metrics registry (obs/registry.py) as
# ff_plan_diagnostics_total{code=...}; the accessors below are the
# pre-registry API, kept as thin shims over the shared family.
def _diag_counter():
    from ..obs.registry import REGISTRY

    return REGISTRY.counter(
        "ff_plan_diagnostics_total",
        "Plan-sanitizer diagnostics by FFTA code", labels=("code",))


def record_report(report: DiagnosticReport) -> None:
    """Fold a report into the process-wide per-code counters."""
    c = _diag_counter()
    for code, n in report.counts().items():
        c.inc(n, code=code)


def diagnostic_counters() -> Dict[str, int]:
    return {key[0]: int(v) for key, v in _diag_counter().items() if v}


def reset_counters() -> None:
    _diag_counter().reset()
