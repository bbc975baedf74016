"""`python -m flexflow_tpu_torch analyze` — static plan analysis from the
shell (counterpart of flexflow_tpu/analysis/cli.py).

Loads a zoo model's PCG plus (optionally) an exported strategy JSON
(search/unity.py export_strategy) and prints the plan sanitizer's
diagnostic report. Exit status 0 when the plan is legal (warnings
allowed), 1 when any error-severity diagnostic fires, 2 on a flag that
is missing its value.

    python -m flexflow_tpu_torch analyze --model bert --chips 8 \
        --strategy examples/strategies/bert_8dev.json

Flags: --model NAME (zoo model, default mnist_mlp), --strategy FILE,
--json (machine-readable report), --device cuda|cpu (default cuda: the
model is built where it would train), plus every standard FFConfig flag
(--chips N sizes the analyzed device pool and machine model;
--machine-spec FILE loads a machine spec — a hierarchical one when the
JSON carries a "tiers" list, which arms the FFTA07x cross-tier legality
pass):

    python -m flexflow_tpu_torch analyze --model mnist_mlp --chips 16 \
        --machine-spec examples/machines/multipod_2x8.json
"""
from __future__ import annotations

import sys
from typing import List, Optional

from .diagnostics import PlanAnalysisError, record_report


def run_analyze(argv: Optional[List[str]] = None) -> int:
    from ..__main__ import _synthetic
    from ..config import FFConfig, take_device
    from ..core.graph import Graph
    from ..search.machine_model import make_machine_model
    from .pipeline import analyze_plan

    argv = list(sys.argv[1:] if argv is None else argv)
    device = take_device(argv)
    model_name = "mnist_mlp"
    strategy_path = None
    as_json = False
    if "--model" in argv:
        i = argv.index("--model")
        if i + 1 >= len(argv):
            print("analyze: --model needs a value", file=sys.stderr)
            return 2
        model_name = argv[i + 1]
        del argv[i:i + 2]
    if "--strategy" in argv:
        i = argv.index("--strategy")
        if i + 1 >= len(argv):
            print("analyze: --strategy needs a value", file=sys.stderr)
            return 2
        strategy_path = argv[i + 1]
        del argv[i:i + 2]
    if "--json" in argv:
        as_json = True
        argv.remove("--json")

    config = FFConfig(device=device)
    rest = config.parse_args(argv)
    if rest:
        print(f"warning: unrecognized flags {rest}", file=sys.stderr)
    n_dev = config.total_devices

    model, _, _ = _synthetic(model_name, config)
    graph = Graph(model.ops)

    strategies = None
    reductions = None
    provenance_diags = []
    if strategy_path is not None:
        # the one shared preamble compile()'s --import path uses, so the
        # CLI's verdict matches what compile() will actually do (the file
        # is read ONCE here and the parsed spec threaded through)
        import json as _json

        from ..search.plan_cache import (graph_fingerprint,
                                         machine_fingerprint)
        from ..search.unity import rewrite_and_import_strategy
        from .diagnostics import make_diag

        with open(strategy_path) as f:
            spec = _json.load(f)
        # provenance check (docs/search.md): the file records which
        # graph/machine produced it — a mismatch is the "silently
        # applied to a different graph" hazard, surfaced in THIS
        # report (the import preamble warns and counts it too)
        prov = spec.get("provenance") or {}
        if prov.get("graph_hash"):
            here = graph_fingerprint(graph)
            if prov["graph_hash"] != here:
                provenance_diags.append(make_diag(
                    "FFTA052",
                    f"strategy {strategy_path!r} was produced for a"
                    f" different graph (recorded"
                    f" {prov['graph_hash'][:12]}..., this model"
                    f" {here[:12]}...)",
                    hint="re-export from the current model"))
        if prov.get("machine_hash"):
            here_m = machine_fingerprint(
                make_machine_model(config, n_dev))
            if prov["machine_hash"] != here_m:
                provenance_diags.append(make_diag(
                    "FFTA052",
                    f"strategy {strategy_path!r} was priced on a"
                    f" different machine (recorded"
                    f" {prov['machine_hash'][:12]}..., this machine"
                    f" {here_m[:12]}...)",
                    hint="re-search under this --machine-spec/--chips"))
        try:
            # check_provenance=False: the CLI ran its own check above so
            # the mismatch lands in THIS report once, not twice in the
            # process-wide counters
            strategies, axes = rewrite_and_import_strategy(
                graph, config, strategy_path, spec=spec,
                check_provenance=False)
        except PlanAnalysisError as exc:
            print(exc.report.to_json() if as_json else exc.report.format())
            return 1
        # a tiered search exports its per-tier reduction decomposition
        # ("reductions", docs/machine.md): analyze the plan as pinned.
        # Files without it are analyzed the way compile() treats them —
        # the machine re-synthesizes (reductions=None), so a flat-model
        # export is not spuriously rejected on a hierarchical spec.
        reductions = spec.get("reductions")
    else:
        axes = {"data": n_dev} if n_dev > 1 else {}

    final = graph.topo_order()[-1] if graph.ops else None
    report = analyze_plan(
        graph, strategies=strategies,
        machine=make_machine_model(config, n_dev), config=config,
        batch_size=config.batch_size, n_devices=n_dev, mesh_axes=axes,
        reduction_strategies=reductions,
        final_guid=final.guid if final is not None else None)
    report.extend(provenance_diags)
    record_report(report)
    # --json keeps stdout PURE machine-readable (the stable schema in
    # DiagnosticReport.to_json, consumed by the CI verify-plans job);
    # the human verdict line moves to stderr
    print(report.to_json() if as_json else report.format())
    if report.ok:
        print(f"plan OK: {model_name} on {n_dev} device(s)"
              + (f" under {strategy_path}" if strategy_path else ""),
              file=sys.stderr if as_json else sys.stdout)
        return 0
    return 1
