"""MCMC strategy search (the MLSys'19 legacy path).

Reference: FFModel::mcmc_optimize (src/runtime/model.cc:3286-3358): start
from data-parallel, rewrite a random op's ParallelConfig (model.cc:3261),
cost with Simulator::simulate_runtime, Metropolis-accept with
exp(-alpha * diff); optional gradient-propagation of configs to neighbors
(FF_USE_PROPAGATE, model.cc:3181).

The port's copy of flexflow_tpu/search/mcmc.py: the stdlib's
random.Random, so a seed walks the same proposals in both packages.
"""
from __future__ import annotations

import math
import random
from typing import Dict, Optional

from ..core.graph import Graph
from .machine_model import MachineModel
from .simulator import OpStrategy, Simulator
from .unity import SearchResult, _divisor_pairs, mesh_axes_for, valid_strategies


def mcmc_optimize(
    graph: Graph,
    config,
    simulator: Simulator,
    batch_size: int,
    dp: int,
    tp: int,
    budget: Optional[int] = None,
    alpha: float = 0.05,
    seed: int = 0,
    propagate: bool = False,
) -> Dict[int, OpStrategy]:
    """Simulated annealing over per-op strategies under a fixed (dp, tp) mesh."""
    rng = random.Random(seed)
    ops = list(graph.ops.values())
    # start from pure data parallelism (reference: model.cc:3296)
    current = {op.guid: OpStrategy(dp=dp if batch_size % dp == 0 else 1, tp=1)
               for op in ops}
    current_cost = simulator.simulate(graph, current)
    best, best_cost = dict(current), current_cost
    budget = budget if budget is not None else max(1, config.search_budget)

    for it in range(budget):
        op = rng.choice(ops)
        menu = valid_strategies(op, dp, tp, batch_size, config)
        if not menu:
            continue
        cand = dict(current)
        new_s = rng.choice(menu)
        cand[op.guid] = new_s
        if propagate:
            # copy the new strategy to same-typed neighbors (reference:
            # FF_USE_PROPAGATE random-depth propagation, model.cc:3181)
            for nb in graph.successors(op) + graph.predecessors(op):
                if nb.op_type == op.op_type and rng.random() < 0.5:
                    if new_s in valid_strategies(nb, dp, tp, batch_size, config):
                        cand[nb.guid] = new_s
        cost = simulator.simulate(graph, cand)
        diff = cost - current_cost
        if diff < 0 or rng.random() < math.exp(-alpha * diff):
            current, current_cost = cand, cost
            if cost < best_cost:
                best, best_cost = dict(cand), cost
    return best


def mcmc_search(graph: Graph, config, machine: MachineModel,
                batch_size: int, n_devices: int,
                simulator: Optional[Simulator] = None) -> SearchResult:
    """User entry for the MCMC strategy search (--strategy-search mcmc;
    reference: FFModel::mcmc_optimize, model.cc:3286-3358, whose result is
    exported/imported through the same strategy-file path, model.cc:3609).

    The reference anneals machine-view proposals under its fixed device
    pool; here the mesh factorization is the outer loop — each (dp, tp)
    pair gets an equal share of the iteration budget, and the best
    annealed strategy across factorizations wins (costed by the same
    Simulator — measured costs auto-enabled on real accelerators exactly
    as unity_optimize does — so the two searches are comparable)."""
    from ..obs.tracing import get_tracer

    with get_tracer().span("search", algo="mcmc", n_devices=n_devices):
        return _mcmc_search_inner(graph, config, machine, batch_size,
                                  n_devices, simulator)


def _mcmc_search_inner(graph: Graph, config, machine: MachineModel,
                       batch_size: int, n_devices: int,
                       simulator: Optional[Simulator] = None
                       ) -> SearchResult:
    from .substitution import (
        apply_substitutions,
        load_rule_spec,
        rule_set_from_spec,
    )
    from .unity import _want_measured

    log = []
    # the greedy always-beneficial rewrite pass runs regardless of search
    # algorithm (reference: substitutions precede strategy search)
    spec, is_taso = load_rule_spec(config.substitution_json_path)
    applied = apply_substitutions(graph, rule_set_from_spec(spec, is_taso))
    if applied:
        log.append(f"substitutions: {applied}")
    if simulator is None and _want_measured(config):
        from .simulator import get_op_cost_cache

        simulator = Simulator(machine, config,
                              measured=get_op_cost_cache(config))
    sim = simulator or Simulator(machine, config)
    budget = (config.mcmc_budget if config.mcmc_budget is not None
              else max(1, config.search_budget))
    pairs = [(dp, tp) for dp, tp in _divisor_pairs(n_devices)
             if batch_size % dp == 0]
    if config.only_data_parallel:
        pairs = [(n_devices, 1)]
    if not pairs:
        raise ValueError("no feasible (dp, tp) mesh factorization")
    share = max(1, budget // len(pairs))
    best = None
    for dp, tp in pairs:
        strategies = mcmc_optimize(
            graph, config, sim, batch_size, dp, tp, budget=share,
            alpha=0.05, seed=config.seed, propagate=config.mcmc_propagate)
        cost = sim.simulate(graph, strategies)
        mem = sim.memory_bytes(graph, strategies)
        axes = mesh_axes_for(dp, tp, strategies)
        log.append(f"mcmc: dp={dp} tp={tp} cost={cost:.1f}us "
                   f"mem={mem/1e9:.2f}GB")
        r = SearchResult(strategies, axes, cost, mem, [log[-1]])
        # honor the memory-aware flags the Unity path honors via its
        # lambda search: an over-budget strategy only wins when nothing
        # fits (then the caller sees the same loud log the Unity path logs)
        over = (config.memory_search
                and mem > config.memory_budget_mb * 1e6)
        best_over = (best is not None and config.memory_search
                     and best.memory_bytes > config.memory_budget_mb * 1e6)
        if best is None:
            best = r
        elif over != best_over:
            if not over:
                best = r
        elif r.cost_us < best.cost_us:
            best = r
    best.log = log + [f"mcmc selected: {best.mesh_axes} "
                      f"cost={best.cost_us:.1f}us"]
    # calibration anchor (obs/calibration.py), same as the Unity path
    best.predicted_step_us = best.cost_us
    return best
