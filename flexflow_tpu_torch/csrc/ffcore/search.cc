// Unity-style strategy search + MCMC refinement.
//
// Reference roles: GraphSearchHelper::graph_optimize / base_optimize
// (substitution.cc:1898, 2229 — sequence splits at bottleneck nodes,
// memoized, best-first refinement with alpha pruning and an iteration
// budget) and FFModel::mcmc_optimize (model.cc:3286 — simulated annealing
// over per-op configs). Algorithms re-implemented over NodeDesc graphs.
#include "ffcore.h"

#include <algorithm>
#include <cmath>
#include <queue>
#include <random>
#include <sstream>

namespace ffcore {

static std::vector<Strategy> menu(const NodeDesc& n, int dp, int tp,
                                  const Options& o, int sp = 1, int ep = 1,
                                  int ap = 1) {
  std::vector<int> dps;
  if (o.batch % dp == 0) dps.push_back(dp);
  if (dp != 1) dps.push_back(1);
  if (dps.empty()) dps.push_back(1);
  // (tp, row) pairs, mirroring unity.py op_strategy_menu: column TP when
  // the out-dim divides; row-parallel LINEAR additionally under
  // --enable-parameter-parallel when the IN-dim divides (row can exist
  // even where column TP is infeasible)
  struct TpChoice { int tp; bool row; };
  std::vector<TpChoice> tps = {{1, false}};
  bool tp_ok = tp > 1 && n.tp_capable && !o.only_dp &&
               (n.tp_divisor == 0 ||
                (n.tp_divisor > 0 && n.tp_divisor % tp == 0));
  if (tp_ok) tps = {{tp, false}, {1, false}};
  if (o.param_parallel && !o.only_dp && row_feasible(n, tp))
    tps.push_back({tp, true});
  // per-op ep choice for EXPERTS ops (mirrors unity.py op_strategy_menu's
  // eps = [ep, 1]); everything else runs ep=1
  std::vector<int> eps = {1};
  if (ep_feasible(n, ep) && !o.only_dp) eps = {ep, 1};
  std::vector<int> aps = {1};
  if (ap_feasible(n, ap) && !o.only_dp) aps = {ap, 1};
  // sp is graph-wide per factorization (per-op flips would reshard the
  // position dim at every edge): shardable ops carry it, others sp=1
  int node_sp = sp_feasible(n, sp) ? sp : 1;
  std::vector<Strategy> out;
  for (int d : dps)
    for (const auto& t : tps)
      for (int e : eps)
        for (int a : aps)
          out.push_back({d, t.tp, node_sp, e, a, t.row});
  return out;
}

// segments of the topological order, cut after each bottleneck node
static std::vector<std::vector<int>> segments(const Graph& g) {
  auto order = g.topo_order();
  auto bn = g.bottlenecks();
  std::set<int> cut(bn.begin(), bn.end());
  std::vector<std::vector<int>> segs(1);
  for (int u : order) {
    segs.back().push_back(u);
    if (cut.count(u)) segs.emplace_back();
  }
  if (segs.back().empty()) segs.pop_back();
  return segs;
}

struct Candidate {
  double cost;
  uint64_t order;
  std::map<int64_t, Strategy> strategies;
  bool operator>(const Candidate& o) const {
    return cost != o.cost ? cost > o.cost : order > o.order;
  }
};

// best-first refinement over single-op strategy flips with alpha pruning
// and the iteration budget (reference: base_optimize substitution.cc:2229;
// mirrors unity.py GraphSearchHelper._best_first_flips) — shared by the
// per-segment DP and the cross-segment pass
template <typename CostFn>
static void best_first_flips(const Graph& g,
                             const std::vector<int64_t>& cand_guids, int dp,
                             int tp, const Options& o, CostFn cost_fn,
                             std::map<int64_t, Strategy>& best,
                             double& best_cost, int sp = 1, int ep = 1, int ap = 1) {
  std::priority_queue<Candidate, std::vector<Candidate>, std::greater<>> pq;
  uint64_t counter = 0;
  pq.push({best_cost, counter++, best});
  int pops = 0;
  while (!pq.empty() && pops < o.budget) {
    Candidate cur = pq.top();
    pq.pop();
    pops++;
    if (cur.cost > best_cost * o.alpha) continue;
    for (int64_t guid : cand_guids) {
      const NodeDesc& n = g.nodes[g.index.at(guid)];
      for (const auto& s : menu(n, dp, tp, o, sp, ep, ap)) {
        if (s == cur.strategies[n.guid]) continue;
        auto cand = cur.strategies;
        cand[n.guid] = s;
        double c = cost_fn(cand);
        if (c < best_cost) {
          best = cand;
          best_cost = c;
        }
        if (c < cur.cost * o.alpha) pq.push({c, counter++, std::move(cand)});
      }
    }
  }
}

static std::map<int64_t, Strategy> optimize_segment(
    const Graph& g, const Simulator& sim, const std::vector<int>& seg,
    int dp, int tp, const Options& o, int sp = 1, int ep = 1,
    int ap = 1) {
  std::map<int64_t, Strategy> best;
  std::vector<int64_t> guids;
  // greedy seed: per-op best in isolation (menu order breaks ties)
  for (int i : seg) {
    const NodeDesc& n = g.nodes[i];
    guids.push_back(n.guid);
    auto m = menu(n, dp, tp, o, sp, ep, ap);
    Strategy pick = m[0];
    double pc = sim.cost().op_step_us(n, pick);
    for (const auto& s : m) {
      double c = sim.cost().op_step_us(n, s);
      if (c < pc) {
        pc = c;
        pick = s;
      }
    }
    best[n.guid] = pick;
  }
  double best_cost = sim.simulate(best, &seg);
  best_first_flips(g, guids, dp, tp, o,
                   [&](const std::map<int64_t, Strategy>& st) {
                     return sim.simulate(st, &seg);
                   },
                   best, best_cost, sp, ep, ap);
  return best;
}

// whole-graph best-first refinement over single-op flips, costed by the
// full-graph event-driven simulate (cross-segment interactions). Flip
// candidates restricted to segment-boundary ops — interior flips were
// already optimal under the segment DP (mirrors unity.py
// GraphSearchHelper._refine_global + _boundary_ops exactly).
static void refine_global(const Graph& g, const Simulator& sim, int dp,
                          int tp, const Options& o,
                          const std::vector<std::vector<int>>& segs,
                          std::map<int64_t, Strategy>& strategies,
                          int sp = 1, int ep = 1, int ap = 1) {
  if (o.budget <= 0 || g.nodes.size() < 2) return;
  std::map<int64_t, int> seg_of;
  for (size_t i = 0; i < segs.size(); ++i)
    for (int u : segs[i]) seg_of[g.nodes[u].guid] = (int)i;
  // boundary ops in topo order: edge-crossing dsts, then their cross srcs
  std::vector<int64_t> cand_order;
  std::set<int64_t> cand_set;
  auto add = [&](int64_t guid) {
    if (cand_set.insert(guid).second) cand_order.push_back(guid);
  };
  for (int u : g.topo_order()) {
    int64_t guid = g.nodes[u].guid;
    std::vector<int64_t> cross_srcs;
    for (const auto& e : g.edges)
      if (e.dst == guid && seg_of.count(e.src) &&
          seg_of[e.src] != seg_of[guid])
        cross_srcs.push_back(e.src);
    if (cross_srcs.empty()) continue;
    add(guid);
    for (int64_t s : cross_srcs) add(s);
  }
  if (cand_order.empty()) return;
  auto best = strategies;
  double best_cost = sim.simulate(best);
  best_first_flips(g, cand_order, dp, tp, o,
                   [&](const std::map<int64_t, Strategy>& st) {
                     return sim.simulate(st);
                   },
                   best, best_cost, sp, ep, ap);
  strategies = std::move(best);
}

// MCMC refinement (reference: mcmc_optimize model.cc:3286): random single-op
// rewrites, Metropolis acceptance, annealed temperature.
static void mcmc_refine(const Graph& g, const Simulator& sim, int dp, int tp,
                        const Options& o,
                        std::map<int64_t, Strategy>& strategies,
                        double& cost, int sp = 1, int ep = 1, int ap = 1) {
  std::mt19937_64 rng(o.seed);
  std::uniform_real_distribution<double> unif(0.0, 1.0);
  auto cur = strategies;
  double cur_cost = cost;
  for (int it = 0; it < o.mcmc_iters; ++it) {
    const NodeDesc& n = g.nodes[rng() % g.nodes.size()];
    auto m = menu(n, dp, tp, o, sp, ep, ap);
    auto cand = cur;
    cand[n.guid] = m[rng() % m.size()];
    double c = sim.simulate(cand);
    double temp = 1.0 - (double)it / std::max(1, o.mcmc_iters);
    // alpha plays the reference's acceptance sharpness role
    if (c < cur_cost ||
        unif(rng) < std::exp(-(c - cur_cost) / (cur_cost * 0.05 * temp + 1e-9))) {
      cur = std::move(cand);
      cur_cost = c;
    }
    if (cur_cost < cost) {
      strategies = cur;
      cost = cur_cost;
    }
  }
}

SearchResult optimize(Graph& g, const MachineSpec& m, const Options& o) {
  g.finalize();
  Simulator sim(g, m, o);
  auto segs = segments(g);

  SearchResult best;
  best.cost_us = -1;
  std::ostringstream log;

  struct Fact { int dp, tp, sp, ep, ap; };
  std::vector<Fact> facts;
  if (o.only_dp) {
    facts = {{o.n_devices, 1, 1, 1, 1}};
  } else {
    std::vector<int> sps = o.sps.empty() ? std::vector<int>{1} : o.sps;
    std::vector<int> eps = o.eps.empty() ? std::vector<int>{1} : o.eps;
    std::vector<int> aps = o.aps.empty() ? std::vector<int>{1} : o.aps;
    for (int sp : sps) {
      if (sp < 1 || o.n_devices % sp != 0) continue;
      for (int ep : eps) {
        if (ep < 1 || (o.n_devices / sp) % ep != 0) continue;
        for (int ap : aps) {
          if (ap < 1 || (o.n_devices / sp / ep) % ap != 0) continue;
          int rem = o.n_devices / (sp * ep * ap);
          for (int dp = 1; dp <= rem; ++dp)
            if (rem % dp == 0) facts.push_back({dp, rem / dp, sp, ep, ap});
        }
      }
    }
  }
  for (auto [dp, tp, sp, ep, ap] : facts) {
    if (o.batch % dp != 0) continue;
    // a sp>1 (ep>1, ap>1) factorization must shard SOMETHING over its axis
    if (sp > 1) {
      bool any = false;
      for (const auto& n : g.nodes) any = any || sp_feasible(n, sp);
      if (!any) continue;
    }
    if (ep > 1) {
      bool any = false;
      for (const auto& n : g.nodes) any = any || ep_feasible(n, ep);
      if (!any) continue;
    }
    if (ap > 1) {
      bool any = false;
      for (const auto& n : g.nodes) any = any || ap_feasible(n, ap);
      if (!any) continue;
    }
    std::map<int64_t, Strategy> strategies;
    for (const auto& seg : segs) {
      auto part = optimize_segment(g, sim, seg, dp, tp, o, sp, ep, ap);
      strategies.insert(part.begin(), part.end());
    }
    // cross-segment refinement: single-op flips against the FULL-graph
    // simulate, seeing reshard costs across segment boundaries (mirrors
    // GraphSearchHelper._refine_global)
    refine_global(g, sim, dp, tp, o, segs, strategies, sp, ep, ap);
    double cost = sim.simulate(strategies);
    if (o.mcmc_iters > 0)
      mcmc_refine(g, sim, dp, tp, o, strategies, cost, sp, ep, ap);
    double mem = sim.memory(strategies);
    if (o.memory_search && o.memory_budget_bytes > 0 &&
        mem > o.memory_budget_bytes) {
      double overflow = (mem - o.memory_budget_bytes) / o.memory_budget_bytes;
      cost *= (1.0 + 10.0 * overflow);
    }
    log << "dp=" << dp << " tp=" << tp << " sp=" << sp << " ep=" << ep
        << " ap=" << ap << " cost=" << cost << "us mem=" << mem / 1e9
        << "GB\n";
    if (best.cost_us < 0 || cost < best.cost_us) {
      best.cost_us = cost;
      best.memory_bytes = mem;
      best.mesh_dp = dp;
      best.mesh_tp = tp;
      best.mesh_sp = sp;
      best.mesh_ep = ep;
      best.mesh_ap = ap;
      best.strategies = std::move(strategies);
    }
  }
  best.log = log.str();
  return best;
}

}  // namespace ffcore
