// Analytic TPU machine model + per-op/per-edge cost model.
//
// Reference roles: MachineModel hierarchy (include/flexflow/simulator.h:212,
// 229, 279, 515) and the per-op cost logic of Simulator::measure_operator_
// cost / simulate_runtime (simulator.cc). Formulas mirror the Python
// flexflow_tpu/search/machine_model.py + simulator.py cost model exactly so
// native and Python searches agree.
#include "ffcore.h"

#include <algorithm>
#include <cmath>

namespace ffcore {

double MachineSpec::link_bw(int n) const {
  if (n > chips_per_pod) return dcn_gbps * 1e9;
  return link_mult * ici_gbps * 1e9;
}

double MachineSpec::compute_time_us(double flops, double bytes,
                                    int dtype_bytes) const {
  double peak =
      (dtype_bytes <= 2 ? peak_bf16_tflops : peak_f32_tflops) * 1e12;
  double t_flops = flops / peak;
  double t_mem = bytes / (hbm_bw_gbps * 1e9);
  return std::max(t_flops, t_mem) * 1e6 + 1.0;
}

double MachineSpec::allreduce_us(double bytes, int n) const {
  if (n <= 1) return 0.0;
  return 2.0 * (n - 1) / n * bytes / link_bw(n) * 1e6 + 1.0;
}

double MachineSpec::allgather_us(double bytes_per_shard, int n) const {
  if (n <= 1) return 0.0;
  return (n - 1) * bytes_per_shard / link_bw(n) * 1e6 + 1.0;
}

double MachineSpec::reduce_scatter_us(double bytes, int n) const {
  if (n <= 1) return 0.0;
  return (double)(n - 1) / n * bytes / link_bw(n) * 1e6 + 1.0;
}

double MachineSpec::p2p_us(double bytes) const {
  // neighbor hop on one ICI link (mirrors machine_model.py p2p_time_us)
  return bytes / (ici_gbps * 1e9) * 1e6 + 1.0;
}

double MachineSpec::all_to_all_us(double bytes, int n) const {
  if (n <= 1) return 0.0;
  // each chip sends (n-1)/n of its bytes; torus bisection limits this
  // (mirrors machine_model.py all_to_all_time_us)
  return (double)(n - 1) / n * bytes / link_bw(n) * 1e6 + 1.0;
}

// ---------------------------------------------------------------- costs
static const double kBwdFactor = 2.0;  // two grad GEMMs per fwd GEMM

double CostModel::forward_us(const NodeDesc& n, const Strategy& s) const {
  if (n.inert) return 0.0;
  double shards = (double)s.dp * (n.tp_capable ? s.tp : 1);
  if (sp_feasible(n, s.sp)) shards *= s.sp;
  if (ep_feasible(n, s.ep)) shards *= s.ep;
  if (ap_feasible(n, s.ap)) shards *= s.ap;
  if (shards < 1) shards = 1;
  return m_.compute_time_us(n.flops / shards, n.bytes_accessed / shards,
                            eff_dtype_bytes(n));
}

double CostModel::ep_collective_us(const NodeDesc& n,
                                   const Strategy& s) const {
  // token routing of expert parallelism: all_to_all of the capacity
  // buffers to resident experts and back (fwd) + the mirrored bwd pair
  // (simulator.py ep_collective_time_us; element bases from Python)
  if (s.ep <= 1 || !n.ep_capable) return 0.0;
  double shard = std::max(1, s.dp * s.ep);
  int db = eff_dtype_bytes(n);
  double disp = n.ep_disp_elems * db / shard;
  double comb = n.ep_comb_elems * db / shard;
  return 2.0 * (m_.all_to_all_us(disp, s.ep) + m_.all_to_all_us(comb, s.ep));
}

double CostModel::ap_halo_us(const NodeDesc& n, const Strategy& s) const {
  // halo exchange of spatial (H) sharding: each chip swaps the
  // kernel-overlap boundary rows with its neighbors, fwd + mirrored bwd
  // (simulator.py ap_halo_time_us; element base from Python, zero when
  // kernel_h == stride_h)
  if (s.ap <= 1 || !n.ap_capable || n.ap_halo_elems <= 0) return 0.0;
  double halo = n.ap_halo_elems * eff_dtype_bytes(n) / std::max(1, s.dp);
  return 2.0 * m_.p2p_us(halo);
}

double CostModel::sp_collective_us(const NodeDesc& n,
                                   const Strategy& s) const {
  // mode-aware (mirrors simulator.py sp_collective_time_us): ring = (sp-1)
  // neighbor ppermutes of the local K+V blocks fwd + mirrored bwd;
  // ulysses = q/k/v/out all_to_all blocks (4 fwd, mirrored bwd)
  if (s.sp <= 1 || n.sp_kv_base <= 0) return 0.0;
  if (n.sp_ulysses) {
    // q/out blocks carry L_q, k/v blocks L_kv (cross-attention differs)
    double denom = std::max(1, s.dp) * (double)s.sp;
    double q_tok = n.sp_q_base / denom;
    double kv_tok = (n.sp_kv_base / 2.0) / denom;
    return 2.0 * 2.0 *
           (m_.all_to_all_us(q_tok, s.sp) + m_.all_to_all_us(kv_tok, s.sp));
  }
  double kv = n.sp_kv_base / (std::max(1, s.dp) * (double)s.sp);
  return 2.0 * (s.sp - 1) * m_.p2p_us(kv);
}

double CostModel::backward_us(const NodeDesc& n, const Strategy& s) const {
  if (n.inert) return 0.0;
  return kBwdFactor * forward_us(n, s);
}

double CostModel::tp_collective_us(const NodeDesc& n, const Strategy& s) const {
  if (s.tp <= 1 || !(n.tp_capable || n.row_capable) || n.out_elems <= 0)
    return 0.0;
  double bytes = n.out_elems * eff_dtype_bytes(n) / std::max(1, s.dp);
  if (s.tp_row) {
    // the Megatron pair costs TWO allreduces per step: fwd partial sums
    // here, plus the bwd allreduce at the pair entry; simulate() charges
    // half in each pass (simulator.py tp_collective_time_us)
    return 2.0 * m_.allreduce_us(bytes, s.tp);
  }
  return m_.allgather_us(bytes / s.tp, s.tp) +
         m_.reduce_scatter_us(bytes, s.tp);
}

double CostModel::xfer_us(double bytes, const Strategy& src,
                          const Strategy& dst) const {
  if (src.dp == dst.dp) return 0.0;
  int n = std::max(src.dp, dst.dp);
  if (dst.dp > src.dp) return 0.0;  // finer consumer: local slice
  return m_.allgather_us(bytes / n, n);
}

// TP reshard on an edge: a column-parallel producer's sharded output costs
// an allgather in fwd / gradient reduce_scatter in bwd for any consumer,
// EXCEPT the free Megatron column->row pairing and row producers (whose
// outputs are replicated after their all-reduce).
double CostModel::tp_boundary_us(double bytes, const NodeDesc& src_n,
                                 const Strategy& src, const Strategy& dst,
                                 bool backward) const {
  // a row-parallel producer's output is replicated after its all-reduce
  // (free edges); a column producer feeding a SAME-degree row consumer
  // stays sharded for free — the Megatron pairing
  // (simulator.py tp_boundary_time_us)
  if (!src_n.tp_capable || src.tp <= 1 || src.tp_row) return 0.0;
  if (dst.tp == src.tp && dst.tp_row) return 0.0;
  if (backward)
    return m_.reduce_scatter_us(bytes / std::max(1, src.dp), src.tp);
  double shard = bytes / std::max(1, src.dp * src.tp);
  return m_.allgather_us(shard, src.tp);
}

double CostModel::grad_sync_us(const NodeDesc& n, const Strategy& s) const {
  // weights are replicated across attr shards: their grads all-reduce
  // over the dp x ap group (simulator.py grad_sync_time_us)
  int sync = s.dp * (n.ap_capable ? std::max(1, s.ap) : 1);
  if (sync <= 1 || n.weight_bytes <= 0) return 0.0;
  // expert weights shard over the expert axis (simulator.py
  // _grad_sync_uncached: wshard = ep for EXPERTS else tp)
  double wb = n.weight_bytes /
              std::max(1, n.ep_capable ? s.ep : s.tp);
  return m_.allreduce_us(wb, sync);
}

double CostModel::memory_bytes(const NodeDesc& n, const Strategy& s) const {
  int wshard = n.ep_capable ? std::max(1, s.ep)
                            : ((n.tp_capable || n.row_capable)
                                   ? std::max(1, s.tp) : 1);
  double wb;
  if (s.tp_row) {
    // row-parallel: only the kernel shards; the bias stays replicated
    wb = n.kernel_bytes / wshard + (n.weight_bytes - n.kernel_bytes);
  } else {
    wb = n.weight_bytes / wshard;
  }
  // EXPERTS outputs are data-sharded only — the expert axis shards
  // weights/buffers, not activations; row-parallel outputs are
  // replicated after their all-reduce (simulator.py op_memory_bytes)
  double ab = n.act_bytes /
              std::max(1, s.dp * (s.tp_row ? 1 : s.tp));
  if (sp_feasible(n, s.sp)) ab /= s.sp;  // position-sharded activations
  if (ap_feasible(n, s.ap)) ab /= s.ap;  // spatially-sharded activations
  return 3.0 * wb + ab;
}

double CostModel::op_step_us(const NodeDesc& n, const Strategy& s) const {
  return forward_us(n, s) + backward_us(n, s) + tp_collective_us(n, s) +
         sp_collective_us(n, s) + ep_collective_us(n, s) + ap_halo_us(n, s);
}

// ------------------------------------------------------------- simulator
// Event-driven two-stream schedule of the fwd/bwd/update task graph —
// compute (ops serialize on the TensorCore) and ICI (collectives, which
// overlap compute when Options.overlap). Mirrors simulator.py
// Simulator::simulate exactly (reference: simulate_runtime,
// simulator.cc:815+).
double Simulator::simulate(const std::map<int64_t, Strategy>& strategies,
                           const std::vector<int>* subset) const {
  Strategy def;
  auto get = [&](int64_t guid) {
    auto it = strategies.find(guid);
    return it == strategies.end() ? def : it->second;
  };
  std::set<int64_t> in_scope;
  if (subset) {
    for (int i : *subset) in_scope.insert(g_.nodes[i].guid);
  } else {
    for (const auto& n : g_.nodes) in_scope.insert(n.guid);
  }
  double t_compute = 0.0, t_comm = 0.0;
  const bool overlap = o_.overlap;
  // per-mesh-axis ICI timelines when the machine is torus-aware (mirrors
  // simulator.py: same-axis collectives contend, orthogonal axes overlap —
  // the congestion analog of EnhancedMachineModel's per-link queues)
  enum Chan { DP = 0, TP, SP, EP, AP, NCHAN };
  const bool per_axis = overlap && channels_;
  double t_ch[NCHAN] = {0, 0, 0, 0, 0};
  auto run_comm = [&](double dur, double ready, int ch = -1) {
    if (dur <= 0.0) return ready;
    if (!overlap) {
      double start = std::max(t_compute, ready);
      t_compute = start + dur;
      return t_compute;
    }
    if (!per_axis || ch < 0) {
      double start = std::max(t_comm, ready);
      if (per_axis)  // channel-less = full-mesh reshard: barrier all axes
        for (double t : t_ch) start = std::max(start, t);
      double end = start + dur;
      t_comm = end;
      if (per_axis)
        for (double& t : t_ch) t = end;
      return end;
    }
    double start = std::max(t_ch[ch], ready);
    t_ch[ch] = start + dur;
    return t_ch[ch];
  };
  // a collective over a PRODUCT of axes (dp x ap grad allreduce) occupies
  // every involved axis's rings
  auto run_comm_pair = [&](double dur, double ready, int c1, int c2) {
    if (dur <= 0.0) return ready;
    if (!overlap || !per_axis) return run_comm(dur, ready, -1);
    double start = std::max(ready, std::max(t_ch[c1], t_ch[c2]));
    double end = start + dur;
    t_ch[c1] = t_ch[c2] = end;
    return end;
  };
  auto run_compute = [&](double dur, double ready) {
    double start = std::max(t_compute, ready);
    t_compute = start + dur;
    return t_compute;
  };
  // the dp-degree reshard rides the data rings, the TP boundary collective
  // the model rings: separate channels, chained through the edge
  auto run_edge = [&](const EdgeDesc& e, const Strategy& ss,
                      const Strategy& ds, bool backward, double ready) {
    double fin = run_comm(cost_.xfer_us(e.bytes, ss, ds), ready, DP);
    return run_comm(cost_.tp_boundary_us(e.bytes, g_.nodes[g_.index.at(e.src)],
                                         ss, ds, backward),
                    fin, TP);
  };

  // pre-index edges by endpoint, preserving serialization order (matches
  // the Python loop over op.inputs / its consumer_edges map)
  std::map<int64_t, std::vector<const EdgeDesc*>> by_dst, by_src;
  for (const auto& e : g_.edges) {
    if (!in_scope.count(e.src) || !in_scope.count(e.dst)) continue;
    by_dst[e.dst].push_back(&e);
    by_src[e.src].push_back(&e);
  }

  auto order = g_.topo_order();
  std::map<int64_t, double> out_ready;
  for (int i : order) {
    const NodeDesc& n = g_.nodes[i];
    if (!in_scope.count(n.guid)) continue;
    Strategy s = get(n.guid);
    double ready = 0.0;
    for (const EdgeDesc* e : by_dst[n.guid]) {
      double fin = run_edge(*e, get(e->src), s, false, out_ready[e->src]);
      ready = std::max(ready, fin);
    }
    double fin = run_compute(cost_.forward_us(n, s), ready);
    fin = run_comm(0.5 * cost_.ep_collective_us(n, s), fin, EP);
    fin = run_comm(0.5 * cost_.ap_halo_us(n, s), fin, AP);
    fin = run_comm(0.5 * cost_.sp_collective_us(n, s), fin, SP);
    if (s.tp_row) fin = run_comm(0.5 * cost_.tp_collective_us(n, s), fin, TP);
    out_ready[n.guid] = fin;
  }
  // backward: bwd(op) after bwd of its consumers + mirrored edge reshard
  std::map<int64_t, double> bwd_end;
  double update_ready = 0.0;
  for (auto it = order.rbegin(); it != order.rend(); ++it) {
    const NodeDesc& n = g_.nodes[*it];
    if (!in_scope.count(n.guid)) continue;
    Strategy s = get(n.guid);
    double ready = 0.0;
    for (const EdgeDesc* e : by_src[n.guid]) {
      double fin = run_edge(*e, s, get(e->dst), true, bwd_end[e->dst]);
      ready = std::max(ready, fin);
    }
    double fin = run_compute(cost_.backward_us(n, s), ready);
    fin = run_comm(0.5 * cost_.ep_collective_us(n, s), fin, EP);
    fin = run_comm(0.5 * cost_.ap_halo_us(n, s), fin, AP);
    fin = run_comm(0.5 * cost_.sp_collective_us(n, s), fin, SP);
    if (s.tp_row) fin = run_comm(0.5 * cost_.tp_collective_us(n, s), fin, TP);
    bwd_end[n.guid] = fin;
    // grad allreduce rides the data rings (plus the attr rings when the
    // reduce spans the dp x ap group); must not queue behind model-axis
    // activation collectives
    double gs = cost_.grad_sync_us(n, s);
    double gend = (s.ap > 1 && n.ap_capable)
                      ? run_comm_pair(gs, fin, DP, AP)
                      : run_comm(gs, fin, DP);
    update_ready = std::max(update_ready, gend);
  }
  return std::max(t_compute, update_ready);
}

double Simulator::memory(const std::map<int64_t, Strategy>& strategies) const {
  Strategy def;
  double total = 0;
  for (const auto& n : g_.nodes) {
    auto it = strategies.find(n.guid);
    total += cost_.memory_bytes(n, it == strategies.end() ? def : it->second);
  }
  return total;
}

}  // namespace ffcore
