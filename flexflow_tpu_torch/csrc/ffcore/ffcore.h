// ffcore: native host-side core of flexflow_tpu.
//
// Plays the role the reference implements in C++ in src/runtime/graph.cc,
// substitution.cc (search), simulator.cc / machine_model.cc (cost model) and
// the dominator utilities of include/flexflow/dominators.h: a device-
// independent PCG over opaque op descriptors, an analytic TPU machine model,
// and the Unity-style strategy search (sequence splits at post-dominator
// bottlenecks + best-first refinement) plus an MCMC fallback. Exposed to
// Python through the C API in capi.cc (reference role: flexflow_c.h).
#pragma once

#include <cstdint>
#include <map>
#include <set>
#include <string>
#include <vector>

namespace ffcore {

// ---------------------------------------------------------------- machine
struct MachineSpec {
  int num_chips = 1;
  double peak_bf16_tflops = 197.0;
  double peak_f32_tflops = 49.0;
  double hbm_gb = 16.0;
  double hbm_bw_gbps = 819.0;
  double ici_gbps = 45.0;
  double dcn_gbps = 25.0 / 8.0;
  double link_mult = 1.0;  // 2.0 for a bidirectional torus ring
  int chips_per_pod = 256;
  // per-mesh-axis ICI timelines in the event sim (congestion analog of the
  // reference's per-link queues; mirrors MachineModel.comm_channels())
  int comm_channels = 0;

  double link_bw(int n) const;
  double compute_time_us(double flops, double bytes, int dtype_bytes) const;
  double allreduce_us(double bytes, int n) const;
  double p2p_us(double bytes) const;
  double allgather_us(double bytes_per_shard, int n) const;
  double reduce_scatter_us(double bytes, int n) const;
  double all_to_all_us(double bytes, int n) const;
  double memory_budget_bytes() const { return hbm_gb * 1e9; }
};

// ---------------------------------------------------------------- graph
struct NodeDesc {
  int64_t guid = 0;
  double flops = 0;
  double bytes_accessed = 0;
  double weight_bytes = 0;   // native-dtype bytes of all weights
  double act_bytes = 0;      // native-dtype bytes of all outputs
  double out_elems = 0;      // elements of output[0]
  int dtype_bytes = 4;       // native itemsize of output[0]
  bool tp_capable = false;
  int64_t tp_divisor = -1;   // quantity tp must divide; 0 = always ok
  bool inert = false;        // INPUT / NOOP / WEIGHT
  // sequence parallelism (sp): Python computes layout/type capability
  // (sp_shardable minus divisibility) and the position-dim size; cost
  // formulas mirror simulator.py sp_collective_time_us / forward_time_us
  bool sp_capable = false;   // dim 1 is a position dim (not channels)
  bool sp_ulysses = false;   // all_to_all SP kernel (vs the ring rotation)
  double sp_q_base = 0;      // one q/out tensor's full bytes (L_q side)
  int64_t sp_divisor = 0;    // position-dim size; sp must divide; 0 = never
  double sp_kv_base = 0;     // attention: 2*B*L_k*heads*kdim*dtype_bytes
  // expert parallelism (ep): EXPERTS ops only. Python computes the
  // capacity-buffer element counts (simulator.py ep_collective_time_us);
  // the dtype multiplier is applied native-side via eff_dtype_bytes so
  // the mixed-precision policy cannot drift between the two cost models
  bool ep_capable = false;   // op is a fused EXPERTS op
  int64_t ep_divisor = 0;    // number of experts n; ep must divide; 0=never
  double ep_disp_elems = 0;  // dispatch all_to_all elements: n*cap*in_dim
  double ep_comb_elems = 0;  // combine all_to_all elements: n*cap*out_dim
  // attribute/spatial parallelism (ap): CONV2D/POOL2D, gated Python-side
  // by --enable-attribute-parallel (simulator.py AP_CAPABLE +
  // unity.py _ap_divides / ap_halo_time_us)
  bool ap_capable = false;
  int64_t ap_h = 0;          // input H (NCHW)
  int64_t ap_out_h = 0;      // output H
  int64_t ap_stride = 1;     // stride_h: shards must stride-align
  double ap_halo_elems = 0;  // b*c*max(0,kernel_h-stride_h)*w
  // row-parallel ("parameter"-parallel) linear: the kernel shards on the
  // IN-feature dim, the partial-sum output all-reduces
  // (--enable-parameter-parallel; unity.py op_strategy_menu tp_row)
  bool row_capable = false;  // LINEAR op
  int64_t row_divisor = 0;   // in-features; tp must divide; 0 = never
  double kernel_bytes = 0;   // kernel weight bytes (bias replicated in row)
};

// Shared feasibility predicates — the search's menu enumeration and the
// cost model must agree on them or strategies get priced as infeasible
// (or vice versa) with no error.
inline bool sp_feasible(const NodeDesc& n, int sp) {
  // mirrors simulator.py sp_shardable: type/layout capability is computed
  // Python-side (sp_capable); divisibility of the position dim here
  return sp > 1 && n.sp_capable && n.sp_divisor > 0 && n.sp_divisor % sp == 0;
}

inline bool ep_feasible(const NodeDesc& n, int ep) {
  return ep > 1 && n.ep_capable && n.ep_divisor > 0 && n.ep_divisor % ep == 0;
}

inline bool row_feasible(const NodeDesc& n, int tp) {
  // mirrors unity.py: enable_parameter_parallel (Options.param_parallel),
  // LINEAR, in-features divisible
  return tp > 1 && n.row_capable && n.row_divisor > 0 &&
         n.row_divisor % tp == 0;
}

inline bool ap_feasible(const NodeDesc& n, int ap) {
  // mirrors unity.py _ap_divides: input AND output H divide; stride-align
  return ap > 1 && n.ap_capable && n.ap_h > 0 && n.ap_h % ap == 0 &&
         n.ap_out_h > 0 && n.ap_out_h % ap == 0 &&
         (n.ap_h / ap) % (n.ap_stride > 1 ? n.ap_stride : 1) == 0;
}

struct EdgeDesc {
  int64_t src = 0;
  int64_t dst = 0;
  double bytes = 0;  // native-dtype bytes of the tensor on this edge
};

struct Graph {
  std::vector<NodeDesc> nodes;
  std::vector<EdgeDesc> edges;
  std::map<int64_t, int> index;  // guid -> position in nodes

  void finalize();
  // stable topological order of node indices (by guid among ready nodes)
  std::vector<int> topo_order() const;
  // postdom[i] = set of node indices post-dominating i (incl. i)
  std::vector<std::set<int>> post_dominators() const;
  // indices of nodes every source->sink path passes through (excl. sources)
  std::vector<int> bottlenecks() const;
  std::vector<std::vector<int>> succ() const;
  std::vector<std::vector<int>> pred() const;
};

// ---------------------------------------------------------------- search
struct Options {
  int n_devices = 1;
  int batch = 1;
  int budget = 10;
  double alpha = 1.05;
  bool only_dp = false;
  bool mixed = true;       // bf16 compute dtype
  bool overlap = false;    // overlap grad allreduce with backward
  bool memory_search = false;
  double memory_budget_bytes = 0;
  int mcmc_iters = 0;      // >0: refine with simulated annealing
  uint64_t seed = 17;
  // candidate sequence-parallel degrees (feasibility computed Python-side:
  // --enable-sequence-parallel, seq lens/heads divide, no attn dropout)
  std::vector<int> sps{1};
  // candidate expert-parallel degrees (Python-side: divisors of every
  // EXPERTS op's expert count)
  std::vector<int> eps{1};
  // candidate attribute/spatial degrees (--enable-attribute-parallel)
  std::vector<int> aps{1};
  // row-parallel linears join the menu (--enable-parameter-parallel)
  bool param_parallel = false;
};

struct Strategy {
  int dp = 1;
  int tp = 1;
  int sp = 1;  // graph-wide per factorization; 1 on non-shardable ops
  int ep = 1;  // EXPERTS ops only; 1 elsewhere
  int ap = 1;  // CONV2D/POOL2D spatial sharding; 1 elsewhere
  bool tp_row = false;  // row-parallel linear (kernel on in-features)
  bool operator==(const Strategy& o) const {
    return dp == o.dp && tp == o.tp && sp == o.sp && ep == o.ep &&
           ap == o.ap && tp_row == o.tp_row;
  }
};

std::string format_search_result(const struct SearchResult& r);

struct SearchResult {
  double cost_us = 0;
  double memory_bytes = 0;
  int mesh_dp = 1;
  int mesh_tp = 1;
  int mesh_sp = 1;
  int mesh_ep = 1;
  int mesh_ap = 1;
  std::map<int64_t, Strategy> strategies;
  std::string log;
};

class CostModel {
 public:
  CostModel(const MachineSpec& m, const Options& o) : m_(m), o_(o) {}
  int eff_dtype_bytes(const NodeDesc& n) const {
    return o_.mixed ? 2 : n.dtype_bytes;
  }
  double forward_us(const NodeDesc& n, const Strategy& s) const;
  double backward_us(const NodeDesc& n, const Strategy& s) const;
  double tp_collective_us(const NodeDesc& n, const Strategy& s) const;
  double sp_collective_us(const NodeDesc& n, const Strategy& s) const;
  double ep_collective_us(const NodeDesc& n, const Strategy& s) const;
  double ap_halo_us(const NodeDesc& n, const Strategy& s) const;
  double tp_boundary_us(double bytes, const NodeDesc& src_n,
                        const Strategy& src, const Strategy& dst,
                        bool backward) const;
  double xfer_us(double bytes, const Strategy& src, const Strategy& dst) const;
  double grad_sync_us(const NodeDesc& n, const Strategy& s) const;
  double memory_bytes(const NodeDesc& n, const Strategy& s) const;
  double op_step_us(const NodeDesc& n, const Strategy& s) const;

 private:
  const MachineSpec& m_;
  const Options& o_;
};

class Simulator {
 public:
  Simulator(const Graph& g, const MachineSpec& m, const Options& o)
      : g_(g), cost_(m, o), o_(o), channels_(m.comm_channels != 0) {}
  double simulate(const std::map<int64_t, Strategy>& strategies,
                  const std::vector<int>* subset = nullptr) const;
  double memory(const std::map<int64_t, Strategy>& strategies) const;
  const CostModel& cost() const { return cost_; }

 private:
  const Graph& g_;
  CostModel cost_;
  Options o_;
  bool channels_ = false;
};

SearchResult optimize(Graph& g, const MachineSpec& m, const Options& o);

// -------------------------------------------------------------- protocol
// Parses the text protocol fed by the Python binding (machine/options/node/
// edge lines) and renders the result (cost/memory/mesh/strategy lines).
std::string run_text_protocol(const std::string& input);

}  // namespace ffcore
