// C API over ffcore (reference role: include/flexflow/flexflow_c.h /
// src/c/flexflow_c.cc — the C surface the Python binding loads). The Python
// side talks a line-oriented text protocol; see run_text_protocol.
#include "ffcore.h"

#include <cstring>
#include <sstream>

namespace ffcore {

// one emitter for both the text protocol and the C-model API, so the
// result grammar cannot drift between them
std::string format_search_result(const SearchResult& r) {
  std::ostringstream out;
  out.precision(17);
  out << "cost " << r.cost_us << "\n";
  out << "memory " << r.memory_bytes << "\n";
  out << "mesh " << r.mesh_dp << " " << r.mesh_tp << " " << r.mesh_sp << " "
      << r.mesh_ep << " " << r.mesh_ap << "\n";
  for (const auto& [guid, s] : r.strategies)
    out << "strategy " << guid << " " << s.dp << " " << s.tp << " " << s.sp
        << " " << s.ep << " " << s.ap << " " << (s.tp_row ? 1 : 0) << "\n";
  return out.str();
}

static void parse_line(const std::string& line, Graph& g, MachineSpec& m,
                       Options& o) {
  std::istringstream ss(line);
  std::string kind;
  ss >> kind;
  if (kind == "machine") {
    ss >> m.num_chips >> m.peak_bf16_tflops >> m.peak_f32_tflops >> m.hbm_gb >>
        m.hbm_bw_gbps >> m.ici_gbps >> m.dcn_gbps >> m.link_mult >>
        m.chips_per_pod;
    // optional trailing flag (older senders omit it)
    int cc = 0;
    if (ss >> cc) m.comm_channels = cc;
  } else if (kind == "options") {
    int only_dp, mixed, overlap, memory_search;
    ss >> o.n_devices >> o.batch >> o.budget >> o.alpha >> only_dp >> mixed >>
        overlap >> memory_search >> o.memory_budget_bytes >> o.mcmc_iters >>
        o.seed;
    o.only_dp = only_dp;
    o.mixed = mixed;
    o.overlap = overlap;
    o.memory_search = memory_search;
    // optional trailing flag (older senders omit it)
    int param_parallel = 0;
    if (ss >> param_parallel) o.param_parallel = param_parallel;
  } else if (kind == "node") {
    NodeDesc n;
    int tp_capable, inert;
    ss >> n.guid >> n.flops >> n.bytes_accessed >> n.weight_bytes >>
        n.act_bytes >> n.out_elems >> n.dtype_bytes >> tp_capable >>
        n.tp_divisor >> inert;
    n.tp_capable = tp_capable;
    n.inert = inert;
    // optional trailing sp / ep fields (older senders omit them)
    int sp_capable = 0;
    if (ss >> sp_capable >> n.sp_divisor >> n.sp_kv_base)
      n.sp_capable = sp_capable;
    int ep_capable = 0;
    if (ss >> ep_capable >> n.ep_divisor >> n.ep_disp_elems >>
        n.ep_comb_elems)
      n.ep_capable = ep_capable;
    int ap_capable = 0;
    if (ss >> ap_capable >> n.ap_h >> n.ap_out_h >> n.ap_stride >>
        n.ap_halo_elems)
      n.ap_capable = ap_capable;
    int row_capable = 0;
    if (ss >> row_capable >> n.row_divisor >> n.kernel_bytes)
      n.row_capable = row_capable;
    int sp_uly = 0;
    if (ss >> sp_uly >> n.sp_q_base) n.sp_ulysses = sp_uly;
    g.nodes.push_back(n);
  } else if (kind == "sps") {
    o.sps.clear();
    int v;
    while (ss >> v) o.sps.push_back(v);
    if (o.sps.empty()) o.sps.push_back(1);
  } else if (kind == "eps") {
    o.eps.clear();
    int v;
    while (ss >> v) o.eps.push_back(v);
    if (o.eps.empty()) o.eps.push_back(1);
  } else if (kind == "aps") {
    o.aps.clear();
    int v;
    while (ss >> v) o.aps.push_back(v);
    if (o.aps.empty()) o.aps.push_back(1);
  } else if (kind == "edge") {
    EdgeDesc e;
    ss >> e.src >> e.dst >> e.bytes;
    g.edges.push_back(e);
  }
}

std::string run_text_protocol(const std::string& input) {
  Graph g;
  MachineSpec m;
  Options o;
  std::istringstream in(input);
  std::string line, cmd = "optimize";
  while (std::getline(in, line)) {
    if (line.rfind("cmd ", 0) == 0) {
      cmd = line.substr(4);
      continue;
    }
    parse_line(line, g, m, o);
  }
  std::ostringstream out;
  out.precision(17);
  g.finalize();
  if (cmd == "topo") {
    for (int i : g.topo_order()) out << g.nodes[i].guid << " ";
    out << "\n";
  } else if (cmd == "bottlenecks") {
    for (int i : g.bottlenecks()) out << g.nodes[i].guid << " ";
    out << "\n";
  } else if (cmd == "postdom") {
    auto pd = g.post_dominators();
    for (size_t i = 0; i < g.nodes.size(); ++i) {
      out << g.nodes[i].guid << ":";
      for (int j : pd[i]) out << " " << g.nodes[j].guid;
      out << "\n";
    }
  } else if (cmd == "simulate") {
    Simulator sim(g, m, o);
    std::map<int64_t, Strategy> strategies;  // all-default
    out << "cost " << sim.simulate(strategies) << "\n";
  } else {  // optimize
    SearchResult r = optimize(g, m, o);
    out << format_search_result(r);
    std::istringstream logss(r.log);
    std::string logline;
    while (std::getline(logss, logline)) out << "log " << logline << "\n";
  }
  return out.str();
}

}  // namespace ffcore

extern "C" {

const char* ffc_version() { return "ffcore-0.1.0"; }

// Runs the text protocol; returns a malloc'd string the caller frees with
// ffc_free.
char* ffc_run(const char* input) {
  try {
    std::string out = ffcore::run_text_protocol(input ? input : "");
    char* buf = (char*)malloc(out.size() + 1);
    memcpy(buf, out.c_str(), out.size() + 1);
    return buf;
  } catch (const std::exception& e) {
    std::string err = std::string("error ") + e.what() + "\n";
    char* buf = (char*)malloc(err.size() + 1);
    memcpy(buf, err.c_str(), err.size() + 1);
    return buf;
  }
}

void ffc_free(char* p) { free(p); }

}  // extern "C"
