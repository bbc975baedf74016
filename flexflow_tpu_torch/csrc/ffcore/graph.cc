// PCG graph structure + algorithms.
//
// Reference roles: PCG::Graph (include/flexflow/graph.h:293), topological
// sort / post-dominators / bottleneck detection (include/flexflow/
// dominators.h, graph.cc find_bottleneck_node). Implemented fresh over the
// NodeDesc/EdgeDesc descriptors.
#include "ffcore.h"

#include <algorithm>
#include <deque>
#include <stdexcept>

namespace ffcore {

void Graph::finalize() {
  index.clear();
  for (size_t i = 0; i < nodes.size(); ++i) index[nodes[i].guid] = (int)i;
}

std::vector<std::vector<int>> Graph::succ() const {
  std::vector<std::vector<int>> s(nodes.size());
  for (const auto& e : edges) {
    auto si = index.find(e.src), di = index.find(e.dst);
    if (si != index.end() && di != index.end())
      s[si->second].push_back(di->second);
  }
  return s;
}

std::vector<std::vector<int>> Graph::pred() const {
  std::vector<std::vector<int>> p(nodes.size());
  for (const auto& e : edges) {
    auto si = index.find(e.src), di = index.find(e.dst);
    if (si != index.end() && di != index.end())
      p[di->second].push_back(si->second);
  }
  return p;
}

std::vector<int> Graph::topo_order() const {
  auto sc = succ();
  std::vector<int> indeg(nodes.size(), 0);
  for (const auto& ss : sc)
    for (int d : ss) indeg[d]++;
  // stable: among ready nodes pick smallest guid (matches the Python core)
  auto cmp = [&](int a, int b) { return nodes[a].guid > nodes[b].guid; };
  std::vector<int> heap;
  for (size_t i = 0; i < nodes.size(); ++i)
    if (indeg[i] == 0) heap.push_back((int)i);
  std::make_heap(heap.begin(), heap.end(), cmp);
  std::vector<int> order;
  while (!heap.empty()) {
    std::pop_heap(heap.begin(), heap.end(), cmp);
    int u = heap.back();
    heap.pop_back();
    order.push_back(u);
    for (int v : sc[u]) {
      if (--indeg[v] == 0) {
        heap.push_back(v);
        std::push_heap(heap.begin(), heap.end(), cmp);
      }
    }
  }
  if (order.size() != nodes.size())
    throw std::runtime_error("ffcore: PCG has a cycle");
  return order;
}

std::vector<std::set<int>> Graph::post_dominators() const {
  auto order = topo_order();
  auto sc = succ();
  std::vector<std::set<int>> postdom(nodes.size());
  std::set<int> all;
  for (size_t i = 0; i < nodes.size(); ++i) all.insert((int)i);
  for (size_t i = 0; i < nodes.size(); ++i) postdom[i] = all;
  bool changed = true;
  while (changed) {
    changed = false;
    for (auto it = order.rbegin(); it != order.rend(); ++it) {
      int g = *it;
      std::set<int> next;
      if (sc[g].empty()) {
        next = {g};
      } else {
        next = all;
        for (int s : sc[g]) {
          std::set<int> inter;
          std::set_intersection(next.begin(), next.end(), postdom[s].begin(),
                                postdom[s].end(),
                                std::inserter(inter, inter.begin()));
          next = std::move(inter);
        }
        next.insert(g);
      }
      if (next != postdom[g]) {
        postdom[g] = std::move(next);
        changed = true;
      }
    }
  }
  return postdom;
}

std::vector<int> Graph::bottlenecks() const {
  auto order = topo_order();
  if (order.empty()) return {};
  auto pd = post_dominators();
  auto pr = pred();
  std::set<int> sources;
  for (size_t i = 0; i < nodes.size(); ++i)
    if (pr[i].empty()) sources.insert((int)i);
  if (sources.empty()) return {};
  std::set<int> common;
  bool first = true;
  for (int s : sources) {
    if (first) {
      common = pd[s];
      first = false;
    } else {
      std::set<int> inter;
      std::set_intersection(common.begin(), common.end(), pd[s].begin(),
                            pd[s].end(), std::inserter(inter, inter.begin()));
      common = std::move(inter);
    }
  }
  std::vector<int> out;
  for (int u : order)
    if (common.count(u) && !sources.count(u)) out.push_back(u);
  return out;
}

}  // namespace ffcore
