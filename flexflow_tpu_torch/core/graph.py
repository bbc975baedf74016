"""Computation graph over Op nodes, host-only (a copy of
flexflow_tpu/core/graph.py): edges, the stable Kahn order seeded by op
guid (cached until a mutation), the mutation hooks (add_op, remove_op,
tensor_aliases and resolve_tensor, invalidate_topo), roots and leaves,
post-dominators and the bottleneck nodes the Unity search splits at
(`segments`), `clone` for the joint search's candidate graphs, `hash`,
`split_at`, and the dot export.

`clone` copies op shells, not weights: the search runs before compile
draws any (FFModel._compile_inner). `hash` rests on Python's `hash` of
enum members, which is salted per process: nothing persisted may rest
on it (the plan cache's fingerprints are search/plan_cache.py's).
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict, deque
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .op import Op
from .tensor import Tensor


@dataclasses.dataclass(frozen=True)
class Edge:
    src: int  # producer op guid
    dst: int  # consumer op guid
    src_idx: int  # producer output index
    dst_idx: int  # consumer input index


class Graph:
    def __init__(self, ops: Sequence[Op] = ()):
        self.ops: Dict[int, Op] = {}
        # tensor guid -> replacement tensor, recorded by rewrites that
        # remove producers; resolve_tensor follows the chain so references
        # held elsewhere (FFModel.final_tensor) stay valid
        self.tensor_aliases: Dict[int, Tensor] = {}
        self._topo_cache: Optional[List[Op]] = None
        for op in ops:
            self.add_op(op)

    def resolve_tensor(self, tensor: Tensor) -> Tensor:
        seen = set()
        while tensor.guid in self.tensor_aliases and tensor.guid not in seen:
            seen.add(tensor.guid)
            tensor = self.tensor_aliases[tensor.guid]
        return tensor

    def add_op(self, op: Op) -> None:
        self.ops[op.guid] = op
        self._topo_cache = None

    def remove_op(self, op: Op) -> None:
        del self.ops[op.guid]
        self._topo_cache = None
        # drop alias chains that now dead-end at this op's outputs: a
        # rewrite that replaces the replacement records a further alias
        # BEFORE removing the producer, so anything still resolving to a
        # tensor of the removed op is dangling
        if self.tensor_aliases:
            stale = [
                guid for guid, repl in self.tensor_aliases.items()
                if (final := self.resolve_tensor(repl)).owner_op is not None
                and final.owner_op.guid == op.guid
            ]
            for guid in stale:
                del self.tensor_aliases[guid]

    def invalidate_topo(self) -> None:
        """Call after rewiring op inputs in place (edge changes the
        add/remove hooks cannot see)."""
        self._topo_cache = None

    def __len__(self):
        return len(self.ops)

    def __contains__(self, op: Op):
        return op.guid in self.ops

    def edges(self) -> List[Edge]:
        out: List[Edge] = []
        for op in self.ops.values():
            for dst_idx, t in enumerate(op.inputs):
                if t.owner_op is not None and t.owner_op.guid in self.ops:
                    out.append(Edge(t.owner_op.guid, op.guid, t.owner_idx,
                                    dst_idx))
        return out

    def in_edges(self, op: Op) -> List[Edge]:
        return [e for e in self.edges() if e.dst == op.guid]

    def out_edges(self, op: Op) -> List[Edge]:
        return [e for e in self.edges() if e.src == op.guid]

    def predecessors(self, op: Op) -> List[Op]:
        seen, out = set(), []
        for t in op.inputs:
            o = t.owner_op
            if o is not None and o.guid in self.ops and o.guid not in seen:
                seen.add(o.guid)
                out.append(o)
        return out

    def successors(self, op: Op) -> List[Op]:
        return [other for other in self.ops.values()
                if any(p.guid == op.guid for p in self.predecessors(other))]

    def roots(self) -> List[Op]:
        dsts = {e.dst for e in self.edges()}
        return [op for g, op in sorted(self.ops.items()) if g not in dsts]

    def leaves(self) -> List[Op]:
        srcs = {e.src for e in self.edges()}
        return [op for g, op in sorted(self.ops.items()) if g not in srcs]

    sinks = leaves
    sources = roots

    # -- dominators (reference: dominators.h; the search's split points) ---
    def post_dominators(self) -> Dict[int, Set[int]]:
        """postdom[n] = the nodes that post-dominate n (n included):
        iterative dataflow over the reversed DAG."""
        guids = [op.guid for op in self.topo_order()]
        succ: Dict[int, Set[int]] = defaultdict(set)
        for e in self.edges():
            succ[e.src].add(e.dst)
        allg = set(guids)
        postdom: Dict[int, Set[int]] = {g: set(allg) for g in guids}
        changed = True
        while changed:
            changed = False
            for g in reversed(guids):
                ss = succ[g]
                if not ss:
                    new = {g}
                else:
                    new = set(allg)
                    for s in ss:
                        new &= postdom[s]
                    new |= {g}
                if new != postdom[g]:
                    postdom[g] = new
                    changed = True
        return postdom

    def bottleneck_nodes(self) -> List[Op]:
        """Nodes every source-to-sink path passes through (sources
        excluded), in topological order (reference: graph.cc
        find_bottleneck_node)."""
        order = self.topo_order()
        if not order:
            return []
        postdom = self.post_dominators()
        sources = self.roots()
        if not sources:
            return []
        common = set.intersection(*[postdom[s.guid] for s in sources])
        src_guids = {s.guid for s in sources}
        return [op for op in order
                if op.guid in common and op.guid not in src_guids]

    def segments(self) -> List[List[Op]]:
        """The topological order split after each bottleneck node: the
        Unity search's sequence-split segments."""
        bottlenecks = {op.guid for op in self.bottleneck_nodes()}
        out: List[List[Op]] = [[]]
        for op in self.topo_order():
            out[-1].append(op)
            if op.guid in bottlenecks:
                out.append([])
        return [s for s in out if s]

    # -- cloning (the joint search's candidate graphs) ---------------------
    def clone(self) -> "Graph":
        """Structural copy: new op shells with copied params and their own
        output tensors (guids kept, so the search's segment memo stays
        valid across candidates), rewired to each other, so rule
        applications on the clone leave this graph as it is. A shell
        shares its op's module registries: the search runs before
        compile draws any weight, and no rewrite touches them."""
        import copy

        new_ops: Dict[int, Op] = {}
        tensor_map: Dict[int, Tensor] = {}
        for g, op in self.ops.items():
            new_op = copy.copy(op)
            new_op.params = dict(op.params)
            new_op.outputs = []
            for t in op.outputs:
                nt = copy.copy(t)
                nt.owner_op = new_op
                tensor_map[t.guid] = nt
                new_op.outputs.append(nt)
            new_ops[g] = new_op
        for op in new_ops.values():
            op.inputs = [tensor_map.get(t.guid, t) for t in op.inputs]
        g2 = Graph()
        g2.ops = new_ops
        return g2

    # -- hashing (reference: graph.h:149 dp_state_hash) --------------------
    def hash(self) -> int:
        """Per-process structural hash (Python's salted `hash` of the op
        types): for in-process memos only."""
        h = 0
        for op in self.topo_order():
            oh = hash((op.op_type, tuple(t.dims for t in op.inputs)))
            h = (h * 1000000007 + oh * 31) & 0x7FFFFFFFFFFFFFFF
        return h

    def split_at(self, op: Op) -> Tuple["Graph", "Graph"]:
        """(prefix through op, suffix) at a bottleneck node."""
        order = self.topo_order()
        idx = order.index(op)
        return Graph(order[:idx + 1]), Graph(order[idx + 1:])

    # -- dot export (reference: --export-strategy-task-graph-file) ---------
    def to_dot(self, include_costs: bool = False,
               costs: Optional[Dict[int, float]] = None,
               labels: Optional[Dict[int, str]] = None) -> str:
        """JAX `Graph.to_dot`: one box a node (name, type, its machine view
        once compiled, an optional label and cost), one arrow an edge."""
        lines = ["digraph PCG {", "  rankdir=TB;"]
        for g, op in sorted(self.ops.items()):
            label = f"{op.name}\\n{op.op_type.value}"
            if op.machine_view:
                label += f"\\n{op.machine_view}"
            if labels and g in labels:
                label += f"\\n{labels[g]}"
            if include_costs and costs and g in costs:
                label += f"\\ncost={costs[g]:.3g}"
            lines.append(f'  n{g} [label="{label}", shape=box];')
        for e in self.edges():
            lines.append(f"  n{e.src} -> n{e.dst};")
        lines.append("}")
        return "\n".join(lines)

    def export_dot(self, path: str, **kw) -> None:
        with open(path, "w") as f:
            f.write(self.to_dot(**kw))

    def topo_order(self) -> List[Op]:
        """The stable Kahn order, cached; every mutation (add_op,
        remove_op, invalidate_topo) drops the cache."""
        if self._topo_cache is None:
            self._topo_cache = self._topo_order_uncached()
        return self._topo_cache

    def _topo_order_uncached(self) -> List[Op]:
        indeg: Dict[int, int] = {g: 0 for g in self.ops}
        succ: Dict[int, List[int]] = defaultdict(list)
        for op in self.ops.values():
            for t in op.inputs:
                src = t.owner_op
                if src is not None and src.guid in self.ops:
                    indeg[op.guid] += 1
                    succ[src.guid].append(op.guid)
        # stable order: seed queue by op guid (construction order)
        q = deque(sorted(g for g, d in indeg.items() if d == 0))
        order: List[Op] = []
        while q:
            g = q.popleft()
            order.append(self.ops[g])
            for s in sorted(set(succ[g])):
                indeg[s] -= succ[g].count(s)
                if indeg[s] == 0:
                    q.append(s)
        if len(order) != len(self.ops):
            raise ValueError("graph has a cycle")
        return order
