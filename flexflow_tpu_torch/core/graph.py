"""Computation graph over Op nodes, host-only: topological order.

Copy of the ordering half of flexflow_tpu/core/graph.py (Graph.edges and
topo_order, the same stable Kahn order seeded by op guid). Dominators,
hashing and the substitution hooks come with the search slice.
"""
from __future__ import annotations

from collections import defaultdict, deque
from typing import Dict, List, Sequence

from .op import Op


class Graph:
    def __init__(self, ops: Sequence[Op] = ()):
        self.ops: Dict[int, Op] = {op.guid: op for op in ops}

    def __len__(self):
        return len(self.ops)

    def topo_order(self) -> List[Op]:
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
