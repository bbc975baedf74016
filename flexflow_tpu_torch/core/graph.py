"""Computation graph over Op nodes, host-only: topological order and the
mutation hooks.

Copy of the ordering and mutation halves of flexflow_tpu/core/graph.py
(Graph.edges and topo_order, the same stable Kahn order seeded by op
guid, cached until a mutation; add_op, remove_op, tensor_aliases and
resolve_tensor, invalidate_topo), which serving's graph rewrites
(serving/optimize.py `fold_batchnorm`, through search/substitution.py
`_rewire`) use. Dominators and hashing come with the search slice.
"""
from __future__ import annotations

from collections import defaultdict, deque
from typing import Dict, List, Optional, Sequence

from .op import Op
from .tensor import Tensor


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
