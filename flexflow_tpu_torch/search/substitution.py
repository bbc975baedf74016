"""Graph rewrites (counterpart of flexflow_tpu/search/substitution.py):
for now only `_rewire`, which serving's batch-norm fold
(serving/optimize.py) uses. The rewrite rules and their search come with
ROADMAP A7.3."""
from __future__ import annotations

from ..core.graph import Graph


def _rewire(graph: Graph, old_tensor, new_tensor, skip_guids=()) -> None:
    """Point every consumer of old_tensor at new_tensor (and record the
    alias for resolve_tensor). skip_guids: ops whose inputs were already
    wired explicitly — e.g. a rewrite's own created ops, which must keep
    consuming the old tensor or the rewrite would cycle through itself."""
    for o in graph.ops.values():
        if o.guid in skip_guids:
            continue
        for i, t in enumerate(o.inputs):
            if t.guid == old_tensor.guid:
                o.inputs[i] = new_tensor
    graph.tensor_aliases[old_tensor.guid] = new_tensor
    graph.invalidate_topo()
