"""PagedKVPool: the serving KV cache block-allocated in fixed-size pages
(the allocator half of flexflow_tpu/serving/sched/kvpool.py).

The device arrays are slot-dense: per attention op one
(num_slots, max_len, heads, head_dim) K and V cache, the layout the decode
kernel reads. A page is `page_size` consecutive positions of one slot, so
page id `slot * pages_per_slot + block` names rows
[block * page_size, (block + 1) * page_size) of that slot. The pool only
allocates; the ContinuousBatcher owns the device arrays.

Left out until their ROADMAP items: the PrefixCache and its band, resize,
and the export/import of the disaggregated handoff (A5), and
`derive_num_slots`, which needs the machine model (A7).
"""
from __future__ import annotations

import math
import threading
from typing import Dict, List

import torch

from ...ffconst import OpType
from ...ops.common import matmul_dtype


class PoolExhausted(RuntimeError):
    """No free slot/pages for an allocation. Under admission control this
    is unreachable for admitted requests."""


class PagedKVPool:
    """Page allocator and accounting over the slot-dense KV caches.
    Thread-safe: the scheduler thread allocates while others read stats."""

    def __init__(self, num_slots: int, max_len: int, page_size: int = 16):
        if num_slots < 1:
            raise ValueError(f"num_slots={num_slots}: need at least one")
        if page_size < 1:
            raise ValueError(f"page_size={page_size}: need >= 1")
        self.num_slots = int(num_slots)
        self.max_len = int(max_len)
        self.page_size = int(page_size)
        self.pages_per_slot = math.ceil(self.max_len / self.page_size)
        self.total_pages = self.num_slots * self.pages_per_slot
        self._lock = threading.Lock()
        self._free_slots: List[int] = list(range(self.num_slots))[::-1]
        # seq_id -> (slot, [page ids]); pages are consecutive blocks of the
        # slot, so len(pages) tracks ceil(tokens / page_size)
        self._table: Dict[object, tuple] = {}
        self._tokens: Dict[object, int] = {}

    def pages_for(self, n_tokens: int) -> int:
        """Pages a sequence of n_tokens occupies (>= 1: even an empty
        reservation pins its first page)."""
        return max(1, math.ceil(n_tokens / self.page_size))

    def alloc(self, seq_id, n_tokens: int) -> int:
        """Claim a free slot and the pages for the sequence's first
        n_tokens (its prompt). Returns the slot index."""
        need = self.pages_for(n_tokens)
        if n_tokens > self.max_len:
            raise PoolExhausted(
                f"sequence of {n_tokens} tokens exceeds the per-slot"
                f" capacity ({self.max_len})")
        with self._lock:
            if seq_id in self._table:
                raise ValueError(f"sequence {seq_id!r} already allocated")
            if not self._free_slots:
                live = sum(len(p) for _, p in self._table.values())
                raise PoolExhausted(
                    f"all {self.num_slots} slots in use ({live} pages live)")
            slot = self._free_slots.pop()
            pages = [slot * self.pages_per_slot + b for b in range(need)]
            self._table[seq_id] = (slot, pages)
            self._tokens[seq_id] = int(n_tokens)
        return slot

    def extend(self, seq_id, n_tokens: int = 1) -> None:
        """Account n_tokens more for a live sequence, pulling in the next
        page(s) of its slot when a block boundary is crossed."""
        with self._lock:
            if seq_id not in self._table:
                raise KeyError(f"sequence {seq_id!r} not allocated")
            slot, pages = self._table[seq_id]
            total = self._tokens[seq_id] + int(n_tokens)
            if total > self.max_len:
                raise PoolExhausted(
                    f"sequence {seq_id!r} grew to {total} tokens, past the"
                    f" per-slot capacity ({self.max_len})")
            need = self.pages_for(total)
            while len(pages) < need:
                pages.append(slot * self.pages_per_slot + len(pages))
            self._tokens[seq_id] = total

    def free(self, seq_id) -> None:
        """Release a sequence's slot and pages (idempotent)."""
        with self._lock:
            ent = self._table.pop(seq_id, None)
            self._tokens.pop(seq_id, None)
            if ent is not None:
                self._free_slots.append(ent[0])

    def slot_of(self, seq_id):
        with self._lock:
            ent = self._table.get(seq_id)
            return ent[0] if ent else None

    def pages_of(self, seq_id) -> List[int]:
        with self._lock:
            ent = self._table.get(seq_id)
            return list(ent[1]) if ent else []

    def pages_used(self) -> int:
        with self._lock:
            return sum(len(pages) for _, pages in self._table.values())

    def free_slot_count(self) -> int:
        with self._lock:
            return len(self._free_slots)

    def utilization(self) -> float:
        """Live pages / capacity, 0..1."""
        return self.pages_used() / self.total_pages

    def stats(self) -> Dict[str, float]:
        return {
            "slots": self.num_slots,
            "slots_free": self.free_slot_count(),
            "pages_used": self.pages_used(),
            "pages_total": self.total_pages,
            "page_size": self.page_size,
            "utilization": round(self.utilization(), 4),
        }


def kv_cache_spec(model) -> List[tuple]:
    """[(op_name, heads, kdim, vdim, torch cache dtype)] for every
    attention op — THE cache geometry, shared by the batcher's allocation
    and `kv_bytes_per_token`. The dtype is the attention compute dtype
    (bf16 under mixed precision)."""
    out = []
    for op in model.graph.ops.values():
        if op.op_type != OpType.MULTIHEAD_ATTENTION:
            continue
        heads = op.params["num_heads"]
        kdim = op.params.get("kdim") or op.params["embed_dim"] // heads
        vdim = op.params.get("vdim") or op.params["embed_dim"] // heads
        cdt = matmul_dtype(model.config, op.inputs[0].dtype.torch_dtype)
        out.append((op.name, heads, kdim, vdim, cdt))
    if not out:
        raise ValueError(
            "model has no multihead_attention ops: nothing to cache")
    return out


def kv_bytes_per_token(model) -> int:
    """Bytes of K+V cache one token position costs across every attention
    op."""
    return sum(heads * (kdim + vdim) * torch.empty((), dtype=cdt).element_size()
               for _, heads, kdim, vdim, cdt in kv_cache_spec(model))
