"""PagedKVPool: the serving KV cache block-allocated in fixed-size pages,
and the PrefixCache over its band (the allocator half of
flexflow_tpu/serving/sched/kvpool.py).

The device arrays are slot-dense: per attention op one
(num_slots, max_len, heads, head_dim) K and V cache, the layout the decode
kernel reads. A page is `page_size` consecutive positions of one slot, so
page id `slot * pages_per_slot + block` names rows
[block * page_size, (block + 1) * page_size) of that slot. The pool only
allocates; the ContinuousBatcher owns the device arrays.

Prefix reuse (`PrefixCache`): cached prefix pages live in a device-side
band of extra slot-shaped rows beside the decode caches, addressed by a
rolling hash of page-aligned token blocks and refcounted by the live
sequences that share them. A prompt whose page-aligned prefix is cached
gets those rows copied into its slot and prefills only the suffix.

Metric families (obs/registry.py, the JAX package's names): the pool's
`ff_kvpool_pages_used` / `ff_kvpool_pages_total` gauges and the cache's
hit, miss and eviction counters and page gauges, labelled by the pool's
`label` so two pools in one process keep their own series; the
process-wide registry unless one is passed.

`derive_num_slots` sizes the batcher's slots from the machine model's
device memory (search/machine_model.py: the H100 spec's 80 GB on a CUDA
config) less the plan's inference footprint (analysis/passes.py
`plan_memory_bytes`), as the JAX package does.

`kv_cache_spec` is the whole model's cache geometry (what
`kv_bytes_per_token` and `derive_num_slots` read, as JAX's do);
`local_kv_cache_spec` and `local_rows` are a mesh rank's part of it (its
heads over `model`, its rows over `data`), which serving on ranks
allocates (serving/generate.py `GenerativeSession`).

Live resize (the serving mesh grew or shrank; ContinuousBatcher
`request_resize`): `PagedKVPool.resize` rewrites the page tables for a
new slot count and `owned_view` gives the rows a sequence's table owns,
the only rows a migration copies.

The disaggregated handoff (ContinuousBatcher `request_export` /
`request_import`): `PagedKVPool.export_sequence` describes a live
sequence (its tokens, pages, geometry and owned row spans) without
touching it, and `import_sequence` allocates the same pages in another
pool after checking the geometry (`KVGeometryMismatch`, typed).
"""
from __future__ import annotations

import hashlib
import itertools
import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...ffconst import OpType
from ...ops.common import matmul_dtype


# the `pool` label of a pool's series: pool0, pool1, ... in one process
_POOL_IDS = itertools.count()


class PoolExhausted(RuntimeError):
    """No free slot/pages for an allocation. Under admission control this
    is unreachable for admitted requests."""


def _chain_key(parent: bytes, block: np.ndarray) -> bytes:
    """Rolling hash over page-aligned token blocks: the key of block i is
    blake2b(key of block i-1, tokens of block i), so two prompts share
    exactly the entries of their common page-aligned prefix. Lookups
    re-verify the stored tokens, so a collision is a miss, never wrong
    KV."""
    h = hashlib.blake2b(digest_size=16)
    h.update(parent)
    h.update(np.ascontiguousarray(block, dtype=np.int64).tobytes())
    return h.digest()


def prefix_route_chain(tokens, page_size: int = 16) -> List[str]:
    """The hex chain keys of a prompt's full page-aligned blocks: entry i
    is the key of blocks 0..i, the address a PrefixCache files that
    prefix page under, computed without a pool. Empty for a prompt
    shorter than one page."""
    tokens = np.asarray(tokens)
    if int(page_size) < 1:
        raise ValueError(f"page_size={page_size}: need >= 1")
    chain: List[str] = []
    parent = b""
    for b in range(int(tokens.size) // int(page_size)):
        parent = _chain_key(parent,
                            tokens[b * page_size:(b + 1) * page_size])
        chain.append(parent.hex())
    return chain


def prefix_route_key(tokens, page_size: int = 16, depth: int = 1) -> str:
    """The chain key of a prompt's first `depth` full pages ("" when it
    has no full page): requests that share a system prompt share it."""
    if int(depth) < 1:
        raise ValueError(f"depth={depth}: need >= 1")
    chain = prefix_route_chain(tokens, page_size=page_size)
    if not chain:
        return ""
    return chain[min(int(depth), len(chain)) - 1]


class _PrefixEntry:
    """One immutable cached prefix page: the K/V rows of one page-aligned
    token block in a band page. `refcount` counts the live sequences that
    share it; only refcount-0 entries are evictable."""

    __slots__ = ("key", "parent", "tokens", "page", "refcount", "tick",
                 "hits")

    def __init__(self, key: bytes, parent: bytes, tokens: np.ndarray,
                 page: int):
        self.key = key
        self.parent = parent
        self.tokens = tokens
        self.page = page
        self.refcount = 0
        self.tick = 0
        self.hits = 0


class PrefixCache:
    """Hash-addressed store of immutable, refcounted prefix pages.

    Entries are page-aligned token blocks keyed by `_chain_key`, each
    owning one page of the band (the batcher owns the arrays; the cache
    hands out band page ids). A scheduled prompt's longest cached prefix
    is pinned (`acquire`) and its rows copied into the sequence's slot;
    only the suffix is prefilled. The slot's rows are the sequence's
    private copy, so a band page is written once, at insert, and reused
    only after eviction, which a refcount above 0 blocks. `cow_break`
    unshares a sequence from a position onward. Eviction is LRU over
    refcount-0 entries under `capacity_pages`.
    """

    def __init__(self, capacity_pages: int, page_size: int,
                 registry=None, label: Optional[str] = None):
        if capacity_pages < 1:
            raise ValueError(
                f"capacity_pages={capacity_pages}: need >= 1 (omit the"
                " cache entirely to disable prefix reuse)")
        if page_size < 1:
            raise ValueError(f"page_size={page_size}: need >= 1")
        self.capacity = int(capacity_pages)
        self.page_size = int(page_size)
        self.label = label or f"pool{next(_POOL_IDS)}"
        self._lock = threading.Lock()
        self._entries: Dict[bytes, _PrefixEntry] = {}
        self._free_pages: List[int] = list(range(self.capacity))[::-1]
        self._pins: Dict[object, List[_PrefixEntry]] = {}
        self._ticks = itertools.count(1)
        self._pages_saved = 0
        self._inserts = 0
        self._evictions = 0
        if registry is None:
            from ...obs.registry import REGISTRY as registry  # noqa: N813
        self._c_hits = registry.counter(
            "ff_prefix_cache_hits_total",
            "Scheduled requests that installed >=1 cached prefix page",
            labels=("pool",))
        self._c_misses = registry.counter(
            "ff_prefix_cache_misses_total",
            "Scheduled requests with no cached prefix", labels=("pool",))
        self._c_evictions = registry.counter(
            "ff_prefix_cache_evictions_total",
            "Prefix pages evicted (LRU, refcount-0)", labels=("pool",))
        self._g_pages = registry.gauge(
            "ff_prefix_cache_pages",
            "Band pages holding cached prefix KV", labels=("pool",))
        self._g_saved = registry.gauge(
            "ff_kvpool_pages_saved",
            "Cumulative prefill pages skipped via prefix reuse",
            labels=("pool",))
        self._c_hits.inc(0, pool=self.label)
        self._c_misses.inc(0, pool=self.label)
        self._g_pages.set(0, pool=self.label)
        self._g_saved.set(0, pool=self.label)

    # -- lookup ------------------------------------------------------------
    def _walk(self, tokens: np.ndarray) -> List[_PrefixEntry]:
        """Longest cached chain over the prompt's full blocks (lock held),
        content-verified."""
        tokens = np.asarray(tokens)
        out: List[_PrefixEntry] = []
        parent = b""
        for b in range(int(tokens.size) // self.page_size):
            blk = tokens[b * self.page_size:(b + 1) * self.page_size]
            key = _chain_key(parent, blk)
            e = self._entries.get(key)
            if e is None or not np.array_equal(e.tokens, blk):
                break
            out.append(e)
            parent = key
        return out

    def match(self, tokens) -> Tuple[int, List[_PrefixEntry]]:
        """Probe only (no pin, no hit or miss counted): the longest cached
        prefix as (matched tokens, entries)."""
        with self._lock:
            entries = self._walk(tokens)
            return len(entries) * self.page_size, list(entries)

    def match_chain(self, chain: Sequence[str]) -> int:
        """Depth in full pages of the longest cached run of a precomputed
        `prefix_route_chain` (key presence only: a routing hint)."""
        with self._lock:
            depth = 0
            for hexkey in chain:
                if bytes.fromhex(hexkey) not in self._entries:
                    break
                depth += 1
            return depth

    def acquire(self, seq_id, tokens, max_pages: Optional[int] = None
                ) -> Tuple[int, List[_PrefixEntry]]:
        """Pin the longest cached prefix (at most `max_pages` pages) for a
        sequence being scheduled, until `release`. Returns (matched
        tokens, entries) for the caller to copy into the slot."""
        with self._lock:
            if seq_id in self._pins:
                raise ValueError(f"sequence {seq_id!r} already holds pins")
            entries = self._walk(tokens)
            if max_pages is not None:
                entries = entries[:max(0, int(max_pages))]
            tick = next(self._ticks)
            for e in entries:
                e.refcount += 1
                e.tick = tick
                e.hits += 1
            if entries:
                self._pins[seq_id] = entries
                self._pages_saved += len(entries)
                self._c_hits.inc(pool=self.label)
                self._g_saved.set(self._pages_saved, pool=self.label)
            else:
                self._c_misses.inc(pool=self.label)
            return len(entries) * self.page_size, list(entries)

    def release(self, seq_id) -> None:
        """Drop a sequence's pins (idempotent)."""
        with self._lock:
            for e in self._pins.pop(seq_id, ()):
                e.refcount -= 1

    def cow_break(self, seq_id, pos: int) -> int:
        """The sequence is about to write at `pos`: release its pins from
        the block holding `pos` onward (its slot rows are already its own
        copy; the cached pages are never touched). Returns the number of
        entries unshared."""
        with self._lock:
            pins = self._pins.get(seq_id)
            if not pins:
                return 0
            keep = max(0, int(pos)) // self.page_size
            broken = pins[keep:]
            del pins[keep:]
            for e in broken:
                e.refcount -= 1
            if not pins:
                self._pins.pop(seq_id, None)
            return len(broken)

    def shared_tokens(self, seq_id) -> int:
        """Prompt tokens of the sequence backed by pinned pages."""
        with self._lock:
            return len(self._pins.get(seq_id, ())) * self.page_size

    # -- insert / evict ----------------------------------------------------
    def insert(self, tokens, n_tokens: int, copy_pages) -> int:
        """Register every full page of tokens[:n_tokens] not yet cached.
        `copy_pages(pairs)`, pairs a list of (block index, band page),
        copies all new blocks' K/V rows into their band pages in one call
        before the entries become matchable. With the budget spent and
        nothing evictable it inserts fewer pages, never raises. Returns
        the number of pages inserted."""
        tokens = np.asarray(tokens)
        n_full = max(0, int(n_tokens)) // self.page_size
        with self._lock:
            parent = b""
            tick = next(self._ticks)
            fresh: List[tuple] = []  # (block, page, key, parent, tokens)
            for b in range(n_full):
                blk = tokens[b * self.page_size:(b + 1) * self.page_size]
                key = _chain_key(parent, blk)
                e = self._entries.get(key)
                if e is not None and np.array_equal(e.tokens, blk):
                    e.tick = tick  # re-validated: keep the chain hot
                    parent = key
                    continue
                if e is not None:
                    break  # a true hash collision: keep the resident entry
                page = self._claim_page()
                if page is None:
                    break  # budget spent, nothing evictable
                fresh.append((b, page, key, parent,
                              np.array(blk, copy=True)))
                parent = key
            if not fresh:
                return 0
            copy_pages([(b, page) for b, page, _, _, _ in fresh])
            for b, page, key, par, blk in fresh:
                e = _PrefixEntry(key, par, blk, page)
                e.tick = tick
                self._entries[key] = e
            self._inserts += len(fresh)
            self._g_pages.set(self.capacity - len(self._free_pages),
                              pool=self.label)
        return len(fresh)

    def _claim_page(self) -> Optional[int]:
        """A free band page, evicting the least recently used refcount-0
        entry if none (lock held)."""
        if self._free_pages:
            return self._free_pages.pop()
        victim = None
        for e in self._entries.values():
            if e.refcount == 0 and (victim is None or e.tick < victim.tick):
                victim = e
        if victim is None:
            return None
        del self._entries[victim.key]
        self._evictions += 1
        self._c_evictions.inc(pool=self.label)
        return victim.page

    # -- accounting --------------------------------------------------------
    def pages_in_use(self) -> int:
        with self._lock:
            return self.capacity - len(self._free_pages)

    def entry_count(self) -> int:
        with self._lock:
            return len(self._entries)

    def refcount_of(self, tokens) -> List[int]:
        """Refcounts along the cached chain of `tokens`."""
        with self._lock:
            return [e.refcount for e in self._walk(tokens)]

    def pages_saved(self) -> int:
        with self._lock:
            return self._pages_saved

    def stats(self) -> Dict[str, float]:
        with self._lock:
            hits = self._c_hits.value(pool=self.label)
            misses = self._c_misses.value(pool=self.label)
            return {
                "capacity_pages": self.capacity,
                "pages_in_use": self.capacity - len(self._free_pages),
                "entries": len(self._entries),
                "hits": int(hits),
                "misses": int(misses),
                "inserts": self._inserts,
                "evictions": self._evictions,
                "pages_saved": self._pages_saved,
            }


class KVGeometryMismatch(ValueError):
    """An exported sequence cannot land in this pool: the importer's page
    geometry differs from the exporter's. Page ids mean something only
    under one (page_size, max_len) regime, so the handoff treats this as
    a typed routing error that no retry fixes."""

    def __init__(self, field: str, exporter, importer):
        self.field = field
        self.exporter = exporter
        self.importer = importer
        super().__init__(
            f"kv import geometry mismatch on {field!r}: exporter has"
            f" {exporter}, importing pool has {importer}")


class PagedKVPool:
    """Page allocator and accounting over the slot-dense KV caches.
    Thread-safe: the scheduler thread allocates while others read stats."""

    def __init__(self, num_slots: int, max_len: int, page_size: int = 16,
                 registry=None, label: Optional[str] = None,
                 prefix_cache_pages: int = 0):
        if num_slots < 1:
            raise ValueError(f"num_slots={num_slots}: need at least one")
        if page_size < 1:
            raise ValueError(f"page_size={page_size}: need >= 1")
        self.num_slots = int(num_slots)
        self.max_len = int(max_len)
        self.page_size = int(page_size)
        self.pages_per_slot = math.ceil(self.max_len / self.page_size)
        self.total_pages = self.num_slots * self.pages_per_slot
        # the `pool` label of this pool's series: two pools in one process
        # must not clobber each other's gauges
        self.label = label or f"pool{next(_POOL_IDS)}"
        # prefix reuse (0 pages: off). Its pages live in the band,
        # `band_slots` slot-shaped rows the batcher allocates beside the
        # decode caches; a slot shorter than one page holds no full page,
        # so then the cache is off
        self.prefix: Optional[PrefixCache] = (
            PrefixCache(prefix_cache_pages, self.page_size,
                        registry=registry, label=self.label)
            if prefix_cache_pages and self.max_len >= self.page_size
            else None)
        self._lock = threading.Lock()
        self._free_slots: List[int] = list(range(self.num_slots))[::-1]
        # seq_id -> (slot, [page ids]); pages are consecutive blocks of the
        # slot, so len(pages) tracks ceil(tokens / page_size)
        self._table: Dict[object, tuple] = {}
        self._tokens: Dict[object, int] = {}
        if registry is None:
            from ...obs.registry import REGISTRY as registry  # noqa: N813
        self._g_used = registry.gauge(
            "ff_kvpool_pages_used", "KV-cache pages currently allocated",
            labels=("pool",))
        self._g_total = registry.gauge(
            "ff_kvpool_pages_total", "KV-cache pool capacity in pages",
            labels=("pool",))
        self._g_total.set(self.total_pages, pool=self.label)
        self._g_used.set(0, pool=self.label)

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
        self._sync_gauges()
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
        self._sync_gauges()

    @property
    def full_pages_per_slot(self) -> int:
        """Full pages one slot's rows hold: the band packs only full
        pages (a page in a slot's partial tail would run past its edge)."""
        return self.max_len // self.page_size

    @property
    def band_slots(self) -> int:
        """Slot-shaped rows the band needs (0 with prefix reuse off)."""
        if self.prefix is None:
            return 0
        return math.ceil(self.prefix.capacity / self.full_pages_per_slot)

    def band_coords(self, page: int) -> Tuple[int, int]:
        """(band slot, first row) of a band page."""
        full = self.full_pages_per_slot
        return page // full, (page % full) * self.page_size

    def free(self, seq_id) -> None:
        """Release a sequence's slot and pages and its prefix pins
        (idempotent)."""
        if self.prefix is not None:
            self.prefix.release(seq_id)
        with self._lock:
            ent = self._table.pop(seq_id, None)
            self._tokens.pop(seq_id, None)
            if ent is None:
                return
            self._free_slots.append(ent[0])
        self._sync_gauges()

    def slot_of(self, seq_id):
        with self._lock:
            ent = self._table.get(seq_id)
            return ent[0] if ent else None

    def pages_of(self, seq_id) -> List[int]:
        with self._lock:
            ent = self._table.get(seq_id)
            return list(ent[1]) if ent else []

    # -- live resize (JAX kvpool.py:563-630) ---------------------------------
    def owned_view(self, seq_id) -> List[Tuple[int, int, int]]:
        """(slot, row_lo, row_hi) spans of the cache rows `seq_id` owns by
        its page table, adjacent pages merged. A freed page's rows stay in
        the device arrays until reused, so everything outside these spans
        is stale: a migration copies these rows and no others."""
        with self._lock:
            ent = self._table.get(seq_id)
            if ent is None:
                return []
            slot, pages = ent
            spans: List[Tuple[int, int, int]] = []
            for p in pages:
                lo = (p - slot * self.pages_per_slot) * self.page_size
                hi = min(lo + self.page_size, self.max_len)
                if spans and spans[-1][0] == slot and spans[-1][2] == lo:
                    spans[-1] = (slot, spans[-1][1], hi)
                else:
                    spans.append((slot, lo, hi))
            return spans

    def resize(self, new_num_slots: int) -> List[Tuple[object, int, int,
                                                       int]]:
        """Rewrite the page tables for `new_num_slots` decode slots, the
        per-slot geometry unchanged: a sequence whose slot survives keeps
        it, one whose slot is gone moves into the lowest free surviving
        slot. Raises PoolExhausted when the live sequences exceed the new
        count (the batcher defers the resize until enough finish).
        Returns every live sequence's (seq_id, old_slot, new_slot,
        n_pages): the device arrays are made anew, so even a sequence
        that kept its slot has its owned rows copied."""
        new_num_slots = int(new_num_slots)
        if new_num_slots < 1:
            raise ValueError(f"new_num_slots={new_num_slots}: need >= 1")
        with self._lock:
            live = sorted(self._table.items(), key=lambda kv: kv[1][0])
            if len(live) > new_num_slots:
                raise PoolExhausted(
                    f"{len(live)} live sequences exceed the new capacity"
                    f" ({new_num_slots} slots); drain first")
            keep = {slot for _, (slot, _) in live if slot < new_num_slots}
            free_new = [s for s in range(new_num_slots) if s not in keep]
            free_new.reverse()  # pop() yields the lowest index first
            moves: List[Tuple[object, int, int, int]] = []
            pps = self.pages_per_slot
            for seq_id, (slot, pages) in live:
                new_slot = slot if slot < new_num_slots else free_new.pop()
                self._table[seq_id] = (
                    new_slot, [new_slot * pps + p - slot * pps
                               for p in pages])
                moves.append((seq_id, slot, new_slot, len(pages)))
            taken = {m[2] for m in moves}
            self._free_slots = [s for s in range(new_num_slots)
                                if s not in taken][::-1]
            self.num_slots = new_num_slots
            self.total_pages = new_num_slots * pps
        self._g_total.set(self.total_pages, pool=self.label)
        self._sync_gauges()
        return moves

    # -- the disaggregated handoff (JAX kvpool.py:633-680) -------------------
    def export_sequence(self, seq_id) -> Dict[str, object]:
        """A live sequence's page-table state for a handoff to another
        pool. Read-only: the sequence stays allocated here (its prefix
        pins too) until the caller frees it after the import commits, so
        a failed handoff leaves this pool as it was. The descriptor
        carries the geometry the importer must match and the owned row
        spans, the only rows the copy ships."""
        with self._lock:
            ent = self._table.get(seq_id)
            if ent is None:
                raise KeyError(f"sequence {seq_id!r} not allocated")
            n_tokens = self._tokens[seq_id]
            n_pages = len(ent[1])
        return {
            "seq_id": seq_id,
            "n_tokens": int(n_tokens),
            "n_pages": int(n_pages),
            "page_size": self.page_size,
            "max_len": self.max_len,
            "spans": self.owned_view(seq_id),
        }

    def import_sequence(self, desc: Dict[str, object], seq_id=None) -> int:
        """Allocate an exported sequence in this pool and return its slot:
        the geometry checked (`KVGeometryMismatch`), the pages claimed
        equal to those the exporter reported (so the fleet's pages in use
        are conserved once the exporter frees), `PoolExhausted` when no
        slot is free. The import takes no prefix-cache pins: the shipped
        rows are the sequence's own copy."""
        sid = seq_id if seq_id is not None else desc["seq_id"]
        if int(desc["page_size"]) != self.page_size:
            raise KVGeometryMismatch(
                "page_size", desc["page_size"], self.page_size)
        if int(desc["n_tokens"]) > self.max_len:
            raise KVGeometryMismatch(
                "max_len", f"{desc['n_tokens']} live tokens"
                f" (max_len {desc['max_len']})", self.max_len)
        slot = self.alloc(sid, int(desc["n_tokens"]))
        got = len(self.pages_of(sid))
        if got != int(desc["n_pages"]):
            # the same page size and token count give the same pages: the
            # descriptor is wrong, so undo and refuse
            self.free(sid)
            raise KVGeometryMismatch("n_pages", desc["n_pages"], got)
        return slot

    def pages_used(self) -> int:
        with self._lock:
            return sum(len(pages) for _, pages in self._table.values())

    def free_slot_count(self) -> int:
        with self._lock:
            return len(self._free_slots)

    def live_sequences(self) -> int:
        with self._lock:
            return len(self._table)

    def utilization(self) -> float:
        """Live pages / capacity, 0..1."""
        return self.pages_used() / self.total_pages

    def stats(self) -> Dict[str, float]:
        out = {
            "slots": self.num_slots,
            "slots_free": self.free_slot_count(),
            "pages_used": self.pages_used(),
            "pages_total": self.total_pages,
            "page_size": self.page_size,
            "utilization": round(self.utilization(), 4),
        }
        if self.prefix is not None:
            out["prefix"] = self.prefix.stats()
        return out

    def _sync_gauges(self) -> None:
        self._g_used.set(self.pages_used(), pool=self.label)


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


def local_kv_cache_spec(model) -> List[tuple]:
    """`kv_cache_spec` with each op's heads this rank holds: h / tp where
    the op's K projection is sharded over `model`, all of them
    otherwise. On one device it is `kv_cache_spec`."""
    by_name = {op.name: op for op in model.graph.ops.values()}
    out = []
    for name, heads, kdim, vdim, cdt in kv_cache_spec(model):
        pt = by_name[name].shards.get("wk")
        if pt is not None:
            heads //= pt.dims[1].degree
        out.append((name, heads, kdim, vdim, cdt))
    return out


def local_rows(model, rows: int) -> int:
    """The rows of a `rows`-row batch this rank walks: rows / dp where the
    mesh's `data` degree divides them (the model cuts its batch so,
    FFModel._data_slice), all of them otherwise."""
    dp = model.mesh.size("data") if model.mesh is not None else 1
    return rows // dp if dp > 1 and rows % dp == 0 else rows


def kv_bytes_per_token(model) -> int:
    """Bytes of K+V cache one token position costs across every attention
    op."""
    return sum(heads * (kdim + vdim) * torch.empty((), dtype=cdt).element_size()
               for _, heads, kdim, vdim, cdt in kv_cache_spec(model))


def derive_num_slots(model, max_len: int, machine=None,
                     max_slots: int = 64, min_slots: int = 1) -> int:
    """Slots the machine's device memory can hold (JAX
    `derive_num_slots`): (memory - model inference footprint) / (KV bytes
    per token x max_len), clamped to [min_slots, max_slots]. The footprint
    is `analysis.plan_memory_bytes` with optimizer_state_factor=1 (serving
    keeps weights, not optimizer moments). The budget is the machine
    spec's memory (`machine.memory_budget_bytes()`), not what the device
    reports free, exactly as the JAX package budgets the spec's HBM."""
    from ...analysis import plan_memory_bytes

    if machine is None:
        from ...search.machine_model import make_machine_model

        machine = make_machine_model(
            model.config, max(1, model.config.total_devices))
    model_bytes, _, _ = plan_memory_bytes(
        model.graph, machine, model.config, optimizer_state_factor=1.0)
    free = machine.memory_budget_bytes() - model_bytes
    per_slot = kv_bytes_per_token(model) * int(max_len)
    slots = int(free // per_slot) if per_slot > 0 else min_slots
    return max(int(min_slots), min(int(max_slots), slots))
