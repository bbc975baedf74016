"""Disaggregated prefill/decode serving in flexflow_tpu_torch on the CPU
(ROADMAP A5.6 with A10): tests/test_disagg.py's scenarios but the model
repository's (A5.10c) through the port's roles, park, export / import
and DisaggCoordinator, over the port's ContinuousBatcher holding the
JAX test LM's weights.

Against the JAX package: the prefill -> decode handoff's greedy tokens
equal the JAX ContinuousBatcher's unified run on the same prompts
(identical); `export_sequence` descriptors after the same allocations,
and `price_transfer`'s bytes and chunks, equal JAX's (identical), its
priced microseconds within 1e-9 relative (the same machine spec,
examples/machines/multipod_2x8.json, through each package's machine
model). The other scenarios hold the port to its own unified batcher.
"""
import math
import os
import time
import types

import numpy as np
import pytest

from flexflow_tpu.obs.registry import MetricsRegistry as JaxRegistry
from flexflow_tpu.search.machine_model import \
    HierarchicalMachineModel as JaxHierarchical
from flexflow_tpu.search.machine_model import \
    load_machine_spec as jax_load_spec
from flexflow_tpu.serving.fleet import DisaggCoordinator as JaxCoordinator
from flexflow_tpu.serving.sched import ContinuousBatcher as JaxBatcher
from flexflow_tpu.serving.sched.kvpool import PagedKVPool as JaxPool
from flexflow_tpu_torch import params_from_jax
from flexflow_tpu_torch.obs.registry import (MetricsRegistry,
                                             validate_exposition)
from flexflow_tpu_torch.obs.tracing import get_tracer
from flexflow_tpu_torch.resharding.cost import schedule_cost_us
from flexflow_tpu_torch.resharding.plan import (TRANSFER_TIER_CHUNK_BYTES,
                                                plan_slot_migration)
from flexflow_tpu_torch.search.machine_model import (
    HierarchicalMachineModel, load_machine_spec)
from flexflow_tpu_torch.serving.fleet import (Autoscaler, DisaggCoordinator,
                                              Replica, Router)
from flexflow_tpu_torch.serving.sched.bench import build_tiny_lm
from flexflow_tpu_torch.serving.sched.kvpool import (KVGeometryMismatch,
                                                     PagedKVPool)
from tests.conftest import module_xla_cache
from tests.test_generate import _build_lm
from tests.test_torch_zoo import one_torch_thread

_xla_cache = pytest.fixture(scope="module", autouse=True)(module_xla_cache)
_one_thread = pytest.fixture(scope="module", autouse=True)(one_torch_thread)

SPEC_PATH = os.path.join(os.path.dirname(__file__), "..", "examples",
                         "machines", "multipod_2x8.json")


@pytest.fixture(scope="module")
def lms():
    """JAX's test LM and the port's copy of it holding JAX's weights."""
    jm = _build_lm(2, 12)
    pm = build_tiny_lm(2, 12, vocab=50, device="cpu")
    params_from_jax(pm, jm.params)
    return jm, pm


@pytest.fixture(scope="module")
def lm(lms):
    return lms[1]


def _mk_replica(lm, name, role, slots=2, max_len=48):
    return Replica(name, lm, max_len=max_len, num_slots=slots,
                   page_size=4, role=role)


def _prompt(n, seed=0, vocab=50):
    rng = np.random.RandomState(seed)
    return rng.randint(1, vocab, size=(n,)).astype(np.int32)


def _await(pred, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert pred()


# ---------------------------------------------------------------------
# the tentpole: token-exact priced handoff under one trace
# ---------------------------------------------------------------------
def test_disagg_token_parity_priced_handoff_and_trace(lms):
    jm, lm = lms
    prompts = [_prompt(9, seed=i) for i in (1, 2, 3)]
    ref = Replica("u0", lm, max_len=48, num_slots=2, page_size=4)
    try:
        want = [list(ref.submit(p, 5, seed=7 + i).result(timeout=300))
                for i, p in enumerate(prompts)]
    finally:
        ref.stop()
    # the port's unified run is the JAX batcher's
    jb = JaxBatcher(jm, max_len=48, num_slots=2, page_size=4)
    with jb:
        assert want == [
            list(map(int, jb.submit(p, 5, seed=7 + i).result(timeout=300)))
            for i, p in enumerate(prompts)]

    machine = HierarchicalMachineModel.from_json(
        load_machine_spec(SPEC_PATH))
    router = Router(policy="least_loaded")
    router.add_replica("p0", _mk_replica(lm, "p0", "prefill"))
    router.add_replica("d0", _mk_replica(lm, "d0", "decode"))
    coord = DisaggCoordinator(router, machine=machine,
                              device_ids=tuple(range(machine.num_chips)))
    coord.attach_all()
    tracer = get_tracer()
    tracer.clear()
    tracer.enable()
    try:
        frs = []
        for i, p in enumerate(prompts):
            fr = router.submit(p, 5, seed=7 + i)
            # sequential: each handoff sees an empty decode pool, so
            # every request MUST ship (no admission-shed nondeterminism)
            fr.result(timeout=300)
            frs.append(fr)
        got = [list(fr.result(timeout=300)) for fr in frs]
        assert got == want  # token-identical to unified serving
        assert all(fr.handoffs >= 1 for fr in frs)
        _await(lambda: coord.committed >= len(prompts))
        assert coord.failed == 0
        # priced on the hierarchical machine: the two pools span the
        # 16-chip multipod, so the shipment pays the DCN tier
        assert (coord.last_predicted_us or 0.0) > 0.0
        assert coord.predicted_handoff_s(64) > 0.0
        assert coord.stats()["us_per_byte"] > 0.0
        # every handoff span carries the request's ORIGINAL trace id
        stitched = {e["args"].get("trace_id")
                    for e in tracer.events("fleet.kv_handoff")}
        assert all(fr.trace_id in stitched for fr in frs)
        # the ff_disagg_* families render as one valid exposition
        fams = validate_exposition(router.registry.render())
        for f in ("ff_disagg_handoffs_total",
                  "ff_disagg_handoff_bytes_total",
                  "ff_disagg_handoff_chunks_total", "ff_disagg_handoff_ms",
                  "ff_disagg_predicted_transfer_us",
                  "ff_disagg_queue_depth"):
            assert f in fams, f
    finally:
        tracer.disable()
        coord.stop()
        router.shutdown()


def test_no_decode_pool_degrades_to_local_decode(lm):
    router = Router()
    router.add_replica("p0", _mk_replica(lm, "p0", "prefill"))
    coord = DisaggCoordinator(router)
    coord.attach_all()
    try:
        fr = router.submit(_prompt(9, seed=4), 4, seed=3)
        out = fr.result(timeout=300)
        assert len(out) == 4
        assert fr.handoffs == 0  # the handle never rebound
        assert coord.resumed >= 1 and coord.committed == 0
        assert "no READY decode replica" in (coord.last_error or "")
    finally:
        coord.stop()
        router.shutdown()


def test_direct_submit_without_fleet_handle_resumes(lm):
    """A submit that bypassed the router (warmup traffic) has no
    FleetRequest to rebind — the coordinator must decode it locally
    instead of orphaning the caller's stream."""
    router = Router()
    p0 = _mk_replica(lm, "p0", "prefill")
    router.add_replica("p0", p0)
    router.add_replica("d0", _mk_replica(lm, "d0", "decode"))
    coord = DisaggCoordinator(router)
    coord.attach_all()
    try:
        h = p0.submit(_prompt(9, seed=5), 4, seed=1)
        out = h.result(timeout=300)
        assert len(out) == 4
        assert coord.resumed >= 1 and coord.committed == 0
    finally:
        coord.stop()
        router.shutdown()


def test_coordinator_guards(lm):
    router = Router()
    router.add_replica("d0", _mk_replica(lm, "d0", "decode"))
    try:
        coord = DisaggCoordinator(router, start=False)
        # only prefill replicas park — wiring a decode replica is a bug
        with pytest.raises(ValueError, match="prefill"):
            coord.wire(router.replica("d0"))
        # a stopped coordinator rejects enqueues so the batcher's
        # on_parked falls straight back to local decode
        with pytest.raises(RuntimeError, match="stopped"):
            coord.enqueue("d0", object())
        coord.stop()  # idempotent on a never-started coordinator
    finally:
        router.shutdown()


# ---------------------------------------------------------------------
# satellite: pool export/import symmetry + typed geometry errors
# ---------------------------------------------------------------------
def test_kvpool_export_import_symmetry_and_geometry():
    src = PagedKVPool(2, 32, page_size=4)
    dst = PagedKVPool(2, 32, page_size=4)
    src.alloc("a", 10)
    desc = src.export_sequence("a")
    assert desc["n_tokens"] == 10
    assert desc["n_pages"] == len(src.pages_of("a"))
    slot = dst.import_sequence(desc)
    # symmetric accounting: the importer claims exactly the pages the
    # exporter reported, so fleet-wide pages_used is conserved once the
    # source frees
    assert dst.pages_used() == desc["n_pages"]
    assert dst.slot_of("a") == slot
    assert src.pages_used() == desc["n_pages"]  # exporter untouched
    src.free("a")
    assert src.pages_used() == 0
    # geometry mismatches are typed and non-retryable
    with pytest.raises(KVGeometryMismatch, match="page_size"):
        PagedKVPool(2, 32, page_size=8).import_sequence(desc)
    with pytest.raises(KVGeometryMismatch, match="max_len"):
        PagedKVPool(2, 8, page_size=4).import_sequence(desc)
    lying = dict(desc, n_pages=desc["n_pages"] + 1)
    pool = PagedKVPool(2, 32, page_size=4)
    with pytest.raises(KVGeometryMismatch, match="n_pages"):
        pool.import_sequence(lying)
    assert pool.pages_used() == 0  # the refused import undid its alloc
    with pytest.raises(KeyError):
        src.export_sequence("missing")


def test_kvpool_export_descriptors_match_jax():
    """The same allocations, extensions, frees and imports in both
    packages' pools give the same descriptors and refusals."""
    got = []
    for cls in (JaxPool, PagedKVPool):
        src, dst = cls(3, 32, page_size=4), cls(2, 32, page_size=4)
        rec = []
        src.alloc("a", 10)
        src.alloc("b", 3)
        src.extend("b", 6)
        src.free("a")
        src.alloc("c", 17)
        for sid in ("b", "c"):
            desc = src.export_sequence(sid)
            rec.append(desc)
            rec.append(dst.import_sequence(desc, seq_id=f"in-{sid}"))
            rec.append(dst.pages_of(f"in-{sid}"))
        for bad in (dict(rec[0], page_size=8), dict(rec[0], n_tokens=40),
                    dict(rec[0], n_pages=1)):
            try:
                cls(2, 32, page_size=4).import_sequence(bad)
            except ValueError as e:
                rec.append((type(e).__name__, e.field, str(e)))
        got.append(rec)
    assert got[1] == got[0]


# ---------------------------------------------------------------------
# satellite: cross-pool pricing on a tiered machine
# ---------------------------------------------------------------------
def _fake_rep(num_slots, max_len):
    pool = types.SimpleNamespace(num_slots=num_slots, max_len=max_len)
    return types.SimpleNamespace(batcher=types.SimpleNamespace(pool=pool))


def test_cross_pool_pricing_over_dcn_and_chunk_cap():
    machine = HierarchicalMachineModel.from_json(
        load_machine_spec(SPEC_PATH))
    jmachine = JaxHierarchical.from_json(jax_load_spec(SPEC_PATH))
    kv_shapes = {f"kv/l{i}_attn/{p}": ((4, 256, 4, 8), 4)
                 for i in range(2) for p in ("k_cache", "v_cache")}
    cross = plan_slot_migration(kv_shapes, 4, 4, 128,
                                device_ids=tuple(range(16)))
    inner = plan_slot_migration(kv_shapes, 4, 4, 128,
                                device_ids=tuple(range(8)))
    cost_cross = schedule_cost_us(cross, machine)
    cost_inner = schedule_cost_us(inner, machine)
    # a decode pool on the other pod prices over DCN (3.125 GB/s +
    # latency), not the innermost p2p links (2x45 GB/s)
    assert cost_cross > cost_inner > 0.0

    rows = {f"l{i}/k": np.zeros((2048, 64, 64), np.float32)
            for i in range(3)}  # ~100 MB total
    total = sum(r.nbytes for r in rows.values())
    assert total > TRANSFER_TIER_CHUNK_BYTES

    coord = DisaggCoordinator(
        types.SimpleNamespace(), machine=machine,
        device_ids=tuple(range(16)), registry=MetricsRegistry(),
        start=False)
    priced = coord.price_transfer(_fake_rep(4, 4096), _fake_rep(4, 4096),
                                  2048, rows)
    assert priced["cross_tier"] and priced["bytes"] == total
    assert priced["chunks"] \
        == math.ceil(total / TRANSFER_TIER_CHUNK_BYTES) == 2
    assert priced["predicted_us"] > 0.0
    # pools within one pod: no tier crossing, a single chunk, cheaper
    coord_in = DisaggCoordinator(
        types.SimpleNamespace(), machine=machine,
        device_ids=tuple(range(8)), registry=MetricsRegistry(),
        start=False)
    p2 = coord_in.price_transfer(_fake_rep(4, 4096), _fake_rep(4, 4096),
                                 2048, rows)
    assert not p2["cross_tier"] and p2["chunks"] == 1
    assert p2["predicted_us"] < priced["predicted_us"]
    # JAX's coordinator prices the same shipments alike
    for devs, mine in ((tuple(range(16)), priced), (tuple(range(8)), p2)):
        jc = JaxCoordinator(types.SimpleNamespace(), machine=jmachine,
                            device_ids=devs, start=False,
                            registry=JaxRegistry())
        want = jc.price_transfer(_fake_rep(4, 4096), _fake_rep(4, 4096),
                                 2048, rows)
        for key in ("bytes", "chunks", "cross_tier"):
            assert mine[key] == want[key], key
        assert mine["predicted_us"] == pytest.approx(want["predicted_us"],
                                                     rel=1e-9)


# ---------------------------------------------------------------------
# satellite: role-aware predicted TTFT
# ---------------------------------------------------------------------
def test_predicted_ttft_materialized_kv_and_prefill_role(lm):
    from flexflow_tpu_torch.serving.sched import ContinuousBatcher

    # never started: predicted_ttft_s is a pure read of the rate model
    b = ContinuousBatcher(lm, max_len=48, num_slots=2, page_size=4,
                          prefill_chunk_tokens=8)
    b._ewma_prefill_s_per_tok = 0.001
    b._ewma_decode_iter_s = 0.005
    full = b.predicted_ttft_s(100)
    assert full >= 100 * 0.001
    # KV already materialized (whole-prompt prefix hit or a disagg
    # import): admitted on the decode legs only — one decode wall, no
    # prefill-EWMA charge
    assert b.predicted_ttft_s(100, shared_tokens=100) \
        == pytest.approx(0.005)
    # a queued prefill ahead still charges its backlog, never the
    # request's own (absent) prefill
    b._queue.append(types.SimpleNamespace(
        prompt=np.zeros(8, np.int32)))
    assert b.predicted_ttft_s(100, shared_tokens=100) < full

    # a prefill replica charges NO decode-interleave leg: nothing
    # decodes there (parked requests hold pages, not iterations)
    bp = ContinuousBatcher(lm, max_len=48, num_slots=2, page_size=4,
                           prefill_chunk_tokens=8, role="prefill")
    bp._ewma_prefill_s_per_tok = 0.001
    bp._ewma_decode_iter_s = 0.005
    bp._queue.append(types.SimpleNamespace(
        prompt=np.zeros(8, np.int32)))
    assert bp.predicted_ttft_s(16) == pytest.approx((16 + 8) * 0.001)


# ---------------------------------------------------------------------
# satellite: role-scoped autoscalers size the pools independently
# ---------------------------------------------------------------------
def test_autoscaler_role_scoped_pools(lm):
    router = Router()
    router.add_replica("p0", _mk_replica(lm, "p0", "prefill"))
    router.add_replica("d0", _mk_replica(lm, "d0", "decode"))
    try:
        with pytest.raises(ValueError, match="role"):
            Autoscaler(router, role="bogus")
        pre = Autoscaler(router, role="prefill", min_slots=2, max_slots=2,
                         min_replicas=1, idle_ticks_before_drain=1)
        dec = Autoscaler(router, role="decode", min_slots=2, max_slots=2,
                         min_replicas=1, idle_ticks_before_drain=1)
        # max_replicas/min_replicas bound each POOL, not the fleet
        assert pre._pool_size() == 1 and dec._pool_size() == 1
        assert Autoscaler(router)._pool_size() == 2
        # each scaler sees exactly its own pool: with min_replicas=1 and
        # the whole fleet idle, an UNSCOPED scaler would drain a surplus
        # replica — the scoped ones each see a pool already at minimum
        for _ in range(3):
            pre.tick()
            dec.tick()
        assert set(router.replica_names()) == {"p0", "d0"}
        assert not [a for a in pre.log + dec.log
                    if a.get("action") == "drain_replica"]
    finally:
        router.shutdown()


# ---------------------------------------------------------------------
# heavier end-to-end: concurrent mixed pools (slow)
# ---------------------------------------------------------------------
@pytest.mark.slow
def test_disagg_concurrent_fleet_zero_drop_parity():
    lm4 = build_tiny_lm(4, 12, vocab=50, device="cpu")
    params_from_jax(lm4, _build_lm(4, 12).params)
    prompts = [_prompt(10, seed=20 + i) for i in range(6)]
    ref = Replica("u0", lm4, max_len=48, num_slots=4, page_size=4)
    try:
        want = [list(ref.submit(p, 4, seed=i).result(timeout=300))
                for i, p in enumerate(prompts)]
    finally:
        ref.stop()

    router = Router(policy="least_loaded")
    for n in ("p0", "p1"):
        router.add_replica(
            n, _mk_replica(lm4, n, "prefill", slots=4))
    router.add_replica("d0", _mk_replica(lm4, "d0", "decode", slots=4))
    coord = DisaggCoordinator(router)
    coord.attach_all()
    try:
        frs = [router.submit(p, 4, seed=i)
               for i, p in enumerate(prompts)]
        got = [list(fr.result(timeout=300)) for fr in frs]
        # zero drop AND token parity no matter which path each request
        # took (committed handoff or resumed local decode under load)
        assert got == want
        _await(lambda: coord.committed + coord.resumed >= len(prompts))
        assert coord.failed == 0
        assert coord.committed >= 1
    finally:
        coord.stop()
        router.shutdown()
