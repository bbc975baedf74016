"""The serving mesh resize of flexflow_tpu_torch on the CPU, held against
the JAX package (tests/test_mesh_resize.py's scenarios, and
tests/test_spec_decode.py:134's resize under speculation):

 - PagedKVPool.owned_view / resize: the same spans, moves, free lists and
   refusals as JAX's pool, call for call;
 - the ContinuousBatcher's live migration: in-flight requests keep the
   greedy tokens of an unresized run, which are the JAX batcher's, with
   zero drops; only rows the page tables own reach the new arrays; a
   shrink waits until the live sequences fit and holds admissions
   (admitted, queued, never rejected) meanwhile; a second resize is
   refused while one is pending, and any after stop; a resize applies
   while idle; every resize is priced, recorded and its dispatches
   rebuilt;
 - a speculative batcher's draft caches migrate with the target's.
"""
import threading
import time

import numpy as np
import pytest
import torch

from flexflow_tpu.serving.sched import ContinuousBatcher as JaxBatcher
from flexflow_tpu.serving.sched import PagedKVPool as JaxPool
from flexflow_tpu.serving.sched import PoolExhausted as JaxPoolExhausted
from flexflow_tpu_torch import params_from_jax
from flexflow_tpu_torch.obs.registry import MetricsRegistry
from flexflow_tpu_torch.obs.tracing import get_tracer
from flexflow_tpu_torch.serving.sched import (AdmissionError, BatcherStopped,
                                              ContinuousBatcher, PagedKVPool,
                                              PoolExhausted)
from flexflow_tpu_torch.serving.sched.bench import build_tiny_lm
from tests.conftest import module_xla_cache
from tests.test_generate import _build_lm
from tests.test_torch_zoo import one_torch_thread

_xla_cache = pytest.fixture(scope="module", autouse=True)(module_xla_cache)
_one_thread = pytest.fixture(scope="module", autouse=True)(one_torch_thread)

WAIT_S = 300


@pytest.fixture(scope="module")
def lms():
    """JAX's test LM and the port's copy of it (JAX's weights)."""
    jm = _build_lm(2, 12)
    pm = build_tiny_lm(2, 12, vocab=50, device="cpu")
    params_from_jax(pm, jm.params)
    return jm, pm


def _prompts(lens, seed=0, vocab=50):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, size=(n,)).astype(np.int32)
            for n in lens]


def _wait_for(cond):
    deadline = time.monotonic() + 120
    while not cond():
        assert time.monotonic() < deadline
        time.sleep(0.005)


# ---------------------------------------------------------------------
# PagedKVPool.owned_view and resize, call for call against JAX's pool
# ---------------------------------------------------------------------
def _both(num_slots, max_len, page_size):
    return [cls(num_slots=num_slots, max_len=max_len, page_size=page_size)
            for cls in (JaxPool, PagedKVPool)]


def test_owned_view_spans_follow_page_table():
    views = []
    for pool in _both(2, 16, 4):
        slot = pool.alloc("a", 6)  # 2 pages -> rows [0, 8)
        v = [pool.owned_view("a")]
        pool.extend("a", 3)  # 9 tokens -> 3 pages -> rows [0, 12)
        v.append(pool.owned_view("a"))
        pool.free("a")  # freed: nothing owned, the rows still hold KV
        v += [pool.owned_view("a"), pool.owned_view("never-allocated")]
        views.append(v)
        assert v == [[(slot, 0, 8)], [(slot, 0, 12)], [], []]
    assert views[0] == views[1]


def test_owned_view_clamps_partial_tail_page():
    views = []
    for pool in _both(1, 10, 4):
        slot = pool.alloc("a", 10)  # 3 pages, the last covers rows 8..9
        views.append(pool.owned_view("a"))
        assert views[-1] == [(slot, 0, 10)]
    assert views[0] == views[1]


def test_resize_rewrites_tables_and_freelist():
    got = []
    for pool in _both(4, 16, 4):
        assert (pool.alloc("a", 5), pool.alloc("b", 3)) == (0, 1)
        rec = [pool.resize(2), pool.num_slots, pool.total_pages,
               pool.free_slot_count()]
        with pytest.raises((PoolExhausted, JaxPoolExhausted)):
            pool.alloc("c", 1)
        # grow back: slots keep their indices, new capacity frees up
        rec += [pool.resize(4), pool.free_slot_count(), pool.alloc("c", 1)]
        got.append(rec)
    assert got[1] == got[0]
    assert got[1][:4] == [[("a", 0, 0, 2), ("b", 1, 1, 1)], 2, 8, 0]
    assert got[1][6] in (2, 3)


def test_resize_relocates_out_of_range_slots():
    got = []
    for pool in _both(4, 16, 4):
        for sid in ("a", "b", "c", "d"):
            pool.alloc(sid, 5)
        pool.free("a")
        pool.free("b")
        moves = pool.resize(2)
        # c (slot 2) and d (slot 3) move into the surviving slots 0 and 1
        assert sorted(m[2] for m in moves) == [0, 1]
        for sid, _, new_slot, n_pages in moves:
            assert pool.slot_of(sid) == new_slot
            assert pool.pages_of(sid) == [
                new_slot * pool.pages_per_slot + b for b in range(n_pages)]
            assert pool.owned_view(sid) == [(new_slot, 0, 8)]
        got.append((moves, [pool.owned_view(s) for s in "cd"]))
    assert got[0] == got[1]


def test_resize_refuses_when_live_exceeds_target():
    for pool in _both(3, 16, 4):
        for sid in ("a", "b", "c"):
            pool.alloc(sid, 4)
        with pytest.raises((PoolExhausted, JaxPoolExhausted),
                           match="drain first"):
            pool.resize(2)
        # the state is untouched by the refusal
        assert pool.num_slots == 3 and pool.live_sequences() == 3


# ---------------------------------------------------------------------
# the batcher's migration
# ---------------------------------------------------------------------
def test_resize_mid_decode_token_parity_and_zero_drops(lms):
    """Shrink then grow while requests decode: every request's greedy
    tokens equal an unresized run's and the JAX batcher's, nothing is
    dropped, and each resize is priced, recorded, spanned and counted,
    its dispatches built anew."""
    jm, pm = lms
    prompts = _prompts([6, 5, 7, 6, 5, 6])
    # staggered budgets: the two long requests still decode when the
    # short ones retire, so BOTH resizes migrate live sequences
    n_new = [40, 40, 16, 16, 12, 12]
    with JaxBatcher(jm, max_len=48, num_slots=4, page_size=4,
                    max_queue=16) as jb:
        ref = [h.result(timeout=WAIT_S).tolist()
               for h in [jb.submit(p, n) for p, n in zip(prompts, n_new)]]

    def run(resize):
        reg = MetricsRegistry()
        b = ContinuousBatcher(pm, max_len=48, num_slots=4, page_size=4,
                              max_queue=16, registry=reg)
        with b:
            handles = [b.submit(p, n) for p, n in zip(prompts, n_new)]
            if resize:
                _wait_for(lambda: any(h.tokens for h in handles))
                old = (b._decode_call, b._caches)
                shrink = b.request_resize(2).wait(timeout=WAIT_S)
                grow = b.request_resize(4).wait(timeout=WAIT_S)
                assert shrink["to"] == 2 and grow["to"] == 4
                assert shrink["migrated_rows"] > 0
                assert grow["migrated_rows"] > 0
                for r in (shrink, grow):
                    assert r["predicted_us"] > 0 and r["bytes_moved"] > 0
                assert b._decode_call is not old[0]
                assert b._caches is not old[1]
            toks = [h.result(timeout=WAIT_S).tolist() for h in handles]
            assert all(h.error is None for h in handles)
        return toks, b, reg

    plain, _, _ = run(resize=False)
    tracer = get_tracer()
    tracer.enable()
    try:
        toks, b, reg = run(resize=True)
        spans = [e for e in tracer.events() if e["name"] == "serve.resize"]
    finally:
        tracer.disable()
        tracer.clear()
    assert toks == plain == ref
    assert [r["direction"] for r in b.stats()["resizes"]] \
        == ["shrink", "grow"]
    assert b.num_slots == 4 and b.pool.num_slots == 4
    assert len(spans) == 2
    assert "ff_serving_resizes_total" in reg.render()


def _nonzero_slots(batcher):
    """Slots holding any nonzero KV in the (drained) batcher's caches,
    row 0 excluded: every decode iteration writes a dummy row-0 entry
    into inactive slots."""
    hot = set()
    for pair in batcher._caches.values():
        for arr in pair.values():
            sums = arr[:, 1:].float().abs().sum(
                dim=tuple(range(1, arr.dim())))
            hot |= {int(s) for s in torch.nonzero(sums).flatten()}
    return hot


def test_resize_never_copies_stale_pages(lms):
    """A finished request's rows stay in the device arrays, but its pages
    are no longer owned: a resize migrates only owned rows, so the
    finished sequence's KV is not in the new arrays."""
    _, pm = lms

    def run(resize):
        b = ContinuousBatcher(pm, max_len=48, num_slots=3, page_size=4,
                              max_queue=8)
        with b:
            # both queued under the scheduler's lock, so one admission
            # pass gives them distinct slots (else the short one may
            # finish before the long one is submitted, which then reuses
            # its slot); the short one finishes first, leaving its rows
            # stale
            with b._cv:
                short = b.submit(_prompts([6], seed=1)[0], 2)
                long_req = b.submit(_prompts([6], seed=2)[0], 30)
            short.result(timeout=WAIT_S)
            _wait_for(lambda: long_req.tokens)
            if resize:
                res = b.request_resize(2).wait(timeout=WAIT_S)
                assert res["in_flight"] == 1
                assert res["migrated_rows"] > 0
            long_req.result(timeout=WAIT_S)
            assert long_req.error is None
        return b

    assert len(_nonzero_slots(run(resize=False))) == 2
    b_res = run(resize=True)
    assert b_res.num_slots == 2
    assert len(_nonzero_slots(b_res)) == 1


def test_shrink_defers_until_live_fits_and_holds_admissions(lms):
    _, pm = lms
    b = ContinuousBatcher(pm, max_len=48, num_slots=3, page_size=4,
                          max_queue=8)
    with b:
        a = b.submit(_prompts([5], seed=3)[0], 40)
        c = b.submit(_prompts([5], seed=4)[0], 40)
        _wait_for(lambda: a.tokens and c.tokens)
        ticket = b.request_resize(1)
        # two live sequences > target 1: the resize stays deferred WHILE
        # both are live and decoding goes on; a request queued meanwhile
        # is not admitted to a slot (the invariant, read only while both
        # requests are provably unfinished)
        d = None
        deadline = time.monotonic() + 120
        while not (a.done() or c.done()):
            if ticket.done() or b.num_slots != 3:
                assert a.done() or c.done()
                break
            if d is None:
                d = b.submit(_prompts([5], seed=5)[0], 2)
            elif not ticket.done():
                assert not d.tokens
            assert time.monotonic() < deadline
            time.sleep(0.005)
        if d is None:
            d = b.submit(_prompts([5], seed=5)[0], 2)
        a.result(timeout=WAIT_S)
        c.result(timeout=WAIT_S)
        res = ticket.wait(timeout=WAIT_S)
        assert res["to"] == 1 and b.num_slots == 1
        assert d.result(timeout=WAIT_S).size == 2


def test_concurrent_admissions_during_deferred_shrink_queue_not_429(lms):
    """While a shrink waits, concurrent submits are admitted and held
    queued, never rejected, and every held request runs once capacity
    returns."""
    _, pm = lms
    b = ContinuousBatcher(pm, max_len=96, num_slots=3, page_size=4,
                          max_queue=16)
    with b:
        long_a = b.submit(_prompts([5], seed=20)[0], 80)
        long_b = b.submit(_prompts([5], seed=21)[0], 80)
        _wait_for(lambda: long_a.tokens and long_b.tokens)
        ticket = b.request_resize(1)  # waits: 2 live > 1
        errors, held = [], [None] * 4

        def submit(i):
            try:
                held[i] = b.submit(_prompts([4], seed=30 + i)[0], 2)
            except AdmissionError as e:
                errors.append(e)

        threads = [threading.Thread(target=submit, args=(i,))
                   for i in range(len(held))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors
        time.sleep(0.2)  # a scheduler that ran them would show it here
        if not (long_a.done() or long_b.done()):
            assert not ticket.done()
            assert all(not h.tokens for h in held)
            assert b.admission.queue_depth() == len(held)
            assert b.queued_prefill_tokens() == 4 * len(held)
        long_a.result(timeout=WAIT_S)
        long_b.result(timeout=WAIT_S)
        assert ticket.wait(timeout=WAIT_S)["to"] == 1
        for h in held:
            assert h.result(timeout=WAIT_S).size == 2
        assert all(h.error is None for h in held)


def test_resize_rejected_while_pending_and_after_stop(lms):
    _, pm = lms
    b = ContinuousBatcher(pm, max_len=48, num_slots=2, page_size=4,
                          max_queue=4)
    with b:
        r = b.submit(_prompts([5], seed=6)[0], 40)
        _wait_for(lambda: r.tokens)
        r2 = b.submit(_prompts([5], seed=7)[0], 40)
        _wait_for(lambda: r2.tokens)
        ticket = b.request_resize(1)  # waits: 2 live > 1
        with pytest.raises(RuntimeError, match="already pending"):
            b.request_resize(2)
        r.result(timeout=WAIT_S)
        r2.result(timeout=WAIT_S)
        ticket.wait(timeout=WAIT_S)
    with pytest.raises(BatcherStopped):
        b.request_resize(2)
    with pytest.raises(ValueError, match="num_slots or a machine"):
        b.request_resize()


def test_resize_applies_while_idle(lms):
    jm, pm = lms
    p = _prompts([5], seed=8)[0]
    with JaxBatcher(jm, max_len=48, num_slots=2, page_size=4,
                    max_queue=4) as jb:
        want = jb.submit(p, 3).result(timeout=WAIT_S).tolist()
    b = ContinuousBatcher(pm, max_len=48, num_slots=2, page_size=4,
                          max_queue=4)
    with b:
        res = b.request_resize(4).wait(timeout=WAIT_S)
        assert res["to"] == 4 and res["migrated_rows"] == 0
        assert b.request_resize(4).wait(timeout=WAIT_S)["noop"]
        out = b.submit(p, 3).result(timeout=WAIT_S)
        assert out.tolist() == want


# ---------------------------------------------------------------------
# speculative decoding (tests/test_spec_decode.py:134)
# ---------------------------------------------------------------------
def test_spec_resize_parity_migrates_draft_caches():
    """A mid-decode shrink and grow under speculation: the draft's
    slot-dense caches migrate with the target's, and every request keeps
    the JAX speculative batcher's greedy tokens with zero drops."""
    slots, max_len = 3, 40
    jm = _build_lm(slots, 12)
    pm = build_tiny_lm(slots, 12, vocab=50, device="cpu")
    params_from_jax(pm, jm.params)
    pd = build_tiny_lm(slots, 12, vocab=50, device="cpu")
    params_from_jax(pd, jm.params)
    jd = _build_lm(slots, 12)
    jd.params = jm.params
    work = [(p, 14) for p in _prompts((4, 6, 3), seed=5)]
    kw = dict(max_len=max_len, num_slots=slots, page_size=4, max_queue=16,
              prefix_cache_pages=0, spec_tokens=3)
    with JaxBatcher(jm, draft_model=jd, **kw) as jb:
        ref = [h.result(timeout=WAIT_S).tolist()
               for h in [jb.submit(p, n) for p, n in work]]
    b = ContinuousBatcher(pm, draft_model=pd, **kw)
    with b:
        hs = [b.submit(p, n) for p, n in work]
        _wait_for(lambda: any(h.tokens for h in hs))
        old_draft = b._draft_caches
        shrink = b.request_resize(2).wait(timeout=WAIT_S)
        grow = b.request_resize(slots).wait(timeout=WAIT_S)
        outs = [h.result(timeout=WAIT_S).tolist() for h in hs]
    assert outs == ref
    assert all(h.error is None for h in hs)
    assert shrink["direction"] == "shrink" and grow["direction"] == "grow"
    assert shrink["migrated_rows"] > 0
    assert b._draft_caches is not old_draft
    assert next(iter(b._draft_caches.values()))["k_cache"].shape[0] == slots
