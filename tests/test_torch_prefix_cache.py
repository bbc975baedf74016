"""flexflow_tpu_torch's prefix cache on the CPU against the JAX package's
(tests/test_prefix_cache.py's fifteen cases). The host-only units drive
the port's PrefixCache, PagedKVPool and AdmissionController and the JAX
package's with the same calls and compare every return and the whole
state after each call; the LM cases run the port's ContinuousBatcher and
the JAX batcher on the same tiny LM and weights (`params_from_jax`) and
compare greedy tokens, the requests' cache outcome and stats(). Also the
default (C7): with chunked prefill and prefix_cache_pages=None both
batchers build the cache, key for key."""
import numpy as np
import pytest

from flexflow_tpu.serving.sched import AdmissionController as JaxAdmission
from flexflow_tpu.serving.sched import ContinuousBatcher as JaxBatcher
from flexflow_tpu.serving.sched import PagedKVPool as JaxPool
from flexflow_tpu.serving.sched import PrefixCache as JaxPrefixCache
from flexflow_tpu.serving.sched import prefix_route_chain as jax_chain
from flexflow_tpu.serving.sched import prefix_route_key as jax_key
from flexflow_tpu.serving.sched.bench import \
    make_shared_prefix_workload as jax_workload
from flexflow_tpu_torch import params_from_jax
from flexflow_tpu_torch.serving.generate import GenerativeSession
from flexflow_tpu_torch.serving.sched import (AdmissionController,
                                              ContinuousBatcher, PagedKVPool,
                                              PrefixCache, RequestTooLarge,
                                              make_shared_prefix_workload,
                                              prefix_route_chain,
                                              prefix_route_key)
from flexflow_tpu_torch.serving.sched.bench import build_tiny_lm
from tests.conftest import module_xla_cache
from tests.test_generate import _build_lm

_xla_cache = pytest.fixture(scope="module", autouse=True)(module_xla_cache)

PORT = dict(cache=PrefixCache, pool=PagedKVPool, adm=AdmissionController,
            chain=prefix_route_chain, key=prefix_route_key)
JAX = dict(cache=JaxPrefixCache, pool=JaxPool, adm=JaxAdmission,
           chain=jax_chain, key=jax_key)


@pytest.fixture(scope="module")
def lms():
    """One tiny LM (b=2, window=12) in both packages, same weights."""
    jm = _build_lm(2, 12)
    pm = build_tiny_lm(2, 12, vocab=50, device="cpu")
    params_from_jax(pm, jm.params)
    return jm, pm


def _prompts(lens, seed=0, vocab=50):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, size=(n,)).astype(np.int32) for n in lens]


def _state(c):
    """Everything a PrefixCache holds: entries (key -> page, parent,
    tokens, refcount, tick, hits), free pages, pins, stats."""
    with c._lock:
        entries = {k.hex(): (e.page, e.parent.hex(), e.tokens.tolist(),
                             e.refcount, e.tick, e.hits)
                   for k, e in c._entries.items()}
        pins = {s: [e.key.hex() for e in es] for s, es in c._pins.items()}
        free = list(c._free_pages)
    return entries, free, pins, c.stats()


def _same(scenario):
    """Run scenario(mod, log) against both packages; every logged value
    and the final states must agree."""
    logs = {}
    for name, mod in (("port", PORT), ("jax", JAX)):
        log = []
        scenario(mod, log)
        logs[name] = log
    assert len(logs["port"]) == len(logs["jax"])
    for i, (a, b) in enumerate(zip(logs["port"], logs["jax"])):
        assert a == b, (i, a, b)
    return logs["port"]


def _entries(r):
    """(matched tokens, [entry keys]) of a match / acquire return."""
    n, es = r
    return n, [e.key.hex() for e in es]


def test_prefix_route_key_identical_across_replicas():
    toks = np.arange(1, 15, dtype=np.int32)
    other = np.concatenate([toks[:8], np.array([99, 98, 97, 96], np.int32)])

    def scenario(m, log):
        chain = m["chain"](toks, page_size=4)
        log.append(chain)
        caches = [m["cache"](capacity_pages=8, page_size=4)
                  for _ in range(2)]
        for c in caches:
            log.append(c.insert(toks, toks.size, lambda pairs: None))
            log.append(_entries(c.match(toks))[1] == chain)
        log += [m["key"](toks, page_size=4),
                m["key"](toks, page_size=4, depth=2),
                m["key"](toks, page_size=4, depth=99),
                m["chain"](other, page_size=4),
                m["key"](toks[:3], page_size=4),
                m["key"](toks, page_size=8)]

    log = _same(scenario)
    assert len(log[0]) == 3 and log[2] is True and log[-2] == ""


def test_prefix_cache_insert_and_longest_match():
    toks = np.arange(1, 15, dtype=np.int32)
    other = toks.copy()
    other[5] = 99

    def scenario(m, log):
        c = m["cache"](capacity_pages=8, page_size=4)
        copies = []
        log.append(c.insert(toks, 14, copies.extend))
        log.append(list(copies))
        log += [c.pages_in_use(), c.entry_count(), _entries(c.match(toks)),
                c.match(toks[:9])[0], c.match(other)[0]]
        log.append(c.insert(toks, 14, copies.extend))
        log += [len(copies), _state(c)[:3]]

    log = _same(scenario)
    assert log[0] == 3 and log[4][0] == 12 and log[6] == 4


def test_prefix_cache_refcounts_pin_and_release():
    toks = np.arange(1, 14, dtype=np.int32)

    def scenario(m, log):
        c = m["cache"](capacity_pages=8, page_size=4)
        c.insert(toks, 13, lambda pairs: None)
        log.append(_entries(c.acquire("s1", toks)))
        log.append(_entries(c.acquire("s2", toks, max_pages=2)))
        log.append(c.refcount_of(toks))
        with pytest.raises(ValueError, match="already holds pins"):
            c.acquire("s1", toks)
        for seq in ("s1", "s1", "s2"):
            c.release(seq)
            log.append((c.refcount_of(toks), _state(c)))

    log = _same(scenario)
    assert log[2] == [2, 2, 1] and log[-1][1][3]["pages_saved"] == 5


def test_prefix_cache_lru_evicts_only_refcount_zero():
    a = np.arange(1, 5, dtype=np.int32)
    b = np.arange(11, 15, dtype=np.int32)
    d = np.arange(21, 25, dtype=np.int32)
    e = np.arange(31, 35, dtype=np.int32)

    def scenario(m, log):
        c = m["cache"](capacity_pages=2, page_size=4)
        for t in (a, b):
            log.append(c.insert(t, 4, lambda *_: None))
        c.acquire("s", a)
        log.append(c.insert(d, 4, lambda *_: None))  # evicts b
        log += [c.match(b)[0], c.match(a)[0], _state(c)]
        c.acquire("s2", d)
        log.append(c.insert(e, 4, lambda *_: None))  # nothing evictable
        log += [c.match(a)[0], c.match(d)[0], _state(c)]

    log = _same(scenario)
    assert log[2] == 1 and log[3] == 0 and log[6] == 0


def test_prefix_cache_cow_break_unshares_without_mutating():
    toks = np.arange(1, 14, dtype=np.int32)

    def scenario(m, log):
        c = m["cache"](capacity_pages=8, page_size=4)
        c.insert(toks, 13, lambda pairs: None)
        c.acquire("w", toks)
        c.acquire("r", toks)
        log += [c.shared_tokens("w"), c.cow_break("w", 6),
                c.shared_tokens("w"), c.refcount_of(toks),
                c.match(toks)[0], c.cow_break("nobody", 0)]
        c.release("w")
        c.release("r")
        log.append(_state(c))

    log = _same(scenario)
    assert log[:5] == [12, 2, 4, [2, 1, 1], 12]


def test_pool_band_geometry_uses_full_pages_only():
    def scenario(m, log):
        pool = m["pool"](2, 30, page_size=8, prefix_cache_pages=7)
        log += [pool.pages_per_slot, pool.full_pages_per_slot,
                pool.band_slots, [pool.band_coords(p) for p in range(7)],
                m["pool"](1, 6, page_size=8,
                          prefix_cache_pages=4).prefix is None,
                m["pool"](1, 6, page_size=2).band_slots]

    log = _same(scenario)
    assert log[:3] == [4, 3, 3] and len(set(log[3])) == 7
    assert all(row + 8 <= 30 for _, row in log[3])


def test_pool_free_releases_prefix_pins():
    toks = np.arange(1, 20, dtype=np.int32)

    def scenario(m, log):
        pool = m["pool"](2, 32, page_size=8, prefix_cache_pages=4)
        pool.prefix.insert(toks, 19, lambda pairs: None)
        log.append(pool.alloc("s", 19))
        pool.prefix.acquire("s", toks)
        log += [pool.prefix.refcount_of(toks), pool.live_sequences()]
        pool.free("s")
        log += [pool.prefix.refcount_of(toks), pool.live_sequences(),
                sorted(pool.stats()), pool.stats()["prefix"]]

    log = _same(scenario)
    assert log[1] == [1, 1] and log[3] == [0, 0] and "prefix" in log[5]


def test_admission_credits_expected_sharing():
    def scenario(m, log):
        pool = m["pool"](num_slots=1, max_len=32, page_size=4)
        adm = m["adm"](pool, window=None, max_queue=8,
                       queue_pages_budget=6)
        adm.admit("cold", 16, 8)
        with pytest.raises(Exception) as err:
            adm.admit("cold2", 16, 8)
        log.append(type(err.value).__name__)
        adm.release("cold")
        adm.admit("warm", 16, 8, shared_pages=4)
        log.append(adm.backlog_pages())
        adm.admit("warm2", 16, 8, shared_pages=4)
        log.append(adm.backlog_pages())
        adm.admit("tiny", 1, 1, shared_pages=9)  # never below one page
        log.append(adm.backlog_pages())
        for r in ("warm", "warm2", "tiny"):
            adm.release(r)
        with pytest.raises(Exception, match="cache capacity") as err:
            adm.admit("huge", 30, 8, shared_pages=100)
        log.append(type(err.value).__name__)

    log = _same(scenario)
    assert log == ["PoolSaturated", 2, 4, 5, "RequestTooLarge"]


def test_admission_windowless_admits_long_prompts():
    def scenario(m, log):
        pool = m["pool"](num_slots=1, max_len=64, page_size=4)
        adm = m["adm"](pool, window=None, max_queue=4)
        adm.admit("long", 40, 8)
        log.append(adm.backlog_pages())
        adm.release("long")
        capped = m["adm"](pool, window=12, max_queue=4)
        with pytest.raises(Exception, match="prefill window") as err:
            capped.admit("long", 40, 8)
        log.append(type(err.value).__name__)

    assert _same(scenario) == [12, "RequestTooLarge"]


def _serve(batcher_cls, model, prompts, n_new, **kw):
    with batcher_cls(model, **kw) as cb:
        reqs = [cb.submit(p, n_new) for p in prompts]
        toks = [r.result(timeout=300).tolist() for r in reqs]
        return toks, reqs, cb.stats(), cb


def test_chunked_prefill_token_parity_with_one_shot_and_lockstep(lms):
    jm, pm = lms
    prompts = _prompts([4, 7, 3], seed=0)
    session = GenerativeSession(pm, max_len=12)
    refs = [session.generate(p[None, :], 5)[0].tolist() for p in prompts]
    kw = dict(max_len=12, num_slots=2, page_size=4, max_queue=8,
              prefix_cache_pages=0)
    for chunk in (0, 3):
        got = _serve(ContinuousBatcher, pm, prompts, 5,
                     prefill_chunk_tokens=chunk, **kw)[0]
        want = _serve(JaxBatcher, jm, prompts, 5,
                      prefill_chunk_tokens=chunk, **kw)[0]
        assert got == want == refs, chunk


def test_chunked_prefill_last_chunk_never_clamps(lms):
    jm, pm = lms
    prompts = _prompts([15, 15, 15, 15], seed=13)
    outs = {}
    for chunk in (5, 7):
        kw = dict(max_len=20, num_slots=2, page_size=4,
                  prefill_chunk_tokens=chunk, prefix_cache_pages=0,
                  max_queue=8)
        outs[chunk] = _serve(ContinuousBatcher, pm, prompts, 4, **kw)[0]
        assert outs[chunk] == _serve(JaxBatcher, jm, prompts, 4, **kw)[0]
    assert outs[5] == outs[7]


def test_chunked_prefill_admits_prompt_longer_than_window(lms):
    jm, pm = lms
    [p] = _prompts([15], seed=2)
    outs = {}
    for chunk in (4, 7):
        kw = dict(max_len=20, num_slots=2, page_size=4,
                  prefill_chunk_tokens=chunk, prefix_cache_pages=0,
                  max_queue=4)
        outs[chunk] = _serve(ContinuousBatcher, pm, [p], 4, **kw)[0]
        assert outs[chunk] == _serve(JaxBatcher, jm, [p], 4, **kw)[0]
    assert outs[4] == outs[7] and len(outs[4][0]) == 4
    with ContinuousBatcher(pm, max_len=20, num_slots=2, page_size=4,
                           prefill_chunk_tokens=0, max_queue=4) as cb:
        with pytest.raises(RequestTooLarge, match="prefill window"):
            cb.submit(p, 4)


def _hit_run(batcher_cls, model, a, b, c):
    """The JAX test's sequence: a cold leader, two interleaved followers
    that diverge after the shared prefix, then the leader's prompt
    again."""
    with batcher_cls(model, max_len=20, num_slots=2, page_size=4,
                     max_queue=8) as cb:
        ra = cb.submit(a, 5)
        out = [ra.result(timeout=300).tolist()]
        rb, rc = cb.submit(b, 5), cb.submit(c, 5)
        out += [rb.result(timeout=300).tolist(),
                rc.result(timeout=300).tolist()]
        rd = cb.submit(a, 5)
        out.append(rd.result(timeout=300).tolist())
        flags = [(r.cache_hit, r.prefix_tokens) for r in (ra, rb, rc, rd)]
        stats = cb.stats()["pool"]["prefix"]
    return out, flags, stats, cb.pool.prefix.refcount_of(a)


def test_prefix_hit_token_parity_and_divergence_isolation(lms):
    jm, pm = lms
    rng = np.random.RandomState(7)
    pre = rng.randint(1, 50, size=(8,)).astype(np.int32)
    a, b, c = (np.concatenate([pre, rng.randint(1, 50, size=(n,)).astype(
        np.int32)]) for n in (3, 2, 4))
    session = GenerativeSession(pm, max_len=20)
    refs = [session.generate(x[None, :], 5)[0].tolist() for x in (a, b, c)]
    got = _hit_run(ContinuousBatcher, pm, a, b, c)
    assert got == _hit_run(JaxBatcher, jm, a, b, c)
    out, flags, stats, refcounts = got
    assert out == [refs[0], refs[1], refs[2], refs[0]]
    assert flags == [(False, 0), (True, 8), (True, 8), (True, 8)]
    assert stats["hits"] == 3 and stats["pages_saved"] == 6
    assert stats["pages_in_use"] > 0 and refcounts == [0, 0]


def test_prefix_cache_ttft_split_by_outcome(lms):
    """The JAX test reads its TTFT histogram by cache outcome (the port's
    metric families come with ROADMAP A9): the same request outcome, TTFT
    and pages saved here."""
    jm, pm = lms
    [p] = _prompts([9], seed=9)
    runs = {}
    for name, cls, model in (("port", ContinuousBatcher, pm),
                             ("jax", JaxBatcher, jm)):
        with cls(model, max_len=16, num_slots=2, page_size=4,
                 max_queue=8) as cb:
            r1 = cb.submit(p, 3)
            t1 = r1.result(timeout=300).tolist()
            r2 = cb.submit(p[:9], 3)
            t2 = r2.result(timeout=300).tolist()
            runs[name] = (t1, t2, r1.cache_hit, r2.cache_hit,
                          cb.pool.prefix.pages_saved())
            assert r1.ttft_s > 0 and r2.ttft_s > 0
    assert runs["port"] == runs["jax"]
    assert runs["port"][2:] == (False, True, 2)


def test_prefix_cache_survives_slot_churn(lms):
    jm, pm = lms
    rng = np.random.RandomState(3)
    pre = rng.randint(1, 50, size=(4,)).astype(np.int32)
    prompts = [np.concatenate(
        [pre, rng.randint(1, 50, size=(3,)).astype(np.int32)])
        for _ in range(3)]
    session = GenerativeSession(pm, max_len=16)
    refs = [session.generate(p[None, :], 4)[0].tolist() for p in prompts]
    kw = dict(max_len=16, num_slots=1, page_size=4, max_queue=8,
              queue_pages_budget=64)
    got = []
    for cls, model in ((ContinuousBatcher, pm), (JaxBatcher, jm)):
        with cls(model, **kw) as cb:
            toks = [cb.submit(p, 4).result(timeout=300).tolist()
                    for p in prompts]
        got.append((toks, cb.stats()["pool"]["prefix"]))
    assert got[0] == got[1]
    assert got[0][0] == refs
    assert got[0][1]["hits"] == 2 and got[0][1]["misses"] == 1


def test_default_batcher_builds_the_prefix_cache_like_jax(lms):
    """C7: with chunked prefill and prefix_cache_pages=None the JAX
    batcher budgets 2 x pages_per_slot band pages; the port does the
    same. On the serve-bench shared-prefix mix (cut to the tiny LM) the
    two caches' stats agree key for key, the followers hit, and the
    probes (`prefix_probe`, `prefix_probe_chain`) agree."""
    jm, pm = lms
    args = (12, 4, 8, 1, 3, 2, 4, 50, 0)
    work = make_shared_prefix_workload(*args)
    jwork = jax_workload(*args)
    assert [(w["prompt"].tolist(), w["max_new"], w["group"], w["leader"])
            for w in work] == [
        (w["prompt"].tolist(), w["max_new"], w["group"], w["leader"])
        for w in jwork]
    res = {}
    for name, cls, model in (("port", ContinuousBatcher, pm),
                             ("jax", JaxBatcher, jm)):
        with cls(model, max_len=24, num_slots=2, page_size=4,
                 max_queue=16) as cb:
            leaders = [cb.submit(w["prompt"], w["max_new"])
                       for w in work if w["leader"]]
            toks = [r.result(timeout=300).tolist() for r in leaders]
            followers = [cb.submit(w["prompt"], w["max_new"])
                         for w in work if not w["leader"]]
            toks += [r.result(timeout=300).tolist() for r in followers]
            probes = [(cb.prefix_probe(w["prompt"]),
                       cb.prefix_probe_chain(
                           prefix_route_chain(w["prompt"], 4),
                           w["prompt"].size)) for w in work]
            res[name] = (toks, cb.stats()["pool"]["prefix"],
                         cb.pool.band_slots,
                         [r.cache_hit for r in followers], probes)
    assert res["port"] == res["jax"]
    toks, stats, band_slots, hits, probes = res["port"]
    assert all(p == (8, 8) for p, _ in zip(probes, work))
    assert stats["capacity_pages"] == 2 * 6 and band_slots == 2
    assert all(hits) and stats["pages_saved"] == 2 * len(hits)
    with ContinuousBatcher(pm, max_len=24, num_slots=2, page_size=4,
                           prefix_cache_pages=0) as cb:
        assert "prefix" not in cb.stats()["pool"]
    with pytest.raises(ValueError, match="requires chunked prefill"):
        ContinuousBatcher(pm, max_len=24, num_slots=2,
                          prefill_chunk_tokens=0, prefix_cache_pages=4)
    with ContinuousBatcher(pm, max_len=24, num_slots=2,
                           prefill_chunk_tokens=0) as cb:
        assert cb.pool.prefix is None
