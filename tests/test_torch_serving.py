"""flexflow_tpu_torch serving on the CPU: greedy tokens from the port's
ContinuousBatcher are identical to the JAX ContinuousBatcher's (mixed
prompt lengths, prompts longer than one chunk, slot reuse, eos); sampling
depends only on a request's (seed, position); the pool and admission
control behave as the JAX package's."""
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.serving.generate import sampling_logits as jax_sampling
from flexflow_tpu.serving.sched import ContinuousBatcher as JaxBatcher
from flexflow_tpu.serving.sched.kvpool import \
    kv_bytes_per_token as jax_kv_bytes
from flexflow_tpu_torch import params_from_jax
from flexflow_tpu_torch.serving.generate import sampling_logits
from flexflow_tpu_torch.serving.sched import (AdmissionController,
                                              BatcherStopped,
                                              ContinuousBatcher, PagedKVPool,
                                              PoolExhausted, PoolSaturated,
                                              QueueFull, RequestState,
                                              RequestTooLarge,
                                              kv_bytes_per_token)
from flexflow_tpu_torch.serving.sched.bench import build_tiny_lm
from tests.conftest import module_xla_cache
from tests.test_generate import _build_lm

_xla_cache = pytest.fixture(scope="module", autouse=True)(module_xla_cache)

# 9 and 13 tokens span three and four 4-token chunks
PLENS = (4, 9, 3, 7, 13)
NEW = 10


@pytest.fixture(scope="module")
def lms():
    jm = _build_lm(2, 12)
    pm = build_tiny_lm(2, 12, vocab=50, device="cpu")
    params_from_jax(pm, jm.params)
    rng = np.random.RandomState(15)
    prompts = [rng.randint(1, 50, size=(n,)).astype(np.int32) for n in PLENS]
    with JaxBatcher(jm, max_len=24, num_slots=2, page_size=4, max_queue=8,
                    prefix_cache_pages=0) as cb:
        ref = [r.result(timeout=300).tolist()
               for r in [cb.submit(p, NEW) for p in prompts]]
    return jm, pm, prompts, ref


def _serve(pm, prompts, num_slots, **submit_kw):
    with ContinuousBatcher(pm, max_len=24, num_slots=num_slots, page_size=4,
                           max_queue=8, queue_pages_budget=64) as cb:
        reqs = [cb.submit(p, NEW, **submit_kw) for p in prompts]
        return [r.result(timeout=120).tolist() for r in reqs], cb.stats()


@pytest.mark.parametrize("num_slots", [2, 1])  # 1: every slot is reused
def test_greedy_tokens_match_jax_batcher(lms, num_slots):
    _, pm, prompts, ref = lms
    out, stats = _serve(pm, prompts, num_slots)
    assert out == ref
    assert stats["completed"] == len(prompts)
    assert stats["prefill_chunks"] == sum(-(-n // 4) for n in PLENS)
    assert stats["pool"]["pages_used"] == 0


def test_eos_retires_at_the_first_eos(lms):
    _, pm, prompts, ref = lms
    eos = ref[1][3]
    out, _ = _serve(pm, prompts, 2, eos_id=eos)
    for toks, r in zip(out, ref):
        cut = r.index(eos) + 1 if eos in r else len(r)
        assert toks == r[:cut]
    assert len(out[1]) <= 4


def test_sampling_depends_only_on_seed_and_position(lms):
    _, pm, prompts, _ = lms

    def run(pairs):
        with ContinuousBatcher(pm, max_len=24, num_slots=2, page_size=4,
                               temperature=0.8, top_k=8) as cb:
            reqs = [cb.submit(p, NEW, seed=s) for p, s in pairs]
            return [r.result(timeout=120).tolist() for r in reqs]

    alone = run([(prompts[1], 7)])[0]
    crowded = run([(prompts[0], 1), (prompts[2], 2), (prompts[1], 7),
                   (prompts[3], 3)])[2]
    assert crowded == alone
    assert run([(prompts[1], 8)])[0] != alone


def test_concurrent_submitters_all_finish(lms):
    """Many client threads submit while the scheduler thread runs, with a
    short switch interval: every request finishes with its greedy tokens
    and the pool and admission books return to empty."""
    import sys
    import threading

    _, pm, prompts, ref = lms
    results, errors = {}, []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ContinuousBatcher(pm, max_len=24, num_slots=2, page_size=4,
                               max_queue=64, queue_pages_budget=512) as cb:
            def client(i):
                try:
                    k = i % len(prompts)
                    results[i] = (k, cb.submit(prompts[k], NEW).result(
                        timeout=120).tolist())
                except Exception as e:  # surfaced by the assert below
                    errors.append(e)

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(12)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
            stats = cb.stats()
    finally:
        sys.setswitchinterval(old)
    assert not errors
    assert all(toks == ref[k] for k, toks in results.values())
    assert len(results) == 12 and stats["completed"] == 12
    assert stats["pool"]["pages_used"] == 0
    assert stats["admission"]["backlog_pages"] == 0


def test_sampling_logits_match_jax():
    rng = np.random.RandomState(4)
    probs = rng.dirichlet(np.ones(40), size=3).astype(np.float32)
    for top_k in (None, 5):
        ref = np.asarray(jax_sampling(jnp.asarray(probs), 0.7, top_k))
        out = sampling_logits(torch.from_numpy(probs), 0.7, top_k).numpy()
        np.testing.assert_array_equal(np.isinf(out), np.isinf(ref))
        np.testing.assert_allclose(out[np.isfinite(ref)],
                                   ref[np.isfinite(ref)], rtol=1e-6)


def test_unported_batcher_features_raise_clearly(lms):
    _, pm, prompts, _ = lms
    # num_slots is derived from the machine model now (A5.8; held against
    # JAX's in tests/test_torch_calibration.py)
    assert ContinuousBatcher(pm, max_len=24).num_slots >= 1
    # the disaggregated roles and handoff calls are ported (A5.6): their
    # refusals are JAX's
    with pytest.raises(ValueError, match="role='bogus'"):
        ContinuousBatcher(pm, max_len=24, num_slots=1, role="bogus")
    cb = ContinuousBatcher(pm, max_len=24, num_slots=1)
    with pytest.raises(BatcherStopped):
        cb.request_export(object())
    with pytest.raises(BatcherStopped):
        cb.request_import({}, {}, prompts[0], 1, 2)
    with pytest.raises(BatcherStopped):
        cb.submit(prompts[0], 2)
    with cb:
        # a prefill-only request parks after its first token; resuming
        # it decodes the rest here, as a unified run would
        req = cb.submit(prompts[0], 3, prefill_only=True)
        deadline = time.monotonic() + 60
        while req.state is not RequestState.PARKED:
            assert time.monotonic() < deadline and not req.done()
            time.sleep(0.002)
        assert cb.parked_requests() == [req] and cb.stats()["parked"] == 1
        assert cb.resume_parked(req) and not cb.resume_parked(req)
        assert not cb.release_parked(req)
        assert len(req.result(timeout=60)) == 3
        with pytest.raises(ValueError, match=r"\[0, 50\)"):
            cb.submit(np.array([3, 50], np.int32), 2)
        with pytest.raises(RequestTooLarge):
            cb.submit(prompts[4], 12)


def test_kv_pool_pages_and_slots():
    pool = PagedKVPool(2, 10, page_size=4)
    assert (pool.pages_per_slot, pool.total_pages) == (3, 6)
    assert pool.pages_for(0) == 1 and pool.pages_for(5) == 2
    s = pool.alloc("a", 4)
    assert pool.slot_of("a") == s and len(pool.pages_of("a")) == 1
    pool.extend("a", 1)  # crosses into the second page
    assert pool.pages_of("a") == [s * 3, s * 3 + 1]
    with pytest.raises(PoolExhausted):
        pool.extend("a", 6)
    pool.alloc("b", 10)
    with pytest.raises(PoolExhausted, match="all 2 slots"):
        pool.alloc("c", 1)
    with pytest.raises(PoolExhausted, match="capacity"):
        PagedKVPool(1, 4).alloc("d", 5)
    assert pool.stats()["pages_used"] == 5
    pool.free("b")
    pool.free("b")  # idempotent
    assert pool.free_slot_count() == 1 and pool.slot_of("b") is None


def test_admission_typed_rejections():
    pool = PagedKVPool(1, 16, page_size=4)
    adm = AdmissionController(pool, None, max_queue=2, queue_pages_budget=6)
    with pytest.raises(RequestTooLarge, match="empty"):
        adm.admit(0, 0, 1)
    with pytest.raises(RequestTooLarge, match="capacity"):
        adm.admit(0, 10, 7)
    adm.admit(1, 8, 4)          # 3 pages
    with pytest.raises(PoolSaturated):
        adm.admit(2, 12, 4)     # 4 more pages > budget 6
    adm.admit(3, 2, 2)          # 1 page
    with pytest.raises(QueueFull):
        adm.admit(4, 1, 1)
    assert adm.backlog_pages() == 4
    assert adm.on_scheduled(1) >= 0.0
    adm.release(3)
    assert adm.queue_depth() == 0
    assert adm.stats()["rejections"] == {
        "too_large": 2, "pool_saturated": 1, "queue_full": 1}
    assert RequestTooLarge.http_status == 400 and QueueFull.http_status == 429


@pytest.mark.parametrize("mixed_precision", [False, True])
def test_kv_bytes_per_token_matches_jax(mixed_precision):
    jm = _build_lm(1, 4)
    jm.config.allow_mixed_precision = mixed_precision
    pm = build_tiny_lm(1, 4, vocab=50, mixed_precision=mixed_precision,
                       device="cpu")
    assert kv_bytes_per_token(pm) == jax_kv_bytes(jm)


@pytest.mark.parametrize("num_slots", [2, 1])
def test_one_shot_prefill_matches_jax_batcher(lms, num_slots):
    """prefill_chunk_tokens=0: one full-sequence walk a request fills the
    slot's caches (fill_kv_cache) and picks the first token; greedy
    tokens equal the JAX batcher's one-shot run (prompts capped at the
    window of 12, so the 13-token prompt is left out)."""
    jm, pm, prompts, _ = lms
    short = [p for p in prompts if p.size <= 12]
    kw = dict(max_len=24, num_slots=num_slots, page_size=4, max_queue=8,
              queue_pages_budget=64, prefill_chunk_tokens=0)
    with JaxBatcher(jm, **kw) as cb:
        ref = [r.result(timeout=300).tolist()
               for r in [cb.submit(p, NEW) for p in short]]
    with ContinuousBatcher(pm, **kw) as cb:
        out = [r.result(timeout=120).tolist()
               for r in [cb.submit(p, NEW) for p in short]]
        with pytest.raises(RequestTooLarge, match="prefill window"):
            cb.submit(prompts[4], 2)
        stats = cb.stats()
    assert out == ref
    assert stats["prefill_chunks"] == 0 and "prefix" not in stats["pool"]
    # one eager walk a prefill, one a decode iteration (the CPU has no
    # graphs)
    assert stats["graphs"]["eager_walks"] == (len(short)
                                             + stats["decode_iterations"])
    assert stats["graphs"]["captures"] == 0


def test_chunk_offset_drops_rows_past_the_cache_edge():
    """The chunk-offset entry (a 0-d int32 device offset, what a captured
    chunk passes; a host int becomes one) at offsets whose chunk runs
    past an 11-row cache: the rows inside the cache and the probabilities
    of the queries inside it equal a walk on a 20-row cache, the rows
    before the offset are untouched, and the host-int offset gives the
    same bits."""
    from flexflow_tpu_torch.serving.sched.kvpool import kv_cache_spec

    pm = build_tiny_lm(1, 6, vocab=50, device="cpu",
                       generator=torch.Generator().manual_seed(3))
    toks = torch.from_numpy(
        np.random.RandomState(2).randint(1, 50, size=(1, 6)).astype(
            np.int32))
    name = pm.input_ops[0].name
    g = torch.Generator().manual_seed(5)
    big = {op: {v: torch.randn((1, 20, h, d), generator=g)
                for v in ("k_cache", "v_cache")}
           for op, h, d, _, _ in kv_cache_spec(pm)}

    def walk(rows, pos):
        caches = {op: {v: t[:, :rows].clone() for v, t in c.items()}
                  for op, c in big.items()}
        probs = pm.executor.forward_values(
            {name: toks}, state=caches,
            decode_pos=pos)[pm.final_tensor.guid]
        return probs, caches

    for off in (0, 5, 9):  # 9: rows 9..14 of 11, the last 4 dropped
        inside = min(6, 11 - off)
        p_small, c_small = walk(11, torch.tensor(off, dtype=torch.int32))
        p_int, c_int = walk(11, off)
        p_big, c_big = walk(20, off)
        assert torch.equal(p_small, p_int)
        torch.testing.assert_close(p_small[:, :inside], p_big[:, :inside],
                                   atol=1e-7, rtol=1e-6)
        for op in c_small:
            for v in c_small[op]:
                assert torch.equal(c_small[op][v], c_int[op][v])
                assert torch.equal(c_small[op][v][:, :off],
                                   big[op][v][:, :off])
                torch.testing.assert_close(c_small[op][v],
                                           c_big[op][v][:, :11])


def test_pool_gauges_track_usage_per_pool():
    """JAX test_continuous_batching.py:84: gauge series are labelled per
    pool, so two pools in one process never clobber each other's
    values."""
    from flexflow_tpu_torch.obs import REGISTRY

    pool = PagedKVPool(num_slots=2, max_len=8, page_size=4)
    other = PagedKVPool(num_slots=1, max_len=8, page_size=4)
    used = REGISTRY.gauge("ff_kvpool_pages_used", labels=("pool",))
    total = REGISTRY.gauge("ff_kvpool_pages_total", labels=("pool",))
    assert pool.label != other.label
    assert total.value(pool=pool.label) == 4
    assert total.value(pool=other.label) == 2
    pool.alloc("a", 8)
    other.alloc("x", 1)
    assert used.value(pool=pool.label) == 2
    assert used.value(pool=other.label) == 1
    pool.free("a")
    assert used.value(pool=pool.label) == 0
    assert used.value(pool=other.label) == 1


def test_admission_metric_families_match_jax():
    """The queue gauge and the rejection counter: the same sequence of
    admissions and rejections leaves the same series in both packages'
    registries."""
    from flexflow_tpu.obs.registry import MetricsRegistry as JaxRegistry
    from flexflow_tpu.serving.sched import (
        AdmissionController as JaxAdmission, PagedKVPool as JaxPool)
    from flexflow_tpu.serving.sched.admission import \
        AdmissionError as JaxAdmissionError
    from flexflow_tpu_torch.obs.registry import MetricsRegistry
    from flexflow_tpu_torch.serving.sched import AdmissionError

    series = []
    for reg, pool_cls, adm_cls in (
            (MetricsRegistry(), PagedKVPool, AdmissionController),
            (JaxRegistry(), JaxPool, JaxAdmission)):
        pool = pool_cls(1, 16, page_size=4, registry=reg, label="p")
        adm = adm_cls(pool, None, max_queue=2, queue_pages_budget=6,
                      registry=reg)
        for rid, plen, new in ((0, 0, 1), (1, 8, 4), (2, 12, 4), (3, 2, 2),
                               (4, 1, 1)):
            try:
                adm.admit(rid, plen, new)
            except (AdmissionError, JaxAdmissionError):
                pass
        adm.on_scheduled(1)
        series.append(reg.render())
    assert series[0] == series[1]


def _queued_batcher(pm, **kw):
    """A batcher that accepts submits while its scheduler loop never
    runs (the JAX tests' `_running = True`)."""
    cb = ContinuousBatcher(pm, max_len=24, num_slots=1, page_size=4,
                           max_queue=8, queue_pages_budget=64, **kw)
    cb._running = True
    return cb


def test_cancel_queued_request(lms):
    """JAX test_continuous_batching.py:283: cancel() removes a
    still-queued request (reservation released, RequestCancelled, the
    `cancelled` outcome counted) and refuses once it reached a slot."""
    from flexflow_tpu_torch.obs.registry import MetricsRegistry
    from flexflow_tpu_torch.serving.sched import RequestCancelled

    _, pm, prompts, ref = lms
    reg = MetricsRegistry()
    cb = _queued_batcher(pm, registry=reg)
    a = cb.submit(prompts[0], 4)
    assert cb.admission.queue_depth() == 1
    assert cb.cancel(a) is True
    with pytest.raises(RequestCancelled):
        a.result(timeout=5)
    assert cb.cancel(a) is False
    assert cb.admission.queue_depth() == 0
    assert reg.get("ff_serving_requests_total").value(
        outcome="cancelled") == 1
    assert cb.stats()["failed"] == 1
    cb._running = False
    with ContinuousBatcher(pm, max_len=24, num_slots=1, page_size=4) as cb2:
        b = cb2.submit(prompts[0], 3)
        assert b.result(timeout=120).tolist() == ref[0][:3]
        assert cb2.cancel(b) is False


def test_health_probes_and_abort_fence(lms):
    """The health signals (scheduler_alive, heartbeat_age_s,
    step_latency_s after its warm-up, reset_latency) and abort(): every
    slotted request is fenced (its emitted tokens frozen, one error),
    queued ones fail, the pool and admission books empty, the loop
    exits; a fenced request takes no later token."""
    _, pm, prompts, _ = lms
    cb = ContinuousBatcher(pm, max_len=24, num_slots=1, page_size=4,
                           max_queue=8, queue_pages_budget=64)
    assert not cb.scheduler_alive() and cb.heartbeat_age_s() is None
    cb.start()
    try:
        first = cb.submit(prompts[1], 6)
        first.result(timeout=120)
        assert cb.scheduler_alive()
        assert 0.0 <= cb.heartbeat_age_s() < 5.0
        assert cb.step_latency_s() is not None  # > 2 busy iterations
        cb.reset_latency()
        assert cb.step_latency_s() is None
        # one request in the slot (or about to take it), one queued
        long_req = cb.submit(prompts[3], 14)
        queued = cb.submit(prompts[0], 4)
        err = RuntimeError("replica declared dead")
        cb.abort(err)
        snap = long_req._fence(err)
        assert snap is None or snap[0] == long_req.tokens
        for r in (long_req, queued):
            with pytest.raises(RuntimeError, match="declared dead"):
                r.result(timeout=5)
        n = len(long_req.tokens)
        long_req._emit(7)
        assert len(long_req.tokens) == n
        cb._thread.join(timeout=60)
        assert not cb.scheduler_alive()
        stats = cb.stats()
        assert stats["slots_active"] == 0 and stats["queue_depth"] == 0
        assert stats["pool"]["pages_used"] == 0
        assert stats["admission"]["backlog_pages"] == 0
    finally:
        cb.stop()


def test_fence_freezes_tokens_like_jax():
    """GenRequest._fence: the JAX handle's contract, case by case."""
    from flexflow_tpu.serving.sched.continuous import GenRequest as JaxReq
    from flexflow_tpu_torch.serving.sched import GenRequest

    out = []
    for cls in (GenRequest, JaxReq):
        res = []
        a = cls(0, np.zeros(2, np.int32), 4, None, 0)
        a._emit(3)
        a._emit(5)
        snap = a._fence(RuntimeError("x"))
        a._emit(9)
        a._finish()
        res.append((snap[0], list(a.tokens), a.state.value,
                    str(a.error), a._fence(RuntimeError("y"))[0]))
        b = cls(1, np.zeros(2, np.int32), 4, None, 0)
        b._emit(1)
        b._finish()
        res.append((b._fence(RuntimeError("x")), b.state.value))
        c = cls(2, np.zeros(2, np.int32), 4, None, 0)
        c._fail(ValueError("first"))
        snap = c._fence(RuntimeError("x"))
        res.append((snap[0], c.state.value, str(c.error)))
        out.append(res)
    assert out[0] == out[1]
    assert out[0][0][:4] == ([3, 5], [3, 5], "failed", "x")


def test_batcher_metric_families_match_jax(lms):
    """The batcher's families (slots, TTFT and ITL histograms, requests,
    tokens, the rate-model gauges) over one served mix: the same
    families, kinds, series and label names as the JAX batcher's, and
    the same request and token counts."""
    from flexflow_tpu.obs.registry import MetricsRegistry as JaxRegistry
    from flexflow_tpu_torch.obs.registry import MetricsRegistry

    jm, pm, prompts, ref = lms

    def shape(text):
        out = set()
        for line in text.splitlines():
            if line.startswith("# TYPE"):
                out.add(tuple(line.split(" ")[2:]))
            elif line and not line.startswith("#"):
                name = line.split("{")[0].split(" ")[0]
                labels = line.split("{")[1].split("}")[0] if "{" in line \
                    else ""
                out.add((name, tuple(sorted(
                    (kv.split("=")[0], kv.split("=")[1])
                    for kv in labels.split(",") if kv
                    if kv.split("=")[0] in ("outcome", "cache", "le")))))
        return out

    texts, counts = [], []
    for cls, model, reg in ((ContinuousBatcher, pm, MetricsRegistry()),
                            (JaxBatcher, jm, JaxRegistry())):
        with cls(model, max_len=24, num_slots=2, page_size=4, max_queue=8,
                 prefix_cache_pages=0, registry=reg) as cb:
            out = [r.result(timeout=300).tolist()
                   for r in [cb.submit(p, NEW) for p in prompts]]
        assert out == ref
        texts.append(reg.render())
        counts.append((reg.get("ff_serving_requests_total").value(
            outcome="completed"), reg.get("ff_serving_tokens_total").value(),
            reg.get("ff_serving_ttft_ms").count(cache="miss"),
            reg.get("ff_serving_itl_ms").count()))
    assert shape(texts[0]) == shape(texts[1])
    assert counts[0] == counts[1] == (len(prompts), len(prompts) * NEW,
                                      len(prompts),
                                      len(prompts) * (NEW - 1))
