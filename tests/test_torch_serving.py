"""flexflow_tpu_torch serving on the CPU: greedy tokens from the port's
ContinuousBatcher are identical to the JAX ContinuousBatcher's (mixed
prompt lengths, prompts longer than one chunk, slot reuse, eos); sampling
depends only on a request's (seed, position); the pool and admission
control behave as the JAX package's."""
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
                                              QueueFull, RequestTooLarge,
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
    with pytest.raises(ValueError, match="num_slots is required"):
        ContinuousBatcher(pm, max_len=24)
    with pytest.raises(NotImplementedError, match="A5"):
        ContinuousBatcher(pm, max_len=24, num_slots=1, draft_model=pm)
    cb = ContinuousBatcher(pm, max_len=24, num_slots=1)
    for call in (cb.request_resize, cb.request_export, cb.request_import,
                 cb.resume_parked, cb.release_parked):
        with pytest.raises(NotImplementedError, match="A5"):
            call()
    with pytest.raises(BatcherStopped):
        cb.submit(prompts[0], 2)
    with cb:
        with pytest.raises(NotImplementedError, match="A5"):
            cb.submit(prompts[0], 2, prefill_only=True)
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
