"""Expert-affine admission of the port on the CPU (ROADMAP A5.9), against
the JAX package: `pick_affine` and `overlap_fraction` on JAX's cases
(tests/test_continuous_batching.py:496-522), the probe's signatures on
the same weights, the batcher's greedy tokens with affinity on against
the JAX affine batcher's and the port's own session, its
`stats()["affinity"]` keys, its metric families, the router-check walk
(no drops at capacity_factor = experts), and the rejection of a dense
model. Tokens exact (greedy, f32)."""
import numpy as np
import pytest
import torch

from flexflow_tpu.serving.generate import GenerativeSession as JaxSession
from flexflow_tpu.serving.sched import ContinuousBatcher as JaxBatcher
from flexflow_tpu.serving.sched import affinity as jaff
from flexflow_tpu.serving.sched.bench import \
    build_tiny_moe_lm as jax_tiny_moe_lm
from flexflow_tpu_torch import params_from_jax
from flexflow_tpu_torch.obs.registry import MetricsRegistry
from flexflow_tpu_torch.serving.generate import GenerativeSession
from flexflow_tpu_torch.serving.sched import ContinuousBatcher
from flexflow_tpu_torch.serving.sched import affinity as paff
from flexflow_tpu_torch.serving.sched.bench import (_moe_router_check,
                                                    build_tiny_lm,
                                                    build_tiny_moe_lm,
                                                    run_moe)
from tests.conftest import module_xla_cache
from tests.test_torch_zoo import one_torch_thread

_xla_cache = pytest.fixture(scope="module", autouse=True)(module_xla_cache)
_one_thread = pytest.fixture(scope="module", autouse=True)(one_torch_thread)


class _FakeReq:
    def __init__(self, sig, skips=0):
        self.expert_sig = frozenset(sig)
        self.affinity_skips = skips


def _queue():
    return [_FakeReq({2, 3}), _FakeReq({0, 1}), _FakeReq({1, 4}),
            _FakeReq({0, 1})]


@pytest.mark.parametrize("case", [
    (_queue, [frozenset({0, 1})], 4),
    (lambda: _queue()[:1] + _queue()[2:], [frozenset({0, 1})], 1),
    (lambda: [_FakeReq({2, 3}, skips=4), _FakeReq({0, 1})],
     [frozenset({0, 1})], 4),
    (_queue, [], 4),
    (lambda: [_FakeReq({5, 6}), _FakeReq({1, 4}, skips=1)],
     [frozenset({1, 2}), frozenset({4})], 2),
], ids=["affine", "window", "forced", "idle", "union"])
def test_pick_affine_matches_jax(case):
    make, active, window = case
    assert paff.pick_affine(make(), active, window) == \
        jaff.pick_affine(make(), active, window)


def test_overlap_fraction_matches_jax():
    active = [frozenset({0, 1}), frozenset({3})]
    for sig in (frozenset(), frozenset({0}), frozenset({1, 2}),
                frozenset({3, 0}), frozenset({5, 6})):
        assert paff.overlap_fraction(sig, active) == \
            jaff.overlap_fraction(sig, active)
    assert paff.overlap_fraction(frozenset({1}), []) == 0.0


def _prompts(lens, seed=9, vocab=32):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, size=(n,)).astype(np.int32) for n in lens]


LENS = (4, 6, 5, 3, 7, 4)


@pytest.fixture(scope="module")
def lms():
    jm = jax_tiny_moe_lm(2, 16, vocab=32, hidden=16, heads=2, layers=1,
                         experts=4, moe_top_k=2)
    pm = build_tiny_moe_lm(2, 16, vocab=32, hidden=16, heads=2, layers=1,
                           experts=4, moe_top_k=2, device="cpu")
    params_from_jax(pm, jm.params)
    return jm, pm


def test_probe_signatures_match_jax(lms):
    jm, pm = lms
    jp, pp = jaff.ExpertAffinityProbe(jm), paff.ExpertAffinityProbe(pm)
    assert (pp.num_experts, pp.top_k) == (jp.num_experts, jp.top_k) == (4, 2)
    for p in _prompts(LENS + (1, 12), seed=3) + [np.zeros(0, np.int32)]:
        assert pp.signature(p) == jp.signature(p)
    assert all(len(pp.signature(p)) == 2 for p in _prompts(LENS))


def test_affinity_batcher_matches_jax_and_the_session(lms):
    """Affinity on (window 3, 2 slots, 6 requests): the port's greedy
    tokens equal the JAX affine batcher's and the port's session's; the
    stats carry JAX's "affinity" keys, and the picks and overlap gauge
    reach the registry."""
    jm, pm = lms
    prompts = _prompts(LENS)
    with JaxBatcher(jm, max_len=16, num_slots=2, page_size=4,
                    expert_affinity=True, affinity_window=3) as cb:
        want = [r.result(timeout=300).tolist()
                for r in [cb.submit(p, 4) for p in prompts]]
        jstats = cb.stats()
    session = GenerativeSession(pm, max_len=16)
    refs = [session.generate(p[None, :], 4)[0].tolist() for p in prompts]
    reg = MetricsRegistry()
    with ContinuousBatcher(pm, max_len=16, num_slots=2, page_size=4,
                           expert_affinity=True, affinity_window=3,
                           registry=reg) as cb:
        got = [r.result(timeout=300).tolist()
               for r in [cb.submit(p, 4) for p in prompts]]
        stats = cb.stats()
    assert got == want == refs
    aff = stats["affinity"]
    assert set(aff) == set(jstats["affinity"]) == {"window", "overlap_ewma",
                                                   "picks"}
    assert aff["window"] == 3 and sum(aff["picks"].values()) > 0
    assert set(aff["picks"]) <= {"affine", "fifo", "forced"}
    assert aff["overlap_ewma"] is None or 0.0 <= aff["overlap_ewma"] <= 1.0
    text = reg.render()
    assert "ff_serving_affinity_picks_total" in text
    assert "ff_serving_affinity_overlap" in text


def test_affinity_on_and_off_give_the_same_tokens(lms):
    """run_moe with affinity on and off on one workload: no parity
    mismatch against the session, the same token lists, no request
    short."""
    _, pm = lms
    rng = np.random.RandomState(4)
    work = [{"prompt": rng.randint(1, 32, size=(n,)).astype(np.int32),
             "max_new": int(rng.randint(2, 5))} for n in (3, 9, 5, 2, 7)]
    on = run_moe(pm, work, max_len=16, slots=2, page_size=4,
                 deadline_s=60.0, affinity_window=2)
    off = run_moe(pm, work, max_len=16, slots=2, page_size=4,
                  deadline_s=60.0, affinity_window=2, expert_affinity=False)
    assert on["parity_mismatches"] == off["parity_mismatches"] == 0
    assert on["dropped"] == off["dropped"] == 0
    assert on["token_lists"] == off["token_lists"]
    assert sum(on["affinity"]["picks"].values()) > 0 and not off["affinity"]


def test_router_check_counts_no_drops_like_jax(lms):
    """The router-check walk handed model.state: every op's dropped count
    0 (capacity_factor = experts) and the load shares equal JAX's."""
    from flexflow_tpu.serving.sched.bench import \
        _moe_router_check as jax_router_check

    jm, pm = lms
    rng = np.random.RandomState(2)
    work = [{"prompt": rng.randint(1, 32, size=(n,)).astype(np.int32)}
            for n in (5, 9)]
    want = jax_router_check(jm, work, 16)
    got = _moe_router_check(pm, work, 16)
    assert set(got) == set(want) == {"l0_moe_experts"}
    assert got["l0_moe_experts"]["dropped"] == 0.0
    np.testing.assert_array_equal(got["l0_moe_experts"]["load"],
                                  want["l0_moe_experts"]["load"])


def test_serving_walks_keep_no_router_state(lms):
    """The batcher's and the session's walks carry only KV caches: the
    model's router state stays as it was (JAX keeps none of theirs)."""
    _, pm = lms
    before = {op: {v: t.clone() for v, t in vs.items()}
              for op, vs in pm.state.items()}
    GenerativeSession(pm, max_len=16).generate(_prompts((5,))[0][None], 3)
    with ContinuousBatcher(pm, max_len=16, num_slots=2, page_size=4,
                           registry=MetricsRegistry()) as cb:
        cb.submit(_prompts((6,))[0], 3).result(timeout=120)
    for op, vs in before.items():
        for v, t in vs.items():
            assert torch.equal(pm.state[op][v], t), (op, v)


def test_expert_affinity_rejects_dense_models():
    dense = build_tiny_lm(2, 12, vocab=50, device="cpu")
    with pytest.raises(ValueError, match="EXPERTS"):
        ContinuousBatcher(dense, max_len=12, num_slots=2, page_size=4,
                          expert_affinity=True)


def test_jax_session_agrees_on_the_moe_lm(lms):
    """The JAX session and the port's, greedy, on the same MoE LM."""
    jm, pm = lms
    p = _prompts((7,), seed=5)[0][None]
    want = JaxSession(jm, max_len=16).generate(p, 5)
    got = GenerativeSession(pm, max_len=16).generate(p, 5)
    np.testing.assert_array_equal(got, np.asarray(want))
