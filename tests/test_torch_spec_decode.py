"""flexflow_tpu_torch speculative decoding on the CPU: the port's
ContinuousBatcher with a draft model gives the JAX speculative batcher's
greedy tokens and the port's own plain greedy tokens, exactly (tied and
untied drafts, slot reuse, EOS, prefix-cache hits, the cache edge); its
`stats()["spec"]` counts and its metric families are JAX's; the vector
C > 1 verify entry writes and attends what JAX's does; the constructor
refuses what JAX's refuses, with JAX's texts. The cases of
tests/test_spec_decode.py at :61, 73, 83, 97, 161 and 236."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.ffconst import CompMode
from flexflow_tpu.obs.registry import MetricsRegistry as JaxRegistry
from flexflow_tpu.serving.sched import ContinuousBatcher as JaxBatcher
from flexflow_tpu.serving.sched.continuous import GenRequest as JaxRequest
from flexflow_tpu_torch import params_from_jax
from flexflow_tpu_torch.obs.registry import MetricsRegistry
from flexflow_tpu_torch.serving.sched import ContinuousBatcher, GenRequest
from flexflow_tpu_torch.serving.sched.bench import build_tiny_lm, \
    run_speculative_once
from tests.conftest import module_xla_cache
from tests.test_generate import _build_lm

_xla_cache = pytest.fixture(scope="module", autouse=True)(module_xla_cache)

MAX_LEN = 40
SLOTS = 3


def _pair(**kw):
    """A JAX LM and the port's copy of it (the JAX weights)."""
    jm = _build_lm(SLOTS, 12, **kw)
    pm = build_tiny_lm(SLOTS, 12, vocab=kw.get("vocab", 50),
                       hidden=kw.get("hidden", 32), heads=kw.get("heads", 4),
                       layers=kw.get("layers", 2), device="cpu")
    params_from_jax(pm, jm.params)
    return jm, pm


@pytest.fixture(scope="module")
def target():
    return _pair()


@pytest.fixture(scope="module")
def tied_draft(target):
    """The target's architecture and weights: acceptance 1.0."""
    jm, _ = target
    jd = _build_lm(SLOTS, 12)
    jd.params = jm.params
    pd = build_tiny_lm(SLOTS, 12, vocab=50, device="cpu")
    params_from_jax(pd, jm.params)
    return jd, pd


@pytest.fixture(scope="module")
def untied_draft():
    """A smaller, different draft: acceptance is whatever it earns."""
    return _pair(hidden=16, heads=2, layers=1)


def _prompts(lens, seed=0, vocab=50):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, size=(n,)).astype(np.int32) for n in lens]


def _run(cls, model, draft, work, k=3, eos_id=None, prefix_pages=0, **kw):
    b = cls(model, max_len=MAX_LEN, num_slots=SLOTS, page_size=4,
            max_queue=16, prefix_cache_pages=prefix_pages,
            draft_model=draft, spec_tokens=k, **kw)
    with b:
        hs = [b.submit(p, n, eos_id=eos_id) for p, n in work]
        outs = [h.result(timeout=300.0).tolist() for h in hs]
    return outs, b.stats()


def _both(target, draft, work, **kw):
    """(port spec, JAX spec, port plain) tokens and both spec stats."""
    jm, pm = target
    jd, pd = draft if draft is not None else (None, None)
    spec, st = _run(ContinuousBatcher, pm, pd, work, **kw)
    jspec, jst = _run(JaxBatcher, jm, jd, work, **kw)
    plain, _ = _run(ContinuousBatcher, pm, None, work, **kw)
    return spec, jspec, plain, st, jst


def _spec_counts(st):
    return {k: st["spec"][k] for k in ("tokens", "proposed", "accepted",
                                       "acceptance")}


def test_spec_parity_tied_draft_slot_reuse(target, tied_draft):
    """7 requests through 3 slots: the JAX speculative batcher's tokens,
    the port's plain greedy tokens, JAX's spec counts, acceptance 1.0."""
    work = [(p, 8) for p in _prompts((4, 7, 3, 9, 5, 6, 2), seed=1)]
    spec, jspec, plain, st, jst = _both(target, tied_draft, work)
    assert spec == jspec == plain
    assert _spec_counts(st) == _spec_counts(jst)
    assert st["spec"]["acceptance"] == 1.0 and st["spec"]["proposed"] > 0
    assert st["completed"] == len(work) and st["pool"]["pages_used"] == 0
    # one eager walk per draft chunk, target chunk and spec iteration (the
    # CPU has no graphs), and no plain decode iteration
    assert st["graphs"]["captures"] == 0
    assert st["graphs"]["eager_walks"] == (
        2 * sum(-(-p.size // 4) for p, _ in work) + st["decode_iterations"])


def test_spec_parity_untied_draft(target, untied_draft):
    work = [(p, 8) for p in _prompts((4, 7, 3, 9), seed=2)]
    spec, jspec, plain, st, jst = _both(target, untied_draft, work)
    assert spec == jspec == plain
    assert _spec_counts(st) == _spec_counts(jst)
    assert st["spec"]["proposed"] >= st["spec"]["accepted"] >= 0


def test_spec_eos_early_stop(target, tied_draft):
    """EOS inside an accepted window retires the request at the token
    plain greedy stops at; the rest of the window is dropped."""
    work = [(p, 12) for p in _prompts((5, 3), seed=3)]
    plain, _ = _run(ContinuousBatcher, target[1], None, work)
    eos = plain[0][2]
    spec, jspec, plain_eos, st, jst = _both(target, tied_draft, work,
                                            eos_id=eos)
    assert spec == jspec == plain_eos
    assert _spec_counts(st) == _spec_counts(jst)
    assert len(plain_eos[0]) < 12


def test_spec_prefix_cache_hit_parity(target, tied_draft):
    """Prefix-cache hits under speculation: the target installs the
    cached pages and prefills the suffix, the draft prefills the whole
    prompt; the followers hit and every token is JAX's and plain's."""
    rng = np.random.RandomState(4)
    prefix = rng.randint(1, 50, size=(8,)).astype(np.int32)
    work = [(np.concatenate([prefix, rng.randint(1, 50, size=(n,)).astype(
        np.int32)]), 6) for n in (3, 2, 4)]

    def run(cls, model, draft):
        b = cls(model, max_len=MAX_LEN, num_slots=SLOTS, page_size=4,
                max_queue=16, prefix_cache_pages=24, draft_model=draft,
                spec_tokens=3)
        with b:
            lead = b.submit(*work[0])
            outs = [lead.result(timeout=300.0).tolist()]
            hs = [b.submit(p, n) for p, n in work[1:]]
            outs += [h.result(timeout=300.0).tolist() for h in hs]
        return outs, [lead] + hs, b.stats()

    spec, hs, st = run(ContinuousBatcher, target[1], tied_draft[1])
    jspec, jhs, jst = run(JaxBatcher, target[0], tied_draft[0])
    plain, _, _ = run(ContinuousBatcher, target[1], None)
    assert spec == jspec == plain
    assert [h.cache_hit for h in hs] == [h.cache_hit for h in jhs] \
        == [False, True, True]
    assert _spec_counts(st) == _spec_counts(jst)
    assert st["pool"]["prefix"] == jst["pool"]["prefix"]


@pytest.mark.parametrize("k", [3, 2])
def test_spec_at_the_cache_edge(target, untied_draft, tied_draft, k):
    """plen + max_new_tokens == max_len: the last iterations' draft steps
    and verify rows run past the cache edge (rows aimed at the last row,
    no index error); tokens are JAX's and plain greedy's, counts JAX's."""
    rng = np.random.RandomState(11)
    work = [(rng.randint(1, 50, size=(n,)).astype(np.int32), MAX_LEN - n)
            for n in (5, 13, 31)]
    for draft in (tied_draft, untied_draft):
        spec, jspec, plain, st, jst = _both(target, draft, work, k=k)
        assert spec == jspec == plain
        assert [len(t) for t in spec] == [n for _, n in work]
        assert _spec_counts(st) == _spec_counts(jst)


def _families(text):
    """{family: (kind, sorted sample names with their label names)} of an
    exposition, values left out."""
    out = {}
    fam = None
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, fam, kind = line.split(" ")
            out[fam] = [kind]
        elif line and not line.startswith("#"):
            name = line.split("{")[0].split(" ")[0]
            labels = sorted(p.split("=")[0] for p in line.split("{")[1]
                            .split("}")[0].split(",")) if "{" in line else []
            out[fam].append((name, tuple(labels)))
    return {k: (v[0], sorted(set(v[1:]))) for k, v in out.items()}


def test_spec_metrics_and_predicted_ttft_drain_horizon(target, tied_draft):
    """The ff_spec_decode_* families render with the rest of the
    batcher's, as JAX's do (families, kinds, series and label names), the
    counters hold JAX's counts; and predicted_ttft_s charges the draft's
    prefill and no more decode walls than the drain horizon (JAX's unit,
    with the same numbers)."""
    work = [(p, 8) for p in _prompts((4, 5), seed=6)]
    reg, jreg = MetricsRegistry(), JaxRegistry()
    _, st = _run(ContinuousBatcher, target[1], tied_draft[1], work,
                 registry=reg)
    _, jst = _run(JaxBatcher, target[0], tied_draft[0], work,
                  registry=jreg)
    text, jtext = reg.render(), jreg.render()
    for fam in ("ff_spec_decode_proposed_total",
                "ff_spec_decode_accepted_total", "ff_spec_decode_acceptance"):
        assert fam in text
    assert _families(text) == _families(jtext)
    for fam in ("ff_spec_decode_proposed_total",
                "ff_spec_decode_accepted_total", "ff_serving_tokens_total"):
        assert reg.get(fam).value() == jreg.get(fam).value()
    assert _spec_counts(st) == _spec_counts(jst)
    assert st["spec"]["accepted"] > 0
    assert st["draft_prefill_s_per_token"] > 0
    assert set(st) >= set(jst)

    def mk(draft, cls, model):
        b = cls(model, max_len=MAX_LEN, num_slots=SLOTS, page_size=4,
                registry=(MetricsRegistry if cls is ContinuousBatcher
                          else JaxRegistry)(),
                draft_model=draft, spec_tokens=3, max_queue=8)
        b._ewma_prefill_s_per_tok = 0.01
        b._observe_decode_iter(0.3)
        assert b.stats()["decode_iter_s"] == pytest.approx(0.3)
        if draft is not None:
            b._ewma_spec_accept = 1.0
        req = GenRequest if cls is ContinuousBatcher else JaxRequest
        b._queue.append(req(0, np.zeros(4, np.int32), 30, None, 0))
        return b

    own = 60
    total = own + 4
    for cls, model, draft in (
            (ContinuousBatcher, target[1], tied_draft[1]),
            (JaxBatcher, target[0], tied_draft[0])):
        b = mk(draft, cls, model)
        chunk = b.prefill_chunk_tokens
        assert b._decode_drain_iterations() == math.ceil(30 / 3)
        want = (own * 0.01 + 4 * 0.01 + total * 0.01
                + min(math.ceil(total / chunk), 10) * 0.3)
        assert b.predicted_ttft_s(own) == pytest.approx(want)
        b._observe_draft_prefill(10, 0.05)
        want = (own * 0.01 + 4 * 0.01 + total * 0.005
                + min(math.ceil(total / chunk), 10) * 0.3)
        assert b.predicted_ttft_s(own) == pytest.approx(want)
        p = mk(None, cls, model)
        assert p.predicted_ttft_s(own) == pytest.approx(
            total * 0.01 + math.ceil(total / chunk) * 0.3)


def test_spec_constructor_validation(target, tied_draft):
    pm, pd = target[1], tied_draft[1]
    kw = dict(max_len=MAX_LEN, num_slots=SLOTS, page_size=4)
    with pytest.raises(ValueError, match="greedy-only"):
        ContinuousBatcher(pm, temperature=0.7, draft_model=pd,
                          spec_tokens=3, **kw)
    with pytest.raises(ValueError, match="chunked prefill"):
        ContinuousBatcher(pm, prefill_chunk_tokens=0, draft_model=pd,
                          spec_tokens=3, **kw)
    with pytest.raises(ValueError, match="spec_tokens"):
        ContinuousBatcher(pm, draft_model=pd, spec_tokens=0, **kw)
    with pytest.raises(ValueError, match="window"):
        ContinuousBatcher(pm, draft_model=pd, spec_tokens=99, **kw)
    bad_vocab = build_tiny_lm(SLOTS, 12, vocab=17, hidden=16, heads=2,
                              layers=1, device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        ContinuousBatcher(pm, draft_model=bad_vocab, spec_tokens=3, **kw)
    narrow = build_tiny_lm(SLOTS, 2, vocab=50, device="cpu")
    with pytest.raises(ValueError, match="draft window"):
        ContinuousBatcher(pm, draft_model=narrow, spec_tokens=3, **kw)


def test_run_speculative_once_matches_plain(target, tied_draft):
    """bench.run_speculative_once: the same token lists with and without
    the draft, every request whole, the spec stats only with a draft."""
    work = [{"prompt": p, "max_new": 6} for p in _prompts((4, 9, 3), 12)]
    kw = dict(max_len=MAX_LEN, slots=SLOTS, page_size=4, spec_tokens=3,
              deadline_s=60.0)
    spec = run_speculative_once(target[1], tied_draft[1], work, **kw)
    plain = run_speculative_once(target[1], None, work, **kw)
    assert spec["token_lists"] == plain["token_lists"]
    assert spec["dropped"] == plain["dropped"] == 0
    assert spec["tokens"] == 18 and spec["spec"]["acceptance"] == 1.0
    assert plain["spec"] is None


@pytest.mark.parametrize("k", [1, 4])
def test_vector_multiquery_entry_matches_jax(target, k):
    """The vector entry with C = k queries a slot at ragged positions, one
    slot's rows running past the 24-row cache (pos 22: rows 22, 23 and
    two past the edge): probabilities and every cache row equal JAX's
    `_decode_step` (rows past the edge dropped there, aimed at the last
    row with its own source here)."""
    jm, pm = target
    m = 24
    attn = [op.name for op in pm.ops
            if op.op_type.value == "multihead_attention"]
    rng = np.random.RandomState(21)
    base = {n: {v: rng.randn(SLOTS, m, 4, 8).astype(np.float32)
                for v in ("k_cache", "v_cache")} for n in attn}
    toks = rng.randint(1, 50, size=(SLOTS, k)).astype(np.int32)
    pos = np.array([3, m - 2, 11], np.int32)
    vals, new_state, _ = jm.executor.forward_values(
        jm.params, {**jm.state, **{n: {v: jnp.asarray(a) for v, a in
                                       c.items()} for n, c in base.items()}},
        {jm.input_ops[0].name: jnp.asarray(toks)}, None,
        CompMode.COMP_MODE_INFERENCE, decode_pos=jnp.asarray(pos))
    pcache = {n: {v: torch.from_numpy(a.copy()) for v, a in c.items()}
              for n, c in base.items()}
    probs = pm.executor.forward_values(
        {pm.input_ops[0].name: torch.from_numpy(toks)}, state=pcache,
        decode_pos=torch.from_numpy(pos))[pm.final_tensor.guid]
    np.testing.assert_allclose(probs.numpy(),
                               np.asarray(vals[jm.final_tensor.guid]),
                               atol=1e-6, rtol=1e-5)
    for n in attn:
        for v in ("k_cache", "v_cache"):
            np.testing.assert_allclose(pcache[n][v].numpy(),
                                       np.asarray(new_state[n][v]),
                                       atol=1e-6, rtol=1e-5)


def test_vector_entry_past_the_edge_touches_only_the_last_row(target):
    """A C = 1 step at a position at or past the cache edge (the draft's
    step j at pos + j on a sequence's last iteration) and C = 4 calls
    whose rows run past it: no index error, finite probabilities, and in
    every slot exactly the rows min(pos + j, M - 1) written, every other
    row untouched."""
    _, pm = target
    m = 16
    attn = [op.name for op in pm.ops
            if op.op_type.value == "multihead_attention"]
    g = torch.Generator().manual_seed(5)
    for c, pos in ((1, [m, 2, m + 2]), (4, [m + 1, 0, m - 1])):
        base = {n: {v: torch.randn((SLOTS, m, 4, 8), generator=g)
                    for v in ("k_cache", "v_cache")} for n in attn}
        caches = {n: {v: t.clone() for v, t in d.items()}
                  for n, d in base.items()}
        toks = torch.randint(1, 50, (SLOTS, c), generator=g,
                             dtype=torch.int32)
        probs = pm.executor.forward_values(
            {pm.input_ops[0].name: toks}, state=caches,
            decode_pos=torch.tensor(pos, dtype=torch.int32))[
            pm.final_tensor.guid]
        assert torch.isfinite(probs).all()
        for slot, p in enumerate(pos):
            written = {min(p + j, m - 1) for j in range(c)}
            for n in attn:
                for v in ("k_cache", "v_cache"):
                    same = (caches[n][v][slot] == base[n][v][slot]).all(
                        dim=(1, 2))
                    assert {r for r in range(m) if not same[r]} == written
