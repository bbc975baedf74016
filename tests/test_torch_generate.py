"""flexflow_tpu_torch's GenerativeSession on the CPU against the JAX
package's (tests/test_generate.py's eight cases): the same tiny LMs and
weights (`params_from_jax`), greedy tokens identical; the prefill fills
the caches through the full-sequence path, under the kernel tier through
the flash kernel's plain version. Sampled tokens are the port's own
(Gumbel noise hashed from key, position and id, not jax.random), so those
cases hold the port's invariants."""
import numpy as np
import pytest
import torch

from flexflow_tpu.serving.generate import \
    GenerativeSession as JaxSession
from flexflow_tpu_torch import params_from_jax
from flexflow_tpu_torch.kernels.registry import KERNELS
from flexflow_tpu_torch.serving import GenerativeSession
from flexflow_tpu_torch.serving.generate import gumbel_noise, pick_tokens
from flexflow_tpu_torch.serving.sched.bench import build_tiny_lm
from tests.conftest import module_xla_cache
from tests.test_generate import _build_lm, _naive_generate

_xla_cache = pytest.fixture(scope="module", autouse=True)(module_xla_cache)


def _pair(b, window, use_flash=None):
    jm = _build_lm(b, window, use_flash=use_flash)
    pm = build_tiny_lm(b, window, vocab=50, device="cpu")
    params_from_jax(pm, jm.params)
    return jm, pm


@pytest.fixture(scope="module")
def lm2():
    return _pair(2, 12)


@pytest.fixture(scope="module")
def lm1():
    return _pair(1, 12)


def _prompt(seed, b, n):
    return np.random.RandomState(seed).randint(
        1, 50, size=(b, n)).astype(np.int32)


def test_kv_cache_generate_matches_jax_and_naive_loop(lm2):
    jm, pm = lm2
    prompt = _prompt(0, 2, 4)
    ref = _naive_generate(jm, prompt, 5, 12)
    np.testing.assert_array_equal(
        JaxSession(jm, max_len=12).generate(prompt, 5), ref)
    session = GenerativeSession(pm, max_len=12)
    np.testing.assert_array_equal(session.generate(prompt, 5), ref)
    # the prefill is one walk; the CPU runs every decode dispatch eagerly
    assert session.counts["eager_walks"] == 5
    assert session.counts["captures"] == session.counts["replays"] == 0


def test_chunked_decode_matches_per_step_loop(lm2):
    """tokens_per_dispatch = 3 (chunks of 3, one ragged) gives the
    per-step loop's tokens, and JAX's."""
    jm, pm = lm2
    prompt = _prompt(2, 2, 4)
    ref = JaxSession(jm, max_len=12).generate(prompt, 5)
    session = GenerativeSession(pm, max_len=12)
    np.testing.assert_array_equal(session.generate(prompt, 5), ref)
    np.testing.assert_array_equal(
        session.generate(prompt, 5, tokens_per_dispatch=3), ref)
    # one dispatch function per (k, temperature, top_k), as JAX's scans
    assert sorted(session._decode_scans) == [(1, 0.0, None),
                                             (3, 0.0, None)]


def test_chunked_decode_eos_stops_same_step(lm1):
    jm, pm = lm1
    prompt = _prompt(3, 1, 4)
    ref = JaxSession(jm, max_len=12).generate(prompt, 8)
    eos = int(ref[0, 1])
    ref_eos = JaxSession(jm, max_len=12).generate(prompt, 8, eos_id=eos)
    assert ref_eos.shape[1] < 8
    for k in (1, 4):
        got = GenerativeSession(pm, max_len=12).generate(
            prompt, 8, eos_id=eos, tokens_per_dispatch=k)
        np.testing.assert_array_equal(got, ref_eos)


def test_sampled_decode_chunk_invariant(lm2):
    """The same seed gives the same sampled tokens at any
    tokens_per_dispatch, another seed other tokens, temperature 0 the
    greedy ones (the invariants of JAX's test; the draws are the
    port's)."""
    jm, pm = lm2
    prompt = _prompt(6, 2, 4)
    kw = dict(temperature=1.0, top_k=10, seed=42)
    ref = GenerativeSession(pm, max_len=12).generate(prompt, 6, **kw)
    got = GenerativeSession(pm, max_len=12).generate(
        prompt, 6, tokens_per_dispatch=4, **kw)
    np.testing.assert_array_equal(got, ref)
    other = GenerativeSession(pm, max_len=12).generate(
        prompt, 6, temperature=1.0, top_k=10, seed=43)
    assert not np.array_equal(other, ref)
    greedy = JaxSession(jm, max_len=12).generate(prompt, 6)
    greedy0 = GenerativeSession(pm, max_len=12).generate(
        prompt, 6, temperature=0.0, seed=7)
    np.testing.assert_array_equal(greedy0, greedy)


def test_partial_batch_prompts_pad_and_slice(lm2):
    jm, pm = lm2
    prompt = _prompt(8, 2, 4)
    full = JaxSession(jm, max_len=12).generate(prompt, 5)
    one = GenerativeSession(pm, max_len=12).generate(
        prompt[:1], 5, tokens_per_dispatch=3)
    assert one.shape == (1, 5)
    np.testing.assert_array_equal(one, full[:1])
    s = GenerativeSession(pm, max_len=12)
    with pytest.raises(ValueError, match="exceed the session batch"):
        s.generate(np.zeros((3, 4), np.int32), 5)
    with pytest.raises(ValueError, match="non-empty"):
        s.generate(np.zeros((4,), np.int32), 5)
    with pytest.raises(ValueError, match="prefill window"):
        s.generate(np.zeros((2, 13), np.int32), 1)
    with pytest.raises(ValueError, match="cache capacity"):
        s.generate(np.zeros((2, 4), np.int32), 9)
    with pytest.raises(ValueError, match="prefill window"):
        GenerativeSession(pm, max_len=11)


def test_generate_zero_tokens_returns_empty(lm2):
    _, pm = lm2
    prompt = _prompt(5, 2, 4)
    for k in (1, 4):
        got = GenerativeSession(pm, max_len=12).generate(
            prompt, 0, tokens_per_dispatch=k)
        assert got.shape == (2, 0), got.shape


def test_kv_cache_generate_flash_prefill_matches_jax():
    """The kernel tier's prefill: the packed flash kernel (its plain
    version on the CPU, causal) fills the caches, against the JAX
    session with use_flash=True (the Pallas kernel in interpret mode)
    and the naive loop."""
    jm, pm = _pair(2, 12, use_flash=True)
    prompt = _prompt(4, 2, 4)
    ref = _naive_generate(jm, prompt, 5, 12)
    np.testing.assert_array_equal(
        JaxSession(jm, max_len=12).generate(prompt, 5), ref)
    with KERNELS.override("attention", "pallas"):
        got = GenerativeSession(pm, max_len=12).generate(prompt, 5)
    np.testing.assert_array_equal(got, ref)


def test_generate_eos_early_stop(lm1):
    jm, pm = lm1
    prompt = _prompt(1, 1, 3)
    first = JaxSession(jm, max_len=12).generate(prompt, 6)
    eos = int(first[0, 1])
    want = int(np.argmax(first[0] == eos)) + 1
    session = GenerativeSession(pm, max_len=12)
    np.testing.assert_array_equal(session.generate(prompt, 6), first)
    got = session.generate(prompt, 6, eos_id=eos)
    assert got.shape[1] == want, got
    np.testing.assert_array_equal(got[0], first[0, :want])


def test_gumbel_noise_is_a_function_of_key_position_and_id():
    """The noise of a row depends on (key, position, id) only: equal
    inputs give equal bits whatever the rows around them, and it follows
    the standard Gumbel law closely (mean 0.5772, variance pi^2 / 6)."""
    keys = torch.tensor([7, -5, 7], dtype=torch.int32)
    pos = torch.tensor([3, 3, 3], dtype=torch.int32)
    g = gumbel_noise(keys, pos, 4096)
    assert torch.equal(g[0], g[2]) and not torch.equal(g[0], g[1])
    alone = gumbel_noise(keys[2:], pos[2:], 4096)
    assert torch.equal(alone[0], g[2])
    assert not torch.equal(gumbel_noise(keys, pos + 1, 4096)[0], g[0])
    big = gumbel_noise(torch.arange(64, dtype=torch.int32),
                       torch.zeros(64, dtype=torch.int32), 4096)
    assert abs(float(big.mean()) - 0.5772) < 0.01
    assert abs(float(big.var()) - np.pi ** 2 / 6) < 0.03
    probs = torch.softmax(torch.randn(3, 50), -1)
    assert torch.equal(pick_tokens(probs, 0.0, None, None, None),
                       probs.argmax(-1))
