"""The traffic generator: the same seed gives the same inputs, and every
seed gets the same amount of work in another order."""
import statistics

import numpy as np
import pytest

from benchmark import harness
from benchmark import traffic as gen

SEED = 2 ** 31 + 12345   # more than 32 signed bits hold


def _mix(name):
    return harness.read_json(harness.HERE / "traffic" / f"{name}.json")


def test_train_pool_deterministic_and_learnable():
    mix = dict(_mix("train-s512"), batch=4, seq=8, pool_batches=5)
    x1, y1 = gen.train_pool(mix, 1000, SEED)
    x2, y2 = gen.train_pool(mix, 1000, SEED)
    x3, _ = gen.train_pool(mix, 1000, SEED + 1)
    assert x1.shape == (5, 4, 8) and y1.shape == (5, 4, 8, 1)
    assert np.array_equal(x1, x2) and np.array_equal(y1, y2)
    assert not np.array_equal(x1, x3)
    # every batch differs, and a token's target is always the same
    assert len({b.tobytes() for b in x1}) == 5
    pairs = {}
    for t, target in zip(x1.ravel(), y1.ravel()):
        assert pairs.setdefault(t, target) == target


def test_open_loop_same_work_every_seed():
    mix = _mix("chat-poisson")
    a = gen.open_loop(mix, 50257, SEED, 10.0)
    b = gen.open_loop(mix, 50257, SEED, 10.0)
    c = gen.open_loop(mix, 50257, SEED + 7, 10.0)
    n = round(mix["arrivals"]["rate"] * 10.0)
    assert len(a) == len(c) == n
    assert all(np.array_equal(r.prompt, s.prompt) and r.due == s.due
               for r, s in zip(a, b))
    assert sorted(r.prompt.size for r in a) == sorted(r.prompt.size
                                                      for r in c)
    assert sorted(r.max_new for r in a) == sorted(r.max_new for r in c)
    assert [r.prompt.size for r in a] != [r.prompt.size for r in c]
    dues = [r.due for r in a]
    assert dues[0] == 0.0 and dues == sorted(dues) and dues[-1] < 10.0
    lo, hi = mix["prompt"]["min"], mix["prompt"]["max"]
    assert all(lo <= r.prompt.size <= hi for r in a)
    sizes = [r.prompt.size for r in a]
    assert abs(statistics.median(sizes) - mix["prompt"]["median"]) <= 3


@pytest.mark.parametrize("seconds", [4.0, 10.0, 30.0])
def test_open_loop_blocks_hold_the_grid(seconds):
    """Every block of arrivals holds the same lengths and gaps in the
    seed's order and spans block / rate seconds, so no seed bunches its
    long prompts more than another; a longer window only adds blocks."""
    mix = _mix("chat-poisson")
    block, rate = mix["block"], mix["arrivals"]["rate"]
    span = block / rate
    a = gen.open_loop(mix, 50257, SEED, seconds)
    c = gen.open_loop(mix, 50257, SEED + 1, seconds)
    assert len(a) == len(c) == round(rate * seconds)
    for lo in range(0, len(a), block):
        pa, pc = a[lo:lo + block], c[lo:lo + block]
        assert sorted(r.prompt.size for r in pa) == \
            sorted(r.prompt.size for r in pc)
        assert sorted(r.max_new for r in pa) == sorted(r.max_new for r in pc)
        start = lo // block * span
        assert pa[0].due == pytest.approx(start)
        assert all(start <= r.due < start + span for r in pa)
    longer = gen.open_loop(mix, 50257, SEED, seconds + 2 * span)
    assert len(longer) == len(a) + 2 * block
    assert all(np.array_equal(r.prompt, s.prompt) and r.due == s.due
               and r.max_new == s.max_new for r, s in zip(a, longer))


def test_closed_loop_blocks_hold_the_grid():
    mix = dict(_mix("offline-closed"), pool=96)
    a = gen.closed_loop(mix, 50257, SEED)
    c = gen.closed_loop(mix, 50257, SEED + 1)
    for lo in range(0, 96, mix["block"]):
        assert sorted(r.max_new for r in a[lo:lo + mix["block"]]) == \
            sorted(r.max_new for r in c[lo:lo + mix["block"]])
    assert {r.prompt.size for r in a} <= set(range(128, 641))


@pytest.mark.parametrize("spec,n,want", [
    ({"dist": "uniform", "min": 1, "max": 4}, 8, [1, 1, 2, 2, 3, 3, 4, 4]),
    ({"dist": "uniform", "min": 16, "max": 240}, 4, [44, 100, 156, 212]),
    ({"dist": "lognormal", "median": 100, "sigma": 1.0, "min": 10,
      "max": 1000}, 1, [100]),
])
def test_grid(spec, n, want):
    assert gen.grid(spec, n).tolist() == want


def test_warmup_prompts_fixed():
    a = gen.warmup_prompts(3, 17, 100)
    assert [p.size for p in a] == [17] * 3
    assert all(np.array_equal(p, q)
               for p, q in zip(a, gen.warmup_prompts(3, 17, 100)))
