"""flexflow_tpu_torch.obs.registry against flexflow_tpu.obs.registry on
the CPU: the same sequence of counter, gauge and histogram calls renders
the same exposition text, histogram quantiles agree, and both refuse the
same family clashes."""
import math

import pytest

from flexflow_tpu.obs import registry as jax_obs
from flexflow_tpu_torch.obs import registry as obs


def _drive(mod):
    """One sequence of calls through a registry of `mod`; returns it."""
    reg = mod.MetricsRegistry()
    c = reg.counter("ff_test_requests_total", 'Requests "by" outcome\\n',
                    labels=("outcome",))
    c.inc(outcome="ok")
    c.inc(2.5, outcome='we"ird\\\nlabel')
    c.set_total(7, outcome="mirrored")
    plain = reg.counter("ff_test_plain_total", "An unlabelled counter")
    plain.inc(0)
    g = reg.gauge("ff_test_depth", "Depth", labels=("pool",))
    g.set(3, pool="a")
    g.inc(pool="a")
    g.dec(0.5, pool="a")
    g.set(1e20, pool="b")
    g.set(float("nan"), pool="c")
    g.set(-math.inf, pool="d")
    g.remove(pool="d")
    h = reg.histogram("ff_test_ttft_ms", "TTFT", labels=("cache",))
    for v, ex in ((0.5, None), (3.0, "t1"), (40.0, None), (40.0, "t2"),
                  (9e3, "t3")):
        h.observe(v, exemplar=ex, cache="hit")
    h.observe(12.0, cache="miss")
    h.observe(1.0, cache="gone")
    h.remove(cache="gone")
    hb = reg.histogram("ff_test_sizes", "Sizes", buckets=(1, 10, 100))
    for v in (0, 5, 5, 50, 500):
        hb.observe(v)
    reg.counter("ff_test_reset_total", "Reset").inc(4)
    reg.reset_all(prefix="ff_test_reset")
    return reg


def test_registry_renders_the_jax_exposition():
    ours, theirs = _drive(obs), _drive(jax_obs)
    assert ours.render() == theirs.render()
    assert [f.name for f in ours.families()] == \
        [f.name for f in theirs.families()]


@pytest.mark.parametrize("q", [0.0, 0.1, 0.5, 0.9, 0.99, 1.0])
def test_histogram_quantiles_match_jax(q):
    ours, theirs = _drive(obs), _drive(jax_obs)
    for name, labels in (("ff_test_ttft_ms", {"cache": "hit"}),
                         ("ff_test_sizes", {})):
        a, b = ours.get(name), theirs.get(name)
        assert a.quantile(q, **labels) == b.quantile(q, **labels)
        snap_a, snap_b = a.snapshot(**labels), b.snapshot(**labels)
        assert snap_a == snap_b
        a.observe(7.0, **labels)
        b.observe(7.0, **labels)
        assert a.quantile(q, since=snap_a, **labels) == \
            b.quantile(q, since=snap_b, **labels)
        assert a.count(**labels) == b.count(**labels)
        assert a.sum(**labels) == b.sum(**labels)
    assert ours.get("ff_test_ttft_ms").exemplar(50.0, cache="hit") == \
        theirs.get("ff_test_ttft_ms").exemplar(50.0, cache="hit") == \
        ("t2", 40.0)


def test_registry_refuses_what_jax_refuses():
    for mod in (obs, jax_obs):
        reg = mod.MetricsRegistry()
        reg.counter("ff_x_total", labels=("a",))
        with pytest.raises(ValueError, match="already registered"):
            reg.gauge("ff_x_total", labels=("a",))
        with pytest.raises(ValueError, match="already registered"):
            reg.counter("ff_x_total", labels=("b",))
        reg.histogram("ff_h", buckets=(1, 2))
        with pytest.raises(ValueError, match="buckets"):
            reg.histogram("ff_h", buckets=(1, 3))
        assert reg.histogram("ff_h") is reg.get("ff_h")
        with pytest.raises(ValueError, match="invalid metric name"):
            reg.counter("9bad")
        with pytest.raises(ValueError, match="invalid label name"):
            reg.counter("ff_y_total", labels=("bad-label",))
        with pytest.raises(ValueError, match="only go up"):
            reg.counter("ff_x_total", labels=("a",)).inc(-1, a="x")
        with pytest.raises(ValueError, match="family declares"):
            reg.counter("ff_x_total", labels=("a",)).inc(b="x")
        with pytest.raises(ValueError, match=r"want \[0, 1\]"):
            reg.histogram("ff_h").quantile(1.5)
