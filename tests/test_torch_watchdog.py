"""The training watchdog, its event log and `fit(watchdog=)` on the CPU
(the watchdog part of ROADMAP A9.2), against the JAX package in the
scenarios of tests/test_watchdog.py:50-112 and 195-208: the verdict
state machine, the spike check, `guard`, and fit's abort with the same
events and the same step as JAX's fit, one step a dispatch and K steps a
dispatch; then the graph mutation hooks that serving's batch-norm fold
uses (core/graph.py, search/substitution.py `_rewire`) against JAX's."""
import numpy as np
import pytest

import flexflow_tpu as ff
import flexflow_tpu_torch as pt
from flexflow_tpu.elastic import NumericBlowup as JaxBlowup
from flexflow_tpu.elastic import TrainingWatchdog as JaxWatchdog
from flexflow_tpu.elastic import WatchdogPolicy as JaxPolicy
from flexflow_tpu_torch.elastic import (EventLog, NumericBlowup,
                                        TrainingWatchdog, WatchdogPolicy,
                                        reset_watchdog_counters,
                                        watchdog_counters)
from tests.test_torch_zoo import one_torch_thread

_one_thread = pytest.fixture(scope="module", autouse=True)(one_torch_thread)


def test_policy_validation():
    with pytest.raises(ValueError):
        WatchdogPolicy(spike_factor=1.0)
    with pytest.raises(ValueError):
        WatchdogPolicy(max_consecutive_bad=0)


def test_nonfinite_skips_then_rollback_then_reset():
    events = EventLog()
    wd = TrainingWatchdog(WatchdogPolicy(max_consecutive_bad=3,
                                         warmup_steps=0), events=events)
    assert wd.check(0, 1.0) == "ok"
    assert wd.check(1, float("nan")) == "skip"
    assert wd.check(2, float("inf")) == "skip"
    assert wd.check(3, float("nan")) == "rollback"
    assert wd.check(4, float("nan")) == "skip"
    assert wd.check(5, 1.0) == "ok"
    assert wd.consecutive_bad == 0
    assert len(events.events("watchdog.bad_step")) == 4
    assert len(events.events("watchdog.skip")) == 3
    assert events.events("watchdog.rollback") == []
    wd.note_rollback(2)
    assert [e.step for e in events.events("watchdog.rollback")] == [2]
    assert events.counts() == {"watchdog.bad_step": 4, "watchdog.skip": 3,
                               "watchdog.rollback": 1}
    assert EventLog.from_json(events.to_json()).counts() == events.counts()


@pytest.mark.parametrize("losses", [
    [40.0, 2.0, 2.0, 2.0, 200.0, 2.0],
    [1.0, 1.2, float("inf"), 0.9, 50.0, 51.0, 52.0, 1.0],
])
def test_verdicts_match_jax(losses):
    """The same loss stream gives JAX's verdicts, reasons and EMA."""
    kw = dict(spike_factor=5.0, warmup_steps=3, ema_alpha=0.5,
              max_consecutive_bad=2)
    wd = TrainingWatchdog(WatchdogPolicy(**kw))
    jwd = JaxWatchdog(JaxPolicy(**kw))
    got = [wd.check(i, v) for i, v in enumerate(losses)]
    assert got == [jwd.check(i, v) for i, v in enumerate(losses)]
    assert wd._ema == jwd._ema
    assert [e.details for e in wd.events.events()] == \
        [e.details for e in jwd.events.events()]


def test_guard_raises_numeric_blowup():
    wd = TrainingWatchdog(WatchdogPolicy(max_consecutive_bad=1,
                                         warmup_steps=0))
    wd.guard(0, 1.0)
    with pytest.raises(NumericBlowup, match="step 3"):
        wd.guard(3, float("nan"))


def _dense_net(pkg, batch=8):
    if pkg is pt:
        config = pt.FFConfig(batch_size=batch, allow_mixed_precision=False,
                             device="cpu")
    else:
        config = ff.FFConfig()
        config.batch_size = batch
        config.num_devices = 1
        config.allow_mixed_precision = False
    m = pkg.FFModel(config)
    t = m.create_tensor([batch, 32])
    t = m.dense(t, 64, pkg.ActiMode.AC_MODE_RELU)
    m.softmax(m.dense(t, 10))
    m.compile(optimizer=pkg.SGDOptimizer(m, lr=0.05),
              loss_type=pkg.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    return m


@pytest.mark.parametrize("fit_kw", [{}, {"steps_per_execution": 2},
                                    {"accum_steps": 2}])
def test_model_fit_watchdog_aborts_on_nan_like_jax(fit_kw):
    """Inf inputs blow every step up: fit raises NumericBlowup after
    max_consecutive_bad committed losses, at the same step and with the
    same events as JAX's fit (a K-step dispatch is checked once, on its
    mean loss)."""
    x = np.full((64, 32), np.inf, dtype=np.float32)
    y = np.zeros((64, 1), np.int32)
    raised = []
    for pkg, wd_cls, pol_cls, err in ((ff, JaxWatchdog, JaxPolicy,
                                       JaxBlowup),
                                      (pt, TrainingWatchdog, WatchdogPolicy,
                                       NumericBlowup)):
        wd = wd_cls(pol_cls(max_consecutive_bad=2, warmup_steps=0))
        with pytest.raises(err, match="consecutive bad steps") as e:
            _dense_net(pkg).fit(x, y, epochs=3, watchdog=wd, **fit_kw)
        raised.append((str(e.value).split(":")[0],
                       [(ev.kind, ev.step) for ev in wd.events.events()]))
    assert raised[1] == raised[0]
    assert len([k for k, _ in raised[1][1] if k == "watchdog.bad_step"]) == 2


def test_fit_watchdog_quiet_on_healthy_training():
    rng = np.random.RandomState(0)
    x = rng.randn(64, 32).astype(np.float32)
    y = rng.randint(0, 10, size=(64, 1)).astype(np.int32)
    wd = TrainingWatchdog()
    _dense_net(pt).fit(x, y, epochs=2, watchdog=wd, steps_per_execution=2)
    assert len(wd.events) == 0 and wd._good_steps == 8


def test_fit_drift_detector_raises_naming_a75():
    """A7.5 is ported: fit takes the drift detector (no longer raises) and
    feeds it each committed step; one without `observe` fails as any
    object missing the detector's interface does
    (tests/test_torch_calibration.py holds it against JAX's fit)."""
    from flexflow_tpu_torch.obs import DriftDetector

    x = np.zeros((8, 32), np.float32)
    y = np.zeros((8, 1), np.int32)
    det = DriftDetector(1e6)
    _dense_net(pt).fit(x, y, epochs=1, drift_detector=det)
    assert det._seen == 1
    with pytest.raises(AttributeError, match="observe"):
        _dense_net(pt).fit(x, y, epochs=1, drift_detector=object())


def test_watchdog_counters_on_metrics():
    from flexflow_tpu_torch.serving import InferenceServer

    reset_watchdog_counters()
    wd = TrainingWatchdog(WatchdogPolicy(max_consecutive_bad=2,
                                         warmup_steps=0))
    wd.check(0, float("nan"))
    assert watchdog_counters() == {"bad_steps": 1, "skips": 1}
    srv = InferenceServer()
    text = srv.prometheus_text()
    assert "ff_watchdog_bad_steps_total 1" in text
    assert "ff_watchdog_skips_total 1" in text
    assert srv.stats()["_watchdog"]["bad_steps"] == 1
    reset_watchdog_counters()
    assert watchdog_counters() == {}


# ---------------------------------------------------------------------
# graph mutation (core/graph.py, search/substitution.py)
# ---------------------------------------------------------------------
def _chain(pkg):
    m = pkg.FFModel(pt.FFConfig(device="cpu") if pkg is pt
                    else ff.FFConfig())
    t = m.create_tensor([4, 8])
    a = m.dense(t, 8, name="a")
    b = m.relu(a, name="b")
    m.dense(b, 2, name="c")
    return m


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_rewire_and_remove_keep_topo_and_aliases(pkg):
    """Rewiring b's consumers onto a, then removing b: the cached order
    drops b, c reads a, resolve_tensor follows b's output to a's, and an
    alias into a removed producer is dropped — the same in both
    packages."""
    if pkg == "jax":
        from flexflow_tpu.core.graph import Graph
        from flexflow_tpu.search.substitution import _rewire
        m = _chain(ff)
    else:
        from flexflow_tpu_torch.core.graph import Graph
        from flexflow_tpu_torch.search.substitution import _rewire
        m = _chain(pt)
    ops = {op.name: op for op in m.ops}
    g = Graph(m.ops)
    first = g.topo_order()
    assert g.topo_order() is first  # cached
    assert [op.name for op in first] == ["input_0", "a", "b", "c"]
    _rewire(g, ops["b"].outputs[0], ops["a"].outputs[0])
    assert ops["c"].inputs[0] is ops["a"].outputs[0]
    g.remove_op(ops["b"])
    order = g.topo_order()
    assert order is not first and ops["b"] not in g
    assert [op.name for op in order] == ["input_0", "a", "c"]
    assert g.resolve_tensor(ops["b"].outputs[0]) is ops["a"].outputs[0]
    # an alias that resolves into a removed producer is dropped
    g.tensor_aliases[ops["c"].outputs[0].guid] = ops["a"].outputs[0]
    g.remove_op(ops["a"])
    assert ops["c"].outputs[0].guid not in g.tensor_aliases
    assert ops["b"].outputs[0].guid not in g.tensor_aliases
    g.add_op(ops["a"])
    assert len(g) == 3 and ops["a"] in g
    g.invalidate_topo()
    assert [op.name for op in g.topo_order()] == ["input_0", "a", "c"]
