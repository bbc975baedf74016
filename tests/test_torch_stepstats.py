"""StepStats and the profiling utilities on the CPU (ROADMAP A9.2): the
port's `obs/stepstats.py` and `runtime/profiling.py` in JAX's scenarios
(tests/test_obs.py:481-514, tests/test_profiling_distributed.py:25-53),
and fit's `step_stats` against the JAX package's fit: as many records at
K = 1, K = 2 and under accumulation, the same steps and samples a
record, the same FLOPs a step, and the MFU over the machine spec's peak
(JAX's v5e on a CPU config, the H100's on a CUDA one).

Tolerance: counts, steps and samples identical; FLOPs and peaks exact;
times are the host's and only checked for sign and the derived rates'
formulas."""
import os
import time

import numpy as np
import pytest

import flexflow_tpu as ff
import flexflow_tpu_torch as pt
from flexflow_tpu.obs import stepstats as jstats
from flexflow_tpu_torch.obs import stepstats as pstats
from flexflow_tpu_torch.obs.registry import MetricsRegistry
from flexflow_tpu_torch.obs.stepstats import StepStats
from flexflow_tpu_torch.runtime import profiling
from tests.test_torch_zoo import one_torch_thread

_one_thread = pytest.fixture(scope="module", autouse=True)(one_torch_thread)


# -- StepStats (JAX tests/test_obs.py:481-514) ------------------------------
def test_stepstats_rates_and_summary():
    reg = MetricsRegistry()
    s = StepStats(flops_per_step=1e9, peak_tflops=10.0, registry=reg)
    s.start()
    time.sleep(0.005)
    rec = s.record_step(32, loss=1.5)
    assert rec["wall_ms"] >= 5.0 * 0.5  # timer resolution slack
    assert rec["samples_per_s"] > 0
    assert rec["tflops"] == pytest.approx(
        1e9 / (rec["step_ms"] / 1e3) / 1e12)
    assert rec["mfu"] == pytest.approx(rec["tflops"] / 10.0)
    time.sleep(0.001)
    s.record_step(32, loss=1.0, steps=4)  # a K-step chunk
    summ = s.summary()
    assert summ["steps"] == 5 and summ["recorded"] == 2
    assert summ["last_loss"] == 1.0
    assert summ["p95_step_ms"] >= summ["p50_step_ms"]
    assert reg.counter("ff_train_steps_total", "").value() == 5
    assert reg.histogram("ff_step_wall_ms", "").count() == 2
    assert reg.gauge("ff_step_mfu", "").value() == s.last()["mfu"]
    assert "step stats: 5 step(s)" in s.format_summary()


def test_stepstats_zero_dt_guard():
    s = StepStats(flops_per_step=1e9, peak_tflops=1.0,
                  registry=MetricsRegistry())
    s._mark = time.perf_counter() + 60.0  # force a non-positive interval
    rec = s.record_step(8, loss=0.1)
    assert rec["wall_ms"] == 0.0
    assert rec["samples_per_s"] == 0.0 and rec["mfu"] == 0.0


def test_stepstats_ring_capacity_and_empty_summary():
    s = StepStats(capacity=4, registry=MetricsRegistry())
    assert s.summary() == {"steps": 0, "recorded": 0}
    assert s.format_summary() == "step stats: no recorded steps"
    s.start()
    for _ in range(10):
        s.record_step(1)
    assert len(s) == 4 and s.total_steps == 10


def test_stepstats_families_match_jax():
    """The registry families StepStats publishes carry JAX's names, kinds
    and help (what /metrics shows)."""
    from flexflow_tpu.obs.registry import MetricsRegistry as JaxRegistry

    pr, jr = MetricsRegistry(), JaxRegistry()
    StepStats(registry=pr)
    jstats.StepStats(registry=jr)
    assert pr.render() == jr.render()


def test_iteration_timer_prints_and_keeps_process_families_clean():
    from flexflow_tpu_torch.obs import REGISTRY

    before = REGISTRY.counter("ff_train_steps_total", "").value()
    lines = []
    t = profiling.IterationTimer(8, print_freq=2, sink=lines.append)
    for _ in range(5):
        t.tick()
    assert t._count == 4 and len(lines) == 2
    assert "samples/s" in lines[0]
    assert REGISTRY.counter("ff_train_steps_total", "").value() == before


# -- fit's step_stats against JAX's -----------------------------------------
def _net(pkg, profiling_on=False, mixed=False):
    if pkg is pt:
        c = pt.FFConfig(batch_size=8, allow_mixed_precision=mixed,
                        device="cpu")
    else:
        c = ff.FFConfig()
        c.batch_size = 8
        c.num_devices = 1
        c.allow_mixed_precision = mixed
    c.profiling = profiling_on
    c.print_freq = 2
    m = pkg.FFModel(c)
    t = m.create_tensor([8, 16])
    t = m.dense(t, 32, pkg.ActiMode.AC_MODE_RELU)
    m.softmax(m.dense(t, 4))
    m.compile(optimizer=pkg.SGDOptimizer(m, lr=0.01),
              loss_type=pkg.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    return m


@pytest.mark.parametrize("fit_kw", [{}, {"steps_per_execution": 2},
                                    {"accum_steps": 2},
                                    {"steps_per_execution": 3}])
@pytest.mark.parametrize("mixed", [False, True])
def test_fit_step_stats_like_jax(fit_kw, mixed):
    """One record per committed step, accumulated update or K-step
    dispatch (a K = 3 fit's 2 trailing steps single), in JAX's numbers:
    steps and samples a record, total steps, FLOPs a step (3 x forward)
    and the peak (f32 or bf16 of the v5e spec, as JAX on the CPU)."""
    rng = np.random.RandomState(0)
    x = rng.randn(64, 16).astype(np.float32)
    y = rng.randint(0, 4, size=(64, 1)).astype(np.int32)
    got = {}
    for pkg in (ff, pt):
        m = _net(pkg, mixed=mixed)
        m.fit(x, y, epochs=2, **fit_kw)
        st = m.step_stats
        got[pkg] = ([(r["steps"], r["samples"]) for r in st.records()],
                    st.total_steps, st.flops_per_step, st.peak_tflops,
                    [r["loss"] for r in st.records()])
        assert all(r["wall_ms"] >= 0 for r in st.records())
        if pkg is pt:
            # the records' losses are fit's committed losses
            assert got[pkg][4] == [r["loss"] for r in m.step_records]
    # (the losses differ: the two models draw their own weights)
    assert got[pt][:4] == got[ff][:4]
    assert got[pt][3] == (197.0 if mixed else 49.0)


def test_fit_profiling_prints_rate_and_summary(capsys):
    """JAX tests/test_profiling_distributed.py:36-53: under
    config.profiling fit prints the samples/s line every print_freq
    steps and the step summary at its end."""
    m = _net(pt, profiling_on=True)
    rng = np.random.RandomState(0)
    m.fit(rng.randn(64, 16).astype(np.float32),
          np.zeros((64, 1), np.int32), epochs=1)
    out = capsys.readouterr().out
    assert "samples/s" in out and "ms/iter" in out
    assert out.count("iter ") == 4 and "step stats: 8 step(s)" in out
    m.config.profiling = False
    m.fit(rng.randn(64, 16).astype(np.float32),
          np.zeros((64, 1), np.int32), epochs=1)
    assert capsys.readouterr().out == ""


def test_mfu_reads_the_machine_specs_peak():
    """model_peak_tflops: the H100's 989 bf16 / 67 f32 TFLOP/s on a CUDA
    config, JAX's figures on the CPU, times the devices; the FLOPs a
    step are 3 x the ops' forward FLOPs, as JAX counts."""
    class Stub:
        def __init__(self, **kw):
            self.config = pt.FFConfig(**kw)

    assert pstats.model_peak_tflops(Stub(device="cuda")) == 989.0
    assert pstats.model_peak_tflops(
        Stub(device="cuda", allow_mixed_precision=False)) == 67.0
    assert pstats.model_peak_tflops(Stub(device="cuda", num_devices=4)) == \
        4 * 989.0
    assert pstats.model_peak_tflops(Stub(device="cpu")) == 197.0
    jm, pm_ = _net(ff), _net(pt)
    assert pstats.model_train_flops_per_step(pm_) == \
        jstats.model_train_flops_per_step(jm) == \
        3.0 * sum(op.flops() for op in pm_.ops)
    assert pstats.model_peak_tflops(pm_) == jstats.model_peak_tflops(jm)
    assert pstats.model_train_flops_per_step(pt.FFModel(
        pt.FFConfig(device="cpu"))) == 0.0


# -- profiling (JAX tests/test_profiling_distributed.py:25) -----------------
def test_profile_ops_returns_a_row_per_op(capsys):
    m = _net(pt)
    rows = profiling.profile_ops(m, warmup=1, repeats=2)
    assert sorted(r["op"] for r in rows) == sorted(
        op.name for op in m.ops if op.op_type.value != "input")
    types = {r["type"] for r in rows}
    assert "linear" in types and "softmax" in types
    measured = [r for r in rows if "error" not in r]
    assert len(measured) == len(rows)
    assert all(r["forward_us"] > 0 for r in measured)
    assert [r["forward_us"] for r in rows] == sorted(
        (r["forward_us"] for r in rows), reverse=True)
    # the first dense (16 -> 32) by name: rows are in time order, which
    # puts either dense first under load
    first = next(op.name for op in m.ops if op.op_type.value == "linear")
    lin = next(r for r in rows if r["op"] == first)
    assert lin["gflops"] == pytest.approx(2 * 8 * 16 * 32 / 1e9)
    profiling.print_profile(rows, top=5)
    assert "eff TFLOP/s" in capsys.readouterr().out


def test_trace_writes_a_chrome_trace(tmp_path):
    import json

    import torch

    with profiling.trace(str(tmp_path / "t")) as d:
        torch.ones(8).sum()
    trace = json.load(open(os.path.join(d, "trace.json")))
    assert trace["traceEvents"]


def test_print_event_log_like_jax():
    from flexflow_tpu.elastic.events import EventLog as JaxLog
    from flexflow_tpu.runtime.profiling import print_event_log as jprint
    from flexflow_tpu_torch.elastic.events import EventLog

    clock = iter(range(100)).__next__
    jclock = iter(range(100)).__next__
    logs = (EventLog(clock=clock), JaxLog(clock=jclock))
    for lg in logs:
        lg.record("watchdog.bad_step", step=3, loss=1.0)
        lg.record("watchdog.skip", step=4)
    for tail in (None, 1, 0):
        a, b = [], []
        profiling.print_event_log(logs[0], sink=a.append, tail=tail)
        jprint(logs[1], sink=b.append, tail=tail)
        assert a == b
