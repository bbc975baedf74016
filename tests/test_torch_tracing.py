"""The port's tracer on the CPU (ROADMAP A9.1, A5.7's rest):
flexflow_tpu_torch.obs.tracing through the tracer cases of
tests/test_obs.py (Chrome-trace export checked by the JAX package's
`validate_trace`, spans' errors and args, the disabled path's cost, the
ring and its drop counter, handoff / resume across threads); `fit`'s
dispatch spans (one `executor.train_step` an eager step, one
`executor.multi_step` a K = 4 dispatch and no inner step span), the
manual loop's and predict's `executor.forward`, compile's spans; and the
continuous batcher's request spans on a tiny LM, on a thread named by
`trace_label`. Exact counts throughout; the cost bounds are
tests/test_obs.py's."""
import json
import threading
import time

import numpy as np
import pytest
import torch

import flexflow_tpu_torch as pt
from flexflow_tpu.obs.cli import validate_trace
from flexflow_tpu_torch.obs import REGISTRY
from flexflow_tpu_torch.obs.tracing import (Tracer, disable_tracing,
                                            enable_tracing, get_tracer,
                                            root_context, use_context)
from flexflow_tpu_torch.serving.sched import ContinuousBatcher
from flexflow_tpu_torch.serving.sched.bench import build_tiny_lm
from tests.test_torch_zoo import one_torch_thread

_one_thread = pytest.fixture(scope="module", autouse=True)(one_torch_thread)


def test_chrome_trace_events_are_spec_compliant(tmp_path):
    t = Tracer(enabled=True)
    with t.span("outer", phase="demo"):
        time.sleep(0.002)
        with t.span("inner"):
            time.sleep(0.001)
        with t.span("inner"):
            pass
    t.instant("marker", note=1)
    path = t.export_chrome_trace(str(tmp_path / "trace.json"))
    with open(path) as f:
        data = json.load(f)
    events = [e for e in data["traceEvents"] if e.get("ph") == "X"]
    assert len(events) == 3
    for e in events:
        for field in ("name", "ph", "ts", "dur", "pid", "tid"):
            assert field in e, (field, e)
        assert e["dur"] >= 0
    outer = next(e for e in events if e["name"] == "outer")
    for inner in (e for e in events if e["name"] == "inner"):
        assert outer["ts"] <= inner["ts"] + 1e-3
        assert (inner["ts"] + inner["dur"]
                <= outer["ts"] + outer["dur"] + 1e-3)
    assert validate_trace(path) == ["inner", "marker", "outer"]
    proc = next(e for e in data["traceEvents"]
                if e.get("name") == "process_name")
    assert proc["args"]["name"] == "flexflow_tpu_torch"


def test_span_records_exception_and_args():
    t = Tracer(enabled=True)
    with pytest.raises(RuntimeError):
        with t.span("boom", step=3):
            raise RuntimeError("x")
    (ev,) = t.events("boom")
    assert ev["args"]["error"] == "RuntimeError"
    assert ev["args"]["step"] == 3


def test_disabled_tracing_is_effectively_free():
    t = Tracer(enabled=False)

    def per_span_us(n=5_000, repeats=5):
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            for _ in range(n):
                with t.span("hot"):
                    pass
            best = min(best, (time.perf_counter() - t0) / n * 1e6)
        return best

    disabled_us = per_span_us()
    assert disabled_us < 20.0, f"disabled span cost {disabled_us:.2f}us"
    assert t.events() == []
    t.enable()
    enabled_us = per_span_us()
    assert enabled_us < 250.0, f"enabled span cost {enabled_us:.2f}us"


def test_tracer_ring_bounds_memory_and_counts_drops():
    t = Tracer(enabled=True, max_events=10)
    for i in range(50):
        with t.span(f"s{i}"):
            pass
    evs = t.events()
    assert len(evs) == 10 and evs[0]["name"] == "s40"
    assert t.dropped_events == 40
    meta = next(e for e in t.to_chrome_trace()["traceEvents"]
                if e.get("ph") == "M" and e["name"] == "trace_metadata")
    assert meta["args"]["dropped_events"] == 40
    assert meta["args"]["epoch_wall_s"] > 0
    assert REGISTRY.counter("ff_trace_events_dropped_total",
                            "").value() == 40
    t.clear()
    assert t.dropped_events == 0


def test_handoff_resume_stitches_spans_across_threads(tmp_path):
    t = Tracer(enabled=True)
    t.set_thread_name("client")
    ctx = root_context()
    with use_context(ctx):
        with t.span("submit"):
            token = t.handoff("crossing")

    def worker():
        t.set_thread_name("sched")
        with t.resume(token), t.span("prefill", request=1):
            pass

    th = threading.Thread(target=worker)
    th.start()
    th.join(10.0)
    assert not th.is_alive()
    spans = {e["name"]: e for e in t.events() if e["ph"] == "X"}
    assert spans["prefill"]["args"]["trace_id"] == ctx.trace_id
    assert spans["prefill"]["args"]["parent_id"] \
        == spans["submit"]["args"]["span_id"]
    assert spans["submit"]["tid"] != spans["prefill"]["tid"]
    s, f = [e for e in t.events() if e["ph"] in ("s", "f")]
    assert (s["ph"], f["ph"]) == ("s", "f")
    assert s["id"] == f["id"] and s["cat"] == f["cat"] == "handoff"
    assert f["bp"] == "e"
    with t.resume(token):
        pass
    assert len([e for e in t.events() if e["ph"] == "f"]) == 1
    path = t.export_chrome_trace(str(tmp_path / "t.json"))
    assert validate_trace(path) == ["prefill", "submit"]
    with open(path) as fh:
        names = {e["args"]["name"] for e in json.load(fh)["traceEvents"]
                 if e.get("ph") == "M" and e.get("name") == "thread_name"}
    assert {"client", "sched"} <= names


def test_handoff_is_noop_when_disabled_or_contextless():
    t = Tracer(enabled=False)
    assert t.handoff() is None
    with t.resume(None):
        pass
    t.enable()
    assert t.handoff() is None
    assert t.events() == []


def test_instant_args_are_jsonable(tmp_path):
    t = Tracer(enabled=True)
    t.instant("marker", arr=np.arange(3), val=np.float64(1.5),
              n=np.int64(7), dev=torch.zeros(()))
    path = t.export_chrome_trace(str(tmp_path / "t.json"))
    with open(path) as fh:
        (ev,) = [e for e in json.load(fh)["traceEvents"]
                 if e.get("ph") == "i"]
    assert ev["args"]["val"] == 1.5


# -- the runtime's spans -----------------------------------------------------
def _small_model():
    m = pt.FFModel(pt.FFConfig(batch_size=8, allow_mixed_precision=False,
                               device="cpu"))
    t = m.dense(m.create_tensor([8, 16]), 32, pt.ActiMode.AC_MODE_RELU)
    m.softmax(m.dense(t, 4))
    m.compile(optimizer=pt.SGDOptimizer(m, lr=0.01),
              loss_type=pt.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
              metrics=[pt.MetricsType.METRICS_ACCURACY])
    return m


def _data(n=32):
    rng = np.random.RandomState(0)
    return (rng.randn(n, 16).astype(np.float32),
            rng.randint(0, 4, size=(n, 1)).astype(np.int32))


@pytest.fixture
def tracer():
    tr = enable_tracing()
    tr.clear()
    yield tr
    disable_tracing()
    tr.clear()


def test_fit_with_tracing_emits_dispatch_spans(tracer):
    m = _small_model()
    x, y = _data()
    m.fit(x, y, epochs=1)
    names = tracer.span_names()
    assert "compile" in names and "compile.build_steps" in names
    build = tracer.events("compile.build_steps")[0]
    comp = tracer.events("compile")[0]
    assert comp["ts"] <= build["ts"] and \
        build["ts"] + build["dur"] <= comp["ts"] + comp["dur"] + 1e-3
    assert comp["args"]["ops"] == 4
    assert len(tracer.events("executor.train_step")) == 4


def test_k_step_fit_emits_one_span_a_dispatch(tracer):
    m = _small_model()
    x, y = _data(80)
    tracer.clear()
    m.fit(x, y, epochs=1, steps_per_execution=4)
    # 80 samples at batch 8: 2 dispatches of 4, then 2 single steps
    multi = tracer.events("executor.multi_step")
    assert len(multi) == 2 and all(e["args"]["steps"] == 4 for e in multi)
    assert len(tracer.events("executor.train_step")) == 2


def test_eval_predict_and_manual_loop_spans(tracer):
    m = _small_model()
    x, y = _data(20)
    tracer.clear()
    m.eval(x, y)
    m.predict(x)
    m.set_iteration_batch([x[:8]], y[:8])
    m.forward()
    m.backward()
    m.update()
    assert len(tracer.events("executor.eval_step")) == 3
    # predict's three batches and the manual forward
    assert len(tracer.events("executor.forward")) == 4
    assert not tracer.events("executor.train_step")


def test_disabled_tracing_records_nothing():
    tr = get_tracer()
    assert not tr.enabled
    tr.clear()
    m = _small_model()
    x, y = _data()
    m.fit(x, y, epochs=1, steps_per_execution=2)
    m.predict(x)
    assert tr.events() == []


def test_batcher_spans_and_thread_name(tracer, tmp_path):
    """Two requests through the chunked batcher with the prefix cache: the
    submit handoffs resumed by each request's prefill, prefix-insert and
    (the second, sharing a page) prefix-install spans, decode iterations,
    all on the scheduler thread named by trace_label."""
    lm = build_tiny_lm(2, 12, vocab=50, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    prompt = np.arange(1, 10, dtype=np.int32)
    with ContinuousBatcher(lm, max_len=24, num_slots=2, page_size=4,
                           trace_label="smoke") as cb:
        with use_context(root_context()):
            first = cb.submit(prompt, 3)
        first.result(timeout=60)
        with use_context(root_context()):
            second = cb.submit(prompt, 3)
        second.result(timeout=60)
    assert cb.trace_label == "smoke"
    path = tracer.export_chrome_trace(str(tmp_path / "serve.json"))
    names = validate_trace(path)
    for name in ("serve.admit", "serve.prefill", "serve.decode",
                 "serve.prefix_insert", "serve.prefix_install"):
        assert name in names, name
    with open(path) as fh:
        data = json.load(fh)["traceEvents"]
    tid = {e["args"]["name"]: e["tid"] for e in data
           if e.get("ph") == "M" and e.get("name") == "thread_name"}
    sched = [e for e in data if e.get("ph") == "X"
             and e["name"].startswith("serve.")
             and e["name"] != "serve.admit"]
    assert sched and all(e["tid"] == tid["smoke"] for e in sched)
    # 9-token prompts in chunks of 4: three prefill chunks each
    for req in (first, second):
        mine = [e for e in sched if e["args"].get("request") == req.id]
        chunks = [e for e in mine if e["name"] == "serve.prefill"]
        assert len(chunks) == (3 if req is first else 1)
        # the submit handoff: each span of the request is in its trace
        trace_ids = {e["args"]["trace_id"] for e in mine}
        assert len(trace_ids) == 1
    flows = [e for e in data if e.get("ph") in ("s", "f")]
    assert sorted(e["ph"] for e in flows) == ["f", "f", "s", "s"]
    decode = [e for e in sched if e["name"] == "serve.decode"]
    assert decode and all(e["args"]["slots"] >= 1 for e in decode)


def test_batcher_default_trace_label_is_the_pool_label():
    lm = build_tiny_lm(2, 12, vocab=50, device="cpu")
    cb = ContinuousBatcher(lm, max_len=24, num_slots=2, page_size=4)
    assert cb.trace_label == cb.pool.label
