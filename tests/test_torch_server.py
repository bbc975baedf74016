"""The serving front end on the CPU (ROADMAP A5.10a, A5.10b): the port's
InferenceModel, DynamicBatcher, fold_batchnorm and InferenceServer held
against the JAX package's in the scenarios of tests/test_serving.py,
tests/test_continuous_batching.py and tests/test_obs.py, the port given
the JAX model's weights (`params_from_jax`) and both fed the same seeded
numpy inputs.

Tolerances (f32: the same math in another BLAS and summation order):
outputs 1e-5 absolute / 1e-4 relative against the JAX package; the port
against itself (padded against unpadded rows, batched against direct, a
request over HTTP against `predict`) 1e-6 / 1e-5; greedy tokens
identical; metric families equal by name, type and label names."""
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import flexflow_tpu as ff
import flexflow_tpu_torch as pt
from flexflow_tpu.obs import validate_exposition as jax_validate
from flexflow_tpu.serving import InferenceModel as JaxInferenceModel
from flexflow_tpu.serving import InferenceServer as JaxServer
from flexflow_tpu.serving.generate import GenerativeSession as JaxSession
from flexflow_tpu.serving.optimize import fold_batchnorm as jax_fold
from flexflow_tpu_torch.obs import validate_exposition
from flexflow_tpu_torch.serving import (BatcherStopped, ContinuousBatcher,
                                        DynamicBatcher, GenerativeSession,
                                        InferenceModel, InferenceServer,
                                        ModelMetrics, fold_batchnorm)
from flexflow_tpu_torch.serving.sched.bench import build_tiny_lm
from tests.conftest import module_xla_cache
from tests.test_generate import _build_lm
from tests.test_torch_zoo import one_torch_thread

_xla_cache = pytest.fixture(scope="module", autouse=True)(module_xla_cache)
_one_thread = pytest.fixture(scope="module", autouse=True)(one_torch_thread)

JAX_TOL = dict(rtol=1e-4, atol=1e-5)
SELF_TOL = dict(rtol=1e-5, atol=1e-6)


def _mlp(pkg, dim=8, classes=4):
    """The JAX serving tests' model (`make_model`) in either package."""
    if pkg is pt:
        config = pt.FFConfig(batch_size=16, allow_mixed_precision=False,
                             device="cpu", seed=9)
    else:
        config = ff.FFConfig()
        config.batch_size = 16
        config.allow_mixed_precision = False
        config.seed = 9
        config.num_devices = 1
    model = pkg.FFModel(config)
    t = model.dense(model.create_tensor([16, dim]), 16,
                    pkg.ActiMode.AC_MODE_RELU)
    model.softmax(model.dense(t, classes))
    model.compile(optimizer=pkg.SGDOptimizer(model, lr=0.0),
                  loss_type=pkg.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                  metrics=[])
    return model


@pytest.fixture(scope="module")
def mlps():
    jm = _mlp(ff)
    pm = _mlp(pt)
    pt.params_from_jax(pm, jm.params)
    return jm, pm


@pytest.fixture(scope="module")
def lms():
    """The JAX generate tests' LM (batch 2, window 12, vocab 50) in both
    packages, the port holding JAX's weights."""
    jm = _build_lm(2, 12)
    pm = build_tiny_lm(2, 12, vocab=50, device="cpu")
    pt.params_from_jax(pm, jm.params)
    return jm, pm


def _prompts(lens, seed=0, vocab=50):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, size=(n,)).astype(np.int32) for n in lens]


def _post(port, path, payload, raw=None):
    data = raw if raw is not None else json.dumps(payload).encode()
    return urllib.request.urlopen(urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data,
        headers={"Content-Type": "application/json"}))


def _http_error(port, path, payload=None, raw=None):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(port, path, payload, raw)
    return e.value


# ---------------------------------------------------------------------
# InferenceModel and DynamicBatcher (tests/test_serving.py:59-92, 207-213)
# ---------------------------------------------------------------------
def test_inference_model_pads_to_buckets_like_jax(mlps):
    jm, pm = mlps
    im = InferenceModel(pm, batch_buckets=(2, 8))
    ref = JaxInferenceModel(jm, batch_buckets=(2, 8))
    name = im.input_names[0]
    assert im.input_names == ref.input_names
    assert im.input_specs == ref.input_specs == {name: (8,)}
    assert [im._bucket_for(n) for n in (1, 2, 3, 8, 9)] == \
        [ref._bucket_for(n) for n in (1, 2, 3, 8, 9)]
    x = np.random.RandomState(0).randn(5, 8).astype(np.float32)
    out = im.predict({name: x})
    assert out.shape == (5, 4) and out.dtype == np.float32
    np.testing.assert_allclose(out, np.asarray(ref.predict({name: x})),
                               **JAX_TOL)
    # padding must not change the un-padded rows
    out8 = im.predict({name: np.concatenate(
        [x, np.zeros((3, 8), np.float32)])})
    np.testing.assert_allclose(out, out8[:5], **SELF_TOL)
    # batches over the largest bucket are chunked
    x16 = np.random.RandomState(1).randn(16, 8).astype(np.float32)
    got = im.predict({name: x16})
    np.testing.assert_allclose(got, np.asarray(ref.predict({name: x16})),
                               **JAX_TOL)
    # the inference walk: the same rows as FFModel.predict
    np.testing.assert_allclose(got, pm.predict(x16, batch_size=16),
                               **SELF_TOL)
    # one bucket object a bucket size, each call a walk (CPU: eager)
    assert sorted(im._fns) == [8]
    assert im.counts["eager_walks"] == 4
    with pytest.raises(KeyError, match="missing inputs"):
        im.predict({"nope": x})


def test_dynamic_batcher_matches_direct_and_coalesces(mlps):
    jm, pm = mlps
    im = InferenceModel(pm, batch_buckets=(1, 4, 16))
    name = im.input_names[0]
    rng = np.random.RandomState(0)
    reqs = [rng.randn(1, 8).astype(np.float32) for _ in range(12)]
    with DynamicBatcher(im, max_batch_size=16, max_delay_ms=20.0) as b:
        futs = [b.submit({name: r}) for r in reqs]
        outs = [f.result(timeout=30) for f in futs]
    got = np.concatenate(outs)
    np.testing.assert_allclose(got, im.predict({name: np.concatenate(reqs)}),
                               **SELF_TOL)
    ref = JaxInferenceModel(jm, batch_buckets=(1, 4, 16))
    np.testing.assert_allclose(
        got, np.asarray(ref.predict({name: np.concatenate(reqs)})),
        **JAX_TOL)


def test_batcher_propagates_errors(mlps):
    im = InferenceModel(mlps[1], batch_buckets=(4,))
    with DynamicBatcher(im, max_delay_ms=1.0) as b:
        fut = b.submit({"not_an_input": np.zeros((1, 8), np.float32)})
        with pytest.raises(KeyError):
            fut.result(timeout=30)


class _FakeModel:
    """Recording stand-in for InferenceModel (JAX's
    tests/test_continuous_batching.py:410)."""

    def __init__(self, dim=3):
        self.input_names = ["x"]
        self.input_specs = {"x": (dim,)}
        self.batches = []

    def predict(self, inputs):
        x = inputs["x"]
        self.batches.append(x.shape[0])
        return x * 2.0


def test_batcher_caps_coalescing_at_max_batch_size():
    fake = _FakeModel()
    reqs = [np.full((2, 3), i, np.float32) for i in range(3)]
    with DynamicBatcher(fake, max_batch_size=4, max_delay_ms=200.0) as b:
        futs = [b.submit({"x": r}) for r in reqs]
        outs = [f.result(timeout=30) for f in futs]
    for r, o in zip(reqs, outs):
        np.testing.assert_array_equal(o, r * 2.0)
    assert fake.batches and max(fake.batches) <= 4, fake.batches
    assert sum(fake.batches) == 6


def test_batcher_validates_at_submit_failing_only_offender():
    fake = _FakeModel()
    with DynamicBatcher(fake, max_batch_size=8, max_delay_ms=50.0) as b:
        bad_name = b.submit({"y": np.zeros((1, 3), np.float32)})
        bad_extra = b.submit({"x": np.zeros((1, 3), np.float32),
                              "y": np.zeros((1, 3), np.float32)})
        bad_shape = b.submit({"x": np.zeros((1, 4), np.float32)})
        bad_empty = b.submit({"x": np.zeros((0, 3), np.float32)})
        good = b.submit({"x": np.ones((1, 3), np.float32)})
        np.testing.assert_array_equal(good.result(timeout=30),
                                      np.full((1, 3), 2.0))
        with pytest.raises(KeyError, match="missing inputs"):
            bad_name.result(timeout=5)
        with pytest.raises(KeyError, match="unknown inputs"):
            bad_extra.result(timeout=5)
        with pytest.raises(ValueError, match="trailing shape"):
            bad_shape.result(timeout=5)
        with pytest.raises(ValueError, match="leading batch dim"):
            bad_empty.result(timeout=5)
    assert fake.batches == [1]


def test_batcher_stop_drains_pending_and_fails_later_submits():
    fake = _FakeModel()
    b = DynamicBatcher(fake, max_batch_size=4)
    futs = [b.submit({"x": np.zeros((1, 3), np.float32)})
            for _ in range(3)]  # never started: everything stays queued
    b.stop()
    for f in futs:
        with pytest.raises(BatcherStopped):
            f.result(timeout=5)
    with pytest.raises(BatcherStopped):
        b.submit({"x": np.zeros((1, 3), np.float32)}).result(timeout=5)
    # a start() revives it
    with b:
        np.testing.assert_array_equal(
            b.infer({"x": np.ones((1, 3), np.float32)}, timeout=30),
            np.full((1, 3), 2.0))
    # the continuous batcher's typed shutdown is the same class, as in JAX
    from flexflow_tpu_torch.serving.sched import BatcherStopped as sched_bs
    assert sched_bs is BatcherStopped


def test_batcher_submit_racing_stop_never_hangs():
    """Submitters racing stop(): every future resolves (a result or
    BatcherStopped), none hangs (JAX batcher.py:104-110)."""
    import sys

    fake = _FakeModel()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        b = DynamicBatcher(fake, max_batch_size=4, max_delay_ms=0.5)
        b.start()
        futs = []

        def client():
            for _ in range(50):
                futs.append(b.submit({"x": np.ones((1, 3), np.float32)}))

        threads = [threading.Thread(target=client) for _ in range(4)]
        for t in threads:
            t.start()
        b.stop()
        for t in threads:
            t.join(timeout=30)
        for f in futs:
            try:
                np.testing.assert_array_equal(f.result(timeout=10),
                                              np.full((1, 3), 2.0))
            except BatcherStopped:
                pass
    finally:
        sys.setswitchinterval(old)


def test_inference_model_on_a_cuda_mesh_walks_eagerly_and_says_why(
        monkeypatch):
    """On a mesh of CUDA ranks sharing a card (gloo, host-staged) a bucket
    is one eager walk of the model's collective predict: counted as an
    eager walk, never captured, with graph_capture's reason in stats()."""
    from types import SimpleNamespace

    from flexflow_tpu_torch.runtime import distributed

    monkeypatch.setattr(distributed, "_STATE", {"host_staging": True})
    calls = []

    def predict(padded, batch_size):
        calls.append((padded[0].shape, batch_size))
        return np.arange(batch_size * 2, dtype=np.float32).reshape(-1, 2)

    fake = SimpleNamespace(
        executor=object(), mesh=object(), device=torch.device("cuda", 0),
        outside_mesh=None, predict=predict,
        input_ops=[SimpleNamespace(name="x", outputs=[
            SimpleNamespace(dims=(8, 3))])])
    im = InferenceModel(fake, batch_buckets=(2, 8))
    out = im.predict({"x": np.ones((5, 3), np.float32)})
    assert out.shape == (5, 2) and calls == [((8, 3), 8)]
    st = im.stats()
    assert st["graphs"]["eager_walks"] == 1
    assert st["graphs"]["captures"] == st["graphs"]["replays"] == 0
    assert not st["graph_capture"] and "gloo" in st["reason"]
    with pytest.raises(RuntimeError, match="compiled"):
        InferenceModel(SimpleNamespace(executor=None, outside_mesh=None))


# ---------------------------------------------------------------------
# the server: HTTP, strict routes, metrics (tests/test_serving.py:94-236)
# ---------------------------------------------------------------------
def test_server_http_roundtrip_and_strict_routes(mlps):
    jm, pm = mlps
    server = InferenceServer()
    server.register("mlp", pm, batch_buckets=(1, 4))
    name = InferenceModel(pm).input_names[0]
    httpd = server.serve_http(port=0)
    try:
        port = httpd.server_address[1]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/v2/models") as r:
            assert json.load(r)["models"] == ["mlp"]
        x = np.random.RandomState(0).randn(2, 8).astype(np.float32)
        req = {"inputs": {name: x.tolist()}}
        with _post(port, "/v2/models/mlp/infer", req) as r:
            out = np.asarray(json.load(r)["outputs"], np.float32)
        np.testing.assert_allclose(out, InferenceModel(pm).predict({name: x}),
                                   **SELF_TOL)
        np.testing.assert_allclose(
            out, np.asarray(JaxInferenceModel(jm).predict({name: x})),
            **JAX_TOL)
        # unknown model -> 404 with the request id; /v2/<junk>/... -> 404
        e = _http_error(port, "/v2/models/nope/infer", raw=b"{}")
        assert e.code == 404 and json.load(e)["request_id"]
        for path in ("/v2/anything/mlp/infer", "/v2/anything/mlp/generate",
                     "/v2/models/mlp"):
            assert _http_error(port, path, req).code == 404, path
        with pytest.raises(urllib.error.HTTPError) as eget:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/v2/nope")
        assert eget.value.code == 404
        # stats over HTTP
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/v2/models/mlp/stats") as r:
            assert json.load(r)["requests"] == 1
        with pytest.raises(urllib.error.HTTPError) as e404:
            urllib.request.urlopen(
                f"http://127.0.0.1:{port}/v2/models/nope/stats")
        assert e404.value.code == 404
    finally:
        httpd.shutdown()
        server.shutdown()


def test_server_metrics_and_stats(mlps):
    server = InferenceServer()
    server.register("m", mlps[1], max_batch_size=8, max_delay_ms=0.5)
    try:
        x = np.random.RandomState(0).randn(3, 8).astype(np.float32)
        inp = {server._models["m"].model.input_names[0]: x}
        server.infer("m", inp, timeout=30.0)
        server.infer("m", inp, timeout=30.0)
        s = server.stats("m")
        assert s["requests"] == 2 and s["failures"] == 0
        assert s["avg_latency_ms"] > 0
        assert 'ff_inference_requests_total{model="m"} 2' \
            in server.prometheus_text()
        with pytest.raises(KeyError):
            server.infer("m", {"nope": x}, timeout=30.0)
        assert server.stats("m")["failures"] == 1
        with pytest.raises(KeyError, match="not registered"):
            server.infer("other", inp)
    finally:
        server.shutdown()


def test_server_generate_endpoint_matches_jax_session(lms):
    """POST /v2/models/<name>/generate over a lockstep session: tokens
    equal JAX's GenerativeSession's (tests/test_serving.py:94-168)."""
    jm, pm = lms
    b, window, n_new = 2, 12, 5
    prompt = np.random.RandomState(1).randint(1, 50, size=(b, 4)).astype(
        np.int32)
    ref = JaxSession(jm, max_len=window).generate(prompt, n_new)
    server = InferenceServer()
    server.register_generative("lm", GenerativeSession(pm, max_len=window),
                               tokens_per_dispatch=3)
    httpd = server.serve_http(port=0)
    try:
        port = httpd.server_address[1]
        with _post(port, "/v2/models/lm/generate",
                   {"prompt": prompt.tolist(), "max_new_tokens": n_new}) as r:
            toks = np.asarray(json.load(r)["tokens"], np.int32)
        np.testing.assert_array_equal(toks, ref)
        assert server.stats("lm")["requests"] == 1
        with _post(port, "/v2/models/lm/generate",
                   {"prompt": prompt[:1].tolist(),
                    "max_new_tokens": n_new}) as r:
            np.testing.assert_array_equal(json.load(r)["tokens"], ref[:1])
        assert _http_error(port, "/v2/models/nope/generate",
                           raw=b"{}").code == 404
        assert _http_error(port, "/v2/models/lm/generate",
                           raw=b"{}").code == 400
        for bad in ([1, 2, 3], [[1, 2]] * 5):
            e = _http_error(port, "/v2/models/lm/generate", {"prompt": bad})
            assert e.code == 400, bad
            assert json.load(e)["request_id"]
    finally:
        httpd.shutdown()
        server.shutdown()


def test_register_generative_validates_policy(lms):
    server = InferenceServer()
    session = GenerativeSession(lms[1], max_len=12)
    with pytest.raises(ValueError, match="top_k"):
        server.register_generative("lm", session, top_k=0)
    with pytest.raises(ValueError, match="temperature"):
        server.register_generative("lm", session, temperature=-1.0)


# ---------------------------------------------------------------------
# continuous /generate (tests/test_continuous_batching.py:319-410)
# ---------------------------------------------------------------------
def test_server_continuous_generate_and_stream(lms):
    jm, pm = lms
    prompts = _prompts([4, 6], seed=6)
    session = JaxSession(jm, max_len=12)
    refs = [session.generate(p[None, :], 5)[0] for p in prompts]
    server = InferenceServer()
    server.register_continuous(
        "clm", ContinuousBatcher(pm, max_len=12, num_slots=2, page_size=4))
    httpd = server.serve_http(port=0)
    try:
        port = httpd.server_address[1]
        path = "/v2/models/clm/generate"
        with _post(port, path, {"prompt": [p.tolist() for p in prompts],
                                "max_new_tokens": 5}) as r:
            toks = json.load(r)["tokens"]
        for row, ref in zip(toks, refs):
            np.testing.assert_array_equal(row, np.asarray(ref))
        with _post(port, path, {"prompt": prompts[0].tolist(),
                                "max_new_tokens": 5, "stream": True}) as r:
            assert r.headers["Content-Type"] == "application/x-ndjson"
            lines = [json.loads(ln) for ln in r.read().splitlines()]
        assert [ln["token"] for ln in lines[:-1]] == list(refs[0])
        assert lines[-1]["done"] is True
        assert lines[-1]["tokens"] == list(refs[0])
        assert lines[-1]["request_id"] and "cache_hit" in lines[-1]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz") as r:
            assert json.load(r)["continuous"] == ["clm"]
        assert server.stats()["_continuous"]["clm"]["completed"] >= 3
        e = _http_error(port, path, {"prompt": list(range(1, 14)),
                                     "max_new_tokens": 2})
        assert e.code == 400
        assert json.load(e)["reason"] == "too_large"
        text = server.prometheus_text()
        validate_exposition(text)
        jax_validate(text)
        for fam in ("ff_kvpool_pages_used", "ff_serving_slots_active",
                    "ff_serving_ttft_ms", "ff_serving_queue_depth"):
            assert fam in text, fam
    finally:
        httpd.shutdown()
        server.shutdown()


def test_server_continuous_backpressure_429(lms):
    server = InferenceServer()
    cb = ContinuousBatcher(lms[1], max_len=12, num_slots=1, page_size=4,
                           max_queue=1)
    server.register_continuous("clm", cb, start=False)
    cb._running = True  # accept submits without running the scheduler
    blocker = cb.submit(_prompts([4], seed=7)[0], 4)  # fills max_queue=1
    httpd = server.serve_http(port=0)
    try:
        port = httpd.server_address[1]
        e = _http_error(port, "/v2/models/clm/generate",
                        {"prompt": [1, 2, 3], "max_new_tokens": 2})
        assert e.code == 429
        body = json.load(e)
        assert body["reason"] == "queue_full" and body["request_id"]
    finally:
        httpd.shutdown()
        cb._running = False
        server.shutdown()
        with pytest.raises(BatcherStopped):
            blocker.result(timeout=10)


def test_register_modes_exclusive_and_fleet_absent(lms):
    server = InferenceServer()
    try:
        server.register_generative("lm", GenerativeSession(lms[1],
                                                           max_len=12))
        with pytest.raises(ValueError, match="one serving mode"):
            server.register_continuous(
                "lm", ContinuousBatcher(lms[1], max_len=12, num_slots=1),
                start=False)
        server.register_continuous(
            "c", ContinuousBatcher(lms[1], max_len=12, num_slots=1),
            start=False)
        with pytest.raises(ValueError, match="one serving mode"):
            server.register_generative(
                "c", GenerativeSession(lms[1], max_len=12))
        with pytest.raises(NotImplementedError, match="A10"):
            server.register_fleet("f", object())
        # the plan analysis' counters, as the JAX server carries them:
        # the family on /metrics (compile records every report), and the
        # per-code counts under "_analysis" once there are any
        from flexflow_tpu_torch.analysis import diagnostic_counters

        assert server.stats().get("_analysis", {}) == diagnostic_counters()
        assert "ff_plan_diagnostics_total" in server.prometheus_text()
    finally:
        server.shutdown()


# ---------------------------------------------------------------------
# fold_batchnorm (tests/test_serving.py:444-490)
# ---------------------------------------------------------------------
def _bn_net(pkg, use_bias):
    if pkg is pt:
        config = pt.FFConfig(batch_size=8, allow_mixed_precision=False,
                             device="cpu")
    else:
        config = ff.FFConfig()
        config.batch_size = 8
        config.allow_mixed_precision = False
        config.num_devices = 1
    model = pkg.FFModel(config)
    x = model.create_tensor([8, 3, 8, 8])
    t = model.conv2d(x, 6, 3, 3, 1, 1, 1, 1, use_bias=use_bias, name="conv")
    t = model.batch_norm(t, relu=True, name="bn")
    t = model.flat(t)
    model.softmax(model.dense(t, 4, name="cls"))
    model.compile(optimizer=pkg.SGDOptimizer(model, lr=0.05),
                  loss_type=pkg.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                  metrics=[])
    return model


@pytest.mark.parametrize("use_bias", [True, False])
def test_fold_batchnorm_matches_jax_and_refuses_training(use_bias):
    """After two fit epochs (running statistics not their initial values)
    the port, given JAX's weights and state, folds the same BN, predicts
    JAX's folded values, refuses to train, and serves the folded graph; a
    bucket captured before the fold is never used after it."""
    rng = np.random.RandomState(0)
    X = rng.randn(32, 3, 8, 8).astype(np.float32)
    Y = rng.randint(0, 4, size=(32, 1)).astype(np.int32)
    jm = _bn_net(ff, use_bias)
    jm.fit(x=X, y=Y, epochs=2, verbose=False)
    pm = _bn_net(pt, use_bias)
    pt.params_from_jax(pm, jm.params)
    pm.load_state(jm.state)

    before = pm.predict(X[:8])
    np.testing.assert_allclose(before, np.asarray(jm.predict(X[:8])),
                               **JAX_TOL)
    im = InferenceModel(pm, batch_buckets=(8,))
    np.testing.assert_allclose(im.predict({"input_0": X[:8]}), before,
                               **SELF_TOL)
    old_bucket = im._fns[8]

    assert fold_batchnorm(pm) == jax_fold(jm) == ["bn"]
    assert all(op.name != "bn" for op in pm.ops)
    assert "bn" not in pm.state and "bn" not in pm.params
    assert sorted(pm.params["conv"]) == ["bias", "kernel"]
    assert pm.get_layer_by_name("conv").params["activation"] == \
        pt.ActiMode.AC_MODE_RELU
    for w in ("kernel", "bias"):
        np.testing.assert_allclose(pm.get_parameter_by_id("conv", w),
                                   np.asarray(jm.params["conv"][w]),
                                   rtol=1e-6, atol=1e-7)
    after = pm.predict(X[:8])
    np.testing.assert_allclose(after, before, **JAX_TOL)
    np.testing.assert_allclose(after, np.asarray(jm.predict(X[:8])),
                               **JAX_TOL)
    # the InferenceModel drops the bucket walked over the unfolded graph
    out = im.predict({"input_0": X[:8]})
    assert im._fns[8] is not old_bucket and im._walk[0] is pm.executor
    np.testing.assert_allclose(out, after, **SELF_TOL)
    # eval works post-fold; training refuses with a clear error
    assert np.isfinite(pm.eval(x=X[:8], y=Y[:8])["loss"])
    with pytest.raises(RuntimeError, match="optimized for inference"):
        pm.fit(x=X, y=Y, epochs=1)
    pm.set_iteration_batch([X[:8]], Y[:8])
    for manual in (pm.backward, pm.update):
        with pytest.raises(RuntimeError, match="optimized for inference"):
            manual()
    # a second fold finds nothing; the folded model serves
    assert fold_batchnorm(pm) == []
    server = InferenceServer()
    try:
        server.register("folded", pm, max_batch_size=8, batch_buckets=[8])
        got = server.infer("folded", {pm.input_ops[0].name: X[:8]},
                           timeout=30.0)
        np.testing.assert_allclose(got, before, **JAX_TOL)
    finally:
        server.shutdown()


def test_fold_batchnorm_leaves_unfoldable_bns():
    """A BN after a non-conv, or after a conv with another consumer or an
    activation, stays (JAX optimize.py's three checks)."""
    def build(pkg):
        m = pkg.FFModel(pt.FFConfig(batch_size=2, device="cpu",
                                    allow_mixed_precision=False))
        x = m.create_tensor([2, 3, 6, 6])
        a = m.conv2d(x, 4, 3, 3, 1, 1, 1, 1, name="shared")
        b1 = m.batch_norm(a, name="bn_shared")
        c = m.conv2d(x, 4, 3, 3, 1, 1, 1, 1,
                     activation=pkg.ActiMode.AC_MODE_RELU, name="acted")
        b2 = m.batch_norm(c, name="bn_acted")
        b3 = m.batch_norm(m.add(b1, a), name="bn_add")
        m.softmax(m.dense(m.flat(m.add(b2, b3)), 3))
        m.compile(optimizer=pkg.SGDOptimizer(m, lr=0.0))
        return m

    m = build(pt)
    n_ops = len(m.ops)
    assert fold_batchnorm(m) == []
    assert len(m.ops) == n_ops and m._inference_only is None


# ---------------------------------------------------------------------
# the /metrics door (tests/test_obs.py:404-425, 619-740)
# ---------------------------------------------------------------------
def test_traceparent_request_scope_parsing():
    from flexflow_tpu_torch.obs.tracing import get_tracer
    from flexflow_tpu_torch.serving.server import (_format_traceparent,
                                                   _request_scope)

    caller_trace, caller_span = "ab" * 16, "cd" * 8
    ctx, rid = _request_scope({
        "traceparent": f"00-{caller_trace}-{caller_span}-01",
        "X-Request-Id": "req-42"})
    assert rid == "req-42"
    assert ctx.trace_id == caller_trace and ctx.parent_id == caller_span
    assert _format_traceparent(ctx) \
        == f"00-{caller_trace}-{ctx.span_id}-01"
    assert not get_tracer().enabled
    ctx2, rid2 = _request_scope({"traceparent": "00-nope-bad-ff"})
    assert ctx2 is None and len(rid2) == 16
    get_tracer().enable()
    try:
        ctx3, _ = _request_scope({})
        assert ctx3 is not None and ctx3.parent_id is None
    finally:
        get_tracer().disable()


def test_server_metrics_render_validates_and_keeps_names():
    from flexflow_tpu_torch.elastic.events import EventLog
    from flexflow_tpu_torch.obs import REGISTRY
    from flexflow_tpu_torch.runtime.durability import _bump

    server = InferenceServer()
    try:
        server.record_load_failure("broken", RuntimeError("nope"))
        _bump("saved")
        REGISTRY.counter("ff_watchdog_skips_total",
                         "Training watchdog events: skips").inc()
        ev = EventLog()
        ev.record("retry", step=1)
        server.attach_elastic_events(ev)
        # the plan analysis' family, which every compile feeds
        from flexflow_tpu_torch.analysis import diagnostic_counters

        diagnostic_counters()
        text = server.prometheus_text()
        fams = validate_exposition(text)
        assert jax_validate(text).keys() == fams.keys()
        for name in ("ff_inference_requests_total",
                     "ff_inference_failures_total",
                     "ff_inference_avg_latency_ms",
                     "ff_model_load_failures_total",
                     "ff_checkpoint_saved_total",
                     "ff_watchdog_skips_total",
                     "ff_elastic_events_total"):
            assert name in fams, name
        assert "ff_plan_diagnostics_total" in fams
        assert 'ff_model_load_failures_total{model="broken"} 1' in text
        (_, ev_lbl, ev_n), = fams["ff_elastic_events_total"]["samples"]
        assert ev_lbl == {"kind": "retry"} and ev_n == 1
        stats = server.stats()
        assert stats["_elastic"] == {"retry": 1}
        assert "broken" in stats["_load_failures"]
        assert stats["_checkpoint"]["saved"] >= 1
        assert stats["_watchdog"]["skips"] >= 1
    finally:
        server.shutdown()


def _family_shapes(text):
    """{family: (type, sorted label-name sets)} as JAX's checker reads
    the text."""
    return {name: (f["type"], sorted({tuple(sorted(lbl))
                                      for _, lbl, _ in f["samples"]}))
            for name, f in jax_validate(text).items()}


def test_server_families_match_jax(mlps):
    """Both servers' own registries, after the same calls, expose the same
    families with the same types and label names."""
    jm, pm = mlps
    x = np.random.RandomState(0).randn(3, 8).astype(np.float32)
    texts = []
    for server, model in ((JaxServer(), jm), (InferenceServer(), pm)):
        try:
            server.register("m", model, max_batch_size=8, max_delay_ms=0.5,
                            batch_buckets=(4,))
            name = model.input_ops[0].name
            server.infer("m", {name: x}, timeout=30.0)
            server.infer("m", {name: x}, timeout=30.0)
            with pytest.raises(KeyError):
                server.infer("m", {"nope": x}, timeout=30.0)
            server.record_load_failure("broken", RuntimeError("nope"))
            server.prometheus_text()  # syncs the avg gauge
            texts.append(server.registry.render())
            assert server.stats("m")["requests"] == 3
        finally:
            server.shutdown()
    assert _family_shapes(texts[1]) == _family_shapes(texts[0])


def test_reregistered_model_metrics_start_from_zero():
    server = InferenceServer()
    try:
        m1 = ModelMetrics(server.registry, "m")
        server._metrics["m"] = m1
        m1.record(50.0, ok=True)
        m1.record(10.0, ok=True)
        assert m1.stats()["requests"] == 2
        assert m1.stats()["max_latency_ms"] == 50.0
        server.unregister("m")
        assert 'model="m"' not in server.prometheus_text()
        m2 = ModelMetrics(server.registry, "m")
        assert m2.stats() == {"requests": 0, "failures": 0,
                              "avg_latency_ms": 0.0, "max_latency_ms": 0.0}
        assert 'ff_inference_requests_total{model="m"} 0' \
            in server.prometheus_text()
    finally:
        server.shutdown()


def test_generate_metrics_survive_repeat_requests():
    server = InferenceServer()
    try:
        m = server._metrics_for("g")
        m.record(1.0, ok=True)
        assert server._metrics_for("g") is m
        server._metrics_for("g").record(2.0, ok=True)
        assert server.stats("g")["requests"] == 2
    finally:
        server.shutdown()


def test_two_servers_do_not_share_per_model_series():
    a, b = InferenceServer(), InferenceServer()
    try:
        a.record_load_failure("m", RuntimeError("x"))
        assert 'ff_model_load_failures_total{model="m"} 1' \
            in a.prometheus_text()
        assert 'ff_model_load_failures_total{model="m"}' \
            not in b.prometheus_text()
    finally:
        a.shutdown()
        b.shutdown()


def test_healthz_endpoint():
    server = InferenceServer()
    httpd = server.serve_http(port=0)
    try:
        port = httpd.server_address[1]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz") as r:
            body = json.loads(r.read())
        assert r.status == 200
        assert body["status"] == "ok"
        assert body["models"] == [] and body["uptime_s"] >= 0
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics") as r:
            validate_exposition(r.read().decode())
        server.record_load_failure("broken", RuntimeError("x"))
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz") as r:
            body = json.loads(r.read())
        assert body["status"] == "degraded"
        assert body["load_failures"] == ["broken"]
    finally:
        httpd.shutdown()
        server.shutdown()


def test_exposition_parser_matches_jax():
    """The copied parser reads every family the way JAX's does, exemplars
    and escaped label values included, and refuses what JAX's refuses."""
    from flexflow_tpu.obs import parse_exposition as jax_parse
    from flexflow_tpu_torch.obs import MetricsRegistry, iter_samples, \
        parse_exposition

    reg = MetricsRegistry()
    reg.counter("ff_c_total", "a\nb", labels=("k",)).inc(3, k='q"\\\nx')
    reg.gauge("ff_g", "g").set(-1.5)
    reg.histogram("ff_e_ms", "h", buckets=(1.0, 10.0)).observe(
        5.0, exemplar="abc123")
    text = reg.render()
    assert parse_exposition(text) == jax_parse(text)
    assert list(iter_samples(text)) == [
        s for f in jax_parse(text).values() for s in f["samples"]]
    for bad in ("ff_x{", "# TYPE ff_x nope", "ff_x 1\n# TYPE ff_x gauge\n"
                "# TYPE ff_x gauge"):
        with pytest.raises(ValueError):
            parse_exposition(bad)
    with pytest.raises(ValueError, match="TYPE"):
        validate_exposition("ff_untyped 1\n")
    with pytest.raises(ValueError, match="_sum/_count"):
        validate_exposition("# TYPE ff_h histogram\nff_h_bucket{le=\"1\"} 1\n")
