"""The model repository of flexflow_tpu_torch on the CPU (ROADMAP A5.10c):
the repository cases of tests/test_serving.py, test_fleet.py,
test_disagg.py and test_spec_decode.py through the port's
ModelRepository on the port's InferenceServer, and the port held against
the JAX package:
 - one directory loaded by both packages' ModelRepository serves the
   same outputs, a checkpoint written by JAX's `save_checkpoint`
   restored into the port's entry: f32 entries within 1e-5, bf16 entries
   (the repository's default precision) within BF16_TOL;
 - a fleet entry's and a disaggregated entry's greedy tokens equal the
   JAX ContinuousBatcher's on JAX's test LM, its weights carried across
   by `params_from_jax` (identical).
Waits poll a condition with a short sleep between reads, never a fixed
delay. Inputs come from seeded numpy generators."""
import json
import os
import time

import numpy as np
import pytest

import flexflow_tpu as jff
import flexflow_tpu_torch as ff
from flexflow_tpu.runtime.checkpoint import \
    save_checkpoint as jax_save_checkpoint
from flexflow_tpu.serving import InferenceServer as JaxServer
from flexflow_tpu.serving import ModelRepository as JaxRepository
from flexflow_tpu.serving.sched import ContinuousBatcher as JaxBatcher
from flexflow_tpu_torch import params_from_jax
from flexflow_tpu_torch.native.c_model import model_from_spec
from flexflow_tpu_torch.onnx import wire
from flexflow_tpu_torch.runtime.checkpoint import save_checkpoint
from flexflow_tpu_torch.serving import InferenceServer, ModelRepository
from flexflow_tpu_torch.serving.sched.bench import build_tiny_lm
from tests.conftest import module_xla_cache
from tests.test_generate import _build_lm
from tests.test_torch_zoo import one_torch_thread

_xla_cache = pytest.fixture(scope="module", autouse=True)(module_xla_cache)
_one_thread = pytest.fixture(scope="module", autouse=True)(one_torch_thread)

SPEC_PATH = os.path.join(os.path.dirname(__file__), "..", "examples",
                         "machines", "multipod_2x8.json")
# f32 through another BLAS order
F32_TOL = dict(atol=1e-5, rtol=1e-5)
# bf16 activations at op boundaries: a few bf16 ulps (2^-8 relative)
# where the two packages round a product or a sum differently
BF16_TOL = dict(atol=4e-3, rtol=2e-2)
MAX_LEN = 48


def _spec(hidden=12, out=3, batch=8):
    """tests/test_serving.py's C-model spec: x (batch, 6) -> dense relu
    -> dense -> softmax."""
    return {
        "format": "flexflow_tpu_c_model",
        "config": {"batch_size": batch},
        "ops": [
            {"type": "input", "name": "x", "dims": [batch, 6],
             "dtype": "float32", "inputs": [], "outputs": [1]},
            {"type": "dense", "name": "fc1", "inputs": [1], "outputs": [2],
             "params": {"out_dim": hidden, "activation": "relu"}},
            {"type": "dense", "name": "fc2", "inputs": [2], "outputs": [3],
             "params": {"out_dim": out}},
            {"type": "softmax", "name": "sm", "inputs": [3], "outputs": [4],
             "params": {}},
        ],
    }


def _write_mlp_onnx(mdir, rng, mixed_precision=False):
    w1 = rng.randn(6, 12).astype(np.float32)
    w2 = rng.randn(12, 3).astype(np.float32)
    nodes = [
        wire.make_node("MatMul", ["x", "w1"], ["h"], name="fc1"),
        wire.make_node("Relu", ["h"], ["hr"], name="relu1"),
        wire.make_node("MatMul", ["hr", "w2"], ["y"], name="fc2"),
    ]
    proto = wire.make_model(nodes, {"x": (8, 6)}, {"y": (8, 3)},
                            {"w1": w1, "w2": w2}, name="mlp")
    mdir.mkdir()
    wire.save(proto, str(mdir / "model.onnx"))
    (mdir / "config.json").write_text(json.dumps({
        "format": "onnx", "file": "model.onnx",
        "inputs": [{"dims": [8, 6], "dtype": "float32"}],
        "max_batch_size": 8, "batch_buckets": [1, 4, 8],
        "mixed_precision": mixed_precision,
    }))
    return w1, w2


def _wait_for(cond, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline
        time.sleep(0.005)


def _cpu_repo(path):
    return ModelRepository(str(path), device="cpu")


# ---------------------------------------------------------------------
# tests/test_serving.py's repository cases
# ---------------------------------------------------------------------
def test_model_repository_loads_and_serves(tmp_path):
    rng = np.random.RandomState(0)
    w1, w2 = _write_mlp_onnx(tmp_path / "mlp", rng)
    repo = _cpu_repo(tmp_path)
    assert repo.model_names() == ["mlp"]
    server = InferenceServer()
    try:
        assert repo.load(server) == ["mlp"]
        x = rng.randn(2, 6).astype(np.float32)
        out = np.asarray(server.infer(
            "mlp", {server._models["mlp"].model.input_names[0]: x},
            timeout=30.0))
        ref = np.maximum(x @ w1, 0.0) @ w2
        np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)
        repo.unload(server, "mlp")
        assert server.models() == []
    finally:
        server.shutdown()


def test_model_repository_cspec_format(tmp_path):
    mdir = tmp_path / "cmodel"
    mdir.mkdir()
    (mdir / "model_spec.json").write_text(json.dumps(_spec()))
    (mdir / "config.json").write_text(json.dumps({
        "format": "ff_cspec", "file": "model_spec.json",
        "max_batch_size": 8, "batch_buckets": [1, 8],
    }))
    repo = _cpu_repo(tmp_path)
    server = InferenceServer()
    try:
        assert repo.load(server) == ["cmodel"]
        x = np.random.RandomState(0).randn(2, 6).astype(np.float32)
        out = np.asarray(server.infer(
            "cmodel", {server._models["cmodel"].model.input_names[0]: x},
            timeout=30.0))
        assert out.shape == (2, 3)
        # repository models serve with mixed precision on (bf16 rounding)
        np.testing.assert_allclose(out.sum(axis=-1), 1.0, atol=1e-2)
        assert server.stats("cmodel")["requests"] == 1
    finally:
        server.shutdown()


def test_model_repository_checkpoint_restore(tmp_path):
    """A model trained from the same spec, checkpointed by the port: the
    repository entry serves the TRAINED predictions (within 2e-2, JAX's
    tolerance for the bf16 entry)."""
    spec = _spec()
    trained = model_from_spec(json.dumps(spec), config=ff.FFConfig(
        allow_mixed_precision=False, device="cpu"))
    trained.compile(
        optimizer=ff.SGDOptimizer(trained, lr=0.1),
        loss_type=ff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
        metrics=[])
    rng = np.random.RandomState(0)
    X = rng.randn(64, 6).astype(np.float32)
    Y = rng.randint(0, 3, size=(64, 1)).astype(np.int32)
    trained.fit(x=X, y=Y, epochs=3, verbose=False)
    expected = np.asarray(trained.predict(X[:8]), np.float32)

    mdir = tmp_path / "cmodel"
    mdir.mkdir()
    (mdir / "model_spec.json").write_text(json.dumps(spec))
    save_checkpoint(str(mdir / "weights"), trained)
    (mdir / "config.json").write_text(json.dumps({
        "format": "ff_cspec", "file": "model_spec.json",
        "checkpoint": "weights.npz", "max_batch_size": 8,
    }))
    repo = _cpu_repo(tmp_path)
    server = InferenceServer()
    try:
        repo.load(server)
        out = np.asarray(server.infer("cmodel", {"x": X[:8]}, timeout=30.0),
                         np.float32)
        np.testing.assert_allclose(out, expected, atol=2e-2, rtol=2e-2)
    finally:
        server.shutdown()


def test_model_repository_isolates_failed_models(tmp_path):
    spec = {
        "format": "flexflow_tpu_c_model",
        "config": {"batch_size": 8},
        "ops": [
            {"type": "input", "name": "x", "dims": [8, 6],
             "dtype": "float32", "inputs": [], "outputs": [1]},
            {"type": "dense", "name": "fc", "inputs": [1], "outputs": [2],
             "params": {"out_dim": 3}},
            {"type": "softmax", "name": "sm", "inputs": [2],
             "outputs": [3], "params": {}},
        ],
    }
    good = tmp_path / "good"
    good.mkdir()
    (good / "model_spec.json").write_text(json.dumps(spec))
    (good / "config.json").write_text(json.dumps(
        {"format": "ff_cspec", "file": "model_spec.json"}))
    missing = tmp_path / "missing_artifact"
    missing.mkdir()
    (missing / "config.json").write_text(json.dumps(
        {"format": "ff_cspec", "file": "nope.json"}))
    badckpt = tmp_path / "bad_ckpt"
    badckpt.mkdir()
    (badckpt / "model_spec.json").write_text(json.dumps(spec))
    np.savez(str(badckpt / "weights.npz"), w=np.ones(3, np.float32))
    (badckpt / "config.json").write_text(json.dumps(
        {"format": "ff_cspec", "file": "model_spec.json",
         "checkpoint": "weights.npz"}))

    repo = _cpu_repo(tmp_path)
    server = InferenceServer()
    try:
        loaded = repo.load(server)
        assert loaded == ["good"]
        assert server.models() == ["good"]
        out = server.infer("good", {"x": np.ones((8, 6), np.float32)},
                           timeout=30.0)
        assert np.asarray(out).shape == (8, 3)
        failures = server.stats()["_load_failures"]
        assert set(failures) == {"bad_ckpt", "missing_artifact"}
        assert "CheckpointError" in failures["bad_ckpt"]
        text = server.prometheus_text()
        assert 'ff_model_load_failures_total{model="bad_ckpt"} 1' in text
        with pytest.raises(Exception):
            repo.load(InferenceServer(), strict=True)
    finally:
        server.shutdown()


def test_batch_buckets_default_and_clamp_to_the_built_batch(tmp_path):
    """Default buckets (1, 4, ...) end at the built batch; an explicit
    max_batch_size or bucket past it is clamped to it."""
    for name, extra in (("dflt", {}),
                        ("big", {"max_batch_size": 64,
                                 "batch_buckets": [2, 32]})):
        mdir = tmp_path / name
        mdir.mkdir()
        (mdir / "model_spec.json").write_text(json.dumps(_spec(batch=8)))
        (mdir / "config.json").write_text(json.dumps(
            dict({"format": "ff_cspec", "file": "model_spec.json"},
                 **extra)))
    server = InferenceServer()
    try:
        assert _cpu_repo(tmp_path).load(server) == ["big", "dflt"]
        assert tuple(server._models["dflt"].model.buckets) == (1, 4, 8)
        assert tuple(server._models["big"].model.buckets) == (2, 8)
        assert server._models["big"].max_batch_size == 8
    finally:
        server.shutdown()


def test_fleet_entry_config_errors_are_load_failures(tmp_path):
    """A fleet entry without max_len, and a speculative one without its
    draft's name, are recorded as load failures; the scan goes on."""
    for name, serving in (("no_max_len", {"mode": "fleet"}),
                          ("no_draft", {"mode": "fleet", "max_len": 32,
                                        "speculative": {"tokens": 2}}),
                          ("disagg_no_max_len", {"mode": "disagg"})):
        mdir = tmp_path / name
        mdir.mkdir()
        (mdir / "model_spec.json").write_text(json.dumps(_spec()))
        (mdir / "config.json").write_text(json.dumps(
            {"format": "ff_cspec", "file": "model_spec.json",
             "serving": serving}))
    server = InferenceServer()
    try:
        assert _cpu_repo(tmp_path).load(server) == []
        failures = server.stats()["_load_failures"]
        assert "max_len" in failures["no_max_len"]
        assert "draft" in failures["no_draft"]
        assert "max_len" in failures["disagg_no_max_len"]
    finally:
        server.shutdown()


# ---------------------------------------------------------------------
# the fleet, disaggregated and speculative entries (test_fleet.py,
# test_disagg.py, test_spec_decode.py)
# ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def lms():
    """JAX's test LM (batch 2, window 12, vocab 50) and the port's copy
    of it holding JAX's weights."""
    jm = _build_lm(2, 12)
    pm = build_tiny_lm(2, 12, vocab=50, device="cpu")
    params_from_jax(pm, jm.params)
    return jm, pm


@pytest.fixture(scope="module")
def lm(lms):
    return lms[1]


def _prompts(lens, seed=0, vocab=50):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, size=(n,)).astype(np.int32) for n in lens]


def _jax_tokens(jm, prompts, max_new):
    b = JaxBatcher(jm, max_len=MAX_LEN, num_slots=2, page_size=4,
                   max_queue=32)
    with b:
        return [list(map(int, b.submit(p, max_new).result(timeout=300)))
                for p in prompts]


def test_repository_fleet_entry_registers_router(lm):
    server = InferenceServer()
    try:
        ModelRepository._register_fleet(
            server, "lm", lm,
            {"mode": "fleet", "replicas": 2, "max_len": MAX_LEN,
             "num_slots": 2, "page_size": 4, "slo_ttft_ms": 60000.0})
        router = server._fleets["lm"]
        assert router.replica_names() == ["r0", "r1"]
        assert router.slo_ttft_s == 60.0
        out = server.generate("lm", [[1, 2, 3]], 2)
        assert [len(t) for t in out] == [2]
        with pytest.raises(ValueError, match="serving mode"):
            server.register_fleet("lm2", router) or \
                server.register_continuous("lm", object())
    finally:
        server.shutdown()


def test_repository_disagg_entry(lm, tmp_path):
    server = InferenceServer()
    try:
        ModelRepository._register_disagg(
            server, "lm", lm,
            {"mode": "disagg", "max_len": MAX_LEN, "num_slots": 2,
             "page_size": 4, "prefill_replicas": 1, "decode_replicas": 1,
             "machine_spec": os.path.abspath(SPEC_PATH)},
            model_dir=str(tmp_path))
        router = server._fleets["lm"]
        assert set(router.replica_names()) == {"prefill0", "decode0"}
        assert router.replica("prefill0").role == "prefill"
        assert router.replica("decode0").role == "decode"
        assert router.disagg is not None  # shutdown() drains it first
        out = server.generate("lm", [[1, 2, 3, 4, 5, 6]], 3)
        assert [len(t) for t in out] == [3]
        _wait_for(lambda: router.disagg.committed >= 1)
        assert (router.disagg.last_predicted_us or 0.0) > 0.0
        with pytest.raises(ValueError, match="speculative"):
            ModelRepository._register_disagg(
                server, "lm2", lm,
                {"mode": "disagg", "max_len": MAX_LEN,
                 "speculative": {"draft": "d", "tokens": 2}},
                model_dir=str(tmp_path))
        with pytest.raises(ValueError, match="max_len"):
            ModelRepository._register_disagg(
                server, "lm3", lm, {"mode": "disagg"},
                model_dir=str(tmp_path))
    finally:
        server.shutdown()


def test_repository_speculative_entry(lms):
    """A fleet entry with serving.speculative wires the draft into every
    replica's batcher (draft shared, per-replica draft caches): the
    target's own weights as the draft, so every draft token is taken."""
    jm, lm = lms
    draft = build_tiny_lm(2, 12, vocab=50, device="cpu")
    params_from_jax(draft, jm.params)
    server = InferenceServer()
    try:
        ModelRepository._register_fleet(
            server, "lm", lm,
            {"mode": "fleet", "replicas": 2, "max_len": MAX_LEN,
             "num_slots": 2, "page_size": 4,
             "speculative": {"draft": "lm_draft", "tokens": 2}},
            draft=draft)
        router = server._fleets["lm"]
        assert router.replica_names() == ["r0", "r1"]
        for name in router.replica_names():
            batcher = router._replicas[name].batcher
            assert batcher.draft_model is draft
            assert batcher.spec_tokens == 2
        out = server.generate("lm", [[1, 2, 3]], 4)
        assert [len(t) for t in out] == [4]
    finally:
        server.shutdown()


def test_fleet_and_disagg_entries_tokens_equal_jax_batcher(lms, tmp_path):
    """Greedy tokens through the repository's fleet entry (two affine
    replicas) and its disaggregated entry (a priced handoff) equal the
    JAX ContinuousBatcher's on the same prompts, identical."""
    jm, lm = lms
    prompts = _prompts((5, 9, 14, 7), seed=3)
    want = _jax_tokens(jm, prompts, 6)
    server = InferenceServer()
    try:
        ModelRepository._register_fleet(
            server, "fleet", lm, {"mode": "fleet", "replicas": 2,
                                  "max_len": MAX_LEN, "num_slots": 2,
                                  "page_size": 4})
        ModelRepository._register_disagg(
            server, "disagg", lm,
            {"mode": "disagg", "max_len": MAX_LEN, "num_slots": 2,
             "page_size": 4, "machine_spec": "spec.json"},
            model_dir=_spec_dir(tmp_path))
        for name in ("fleet", "disagg"):
            got = [list(map(int, t)) for t in
                   (server.generate(name, [p], 6)[0] for p in prompts)]
            assert got == want, name
        coord = server._fleets["disagg"].disagg
        _wait_for(lambda: coord.committed >= len(prompts))
        assert coord.failed == 0
        assert (coord.last_predicted_us or 0.0) > 0.0
    finally:
        server.shutdown()


def _spec_dir(tmp_path):
    """A model dir holding the machine spec as `spec.json`: the entry's
    relative `machine_spec` resolves against it."""
    d = tmp_path / "disagg"
    d.mkdir()
    with open(SPEC_PATH) as f:
        (d / "spec.json").write_text(f.read())
    return str(d)


# ---------------------------------------------------------------------
# one directory, both packages
# ---------------------------------------------------------------------
def test_one_directory_serves_equal_outputs_in_both_packages(tmp_path):
    """An f32 ONNX entry, a bf16 ONNX entry and a C-spec entry carrying a
    checkpoint that JAX's save_checkpoint wrote after JAX trained the
    model: both packages' repositories load all three and /infer gives
    the same outputs (f32 within 1e-5, bf16 within BF16_TOL); the port's
    C-spec entry serves JAX's trained weights."""
    rng = np.random.RandomState(7)
    _write_mlp_onnx(tmp_path / "f32", rng)
    _write_mlp_onnx(tmp_path / "bf16", rng, mixed_precision=True)
    spec = _spec()
    from flexflow_tpu.native.c_model import model_from_spec as jax_spec

    config = jff.FFConfig()
    config.num_devices = 1
    config.allow_mixed_precision = False
    trained = jax_spec(json.dumps(spec), config=config)
    trained.compile(optimizer=jff.SGDOptimizer(trained, lr=0.1),
                    loss_type=jff.LossType.
                    LOSS_SPARSE_CATEGORICAL_CROSSENTROPY, metrics=[])
    X = rng.randn(64, 6).astype(np.float32)
    Y = rng.randint(0, 3, size=(64, 1)).astype(np.int32)
    trained.fit(x=X, y=Y, epochs=2, verbose=False)
    mdir = tmp_path / "cspec"
    mdir.mkdir()
    (mdir / "model_spec.json").write_text(json.dumps(spec))
    jax_save_checkpoint(str(mdir / "weights"), trained)
    (mdir / "config.json").write_text(json.dumps({
        "format": "ff_cspec", "file": "model_spec.json",
        "checkpoint": "weights.npz", "max_batch_size": 8}))

    port, jax = InferenceServer(), JaxServer()
    try:
        names = ["bf16", "cspec", "f32"]
        assert _cpu_repo(tmp_path).load(port, strict=True) == names
        assert JaxRepository(str(tmp_path)).load(jax, strict=True) == names
        pm = port._models["cspec"].model.model
        for op, ws in trained.params.items():
            for w, v in ws.items():
                np.testing.assert_array_equal(pm.params[op][w].numpy(),
                                              np.asarray(v, np.float32))
        x = rng.randn(5, 6).astype(np.float32)
        for name in names:
            inp = port._models[name].model.input_names[0]
            assert inp == jax._models[name].model.input_names[0]
            got = np.asarray(port.infer(name, {inp: x}, timeout=30.0))
            ref = np.asarray(jax.infer(name, {inp: x}, timeout=30.0),
                             np.float32)
            tol = F32_TOL if name == "f32" else BF16_TOL
            np.testing.assert_allclose(got, ref, err_msg=name, **tol)
    finally:
        port.shutdown()
        jax.shutdown()
