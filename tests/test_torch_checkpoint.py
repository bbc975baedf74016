"""Checkpoints of the port on the CPU (ROADMAP A9.1): the scenarios of
tests/test_checkpoint.py against flexflow_tpu_torch.runtime.checkpoint
and .durability (a small recorder with `record(kind, **details)` stands
in for the JAX package's EventLog, torch bf16 for ml_dtypes); the file
format shared with the JAX package, a checkpoint of either restored into
the other; and the in-place restore: every parameter and optimizer
tensor keeps its identity, and a corrupt or foreign file leaves the model
as it was.

Tolerances: the port against itself to the bit (a restore copies); JAX
against the port (f32, another BLAS) predict 1e-5 and one more epoch's
sparse_cce 1e-4 relative, as tests/test_checkpoint.py holds JAX against
itself.

On a `stage` mesh (ROADMAP C13), {"stage": 4} and {"data": 2,
"stage": 2} with tests/test_torch_pipeline.py's encoder and Adam, four
gloo ranks in one spawn: the port's file holds JAX's stacked
`__pipeline__` tree; JAX's file restored into the port predicts as JAX
does (atol 1e-6), the port's file restored into JAX predicts as the port
does (atol 1e-6), and the port's own round trip restores the weights and
Adam's moments to the bit and predicts to the bit."""
import json
import os

import numpy as np
import pytest
import torch

import flexflow_tpu as ff
import flexflow_tpu_torch as pt
from flexflow_tpu.runtime.checkpoint import \
    restore_checkpoint as jax_restore
from flexflow_tpu.runtime.checkpoint import save_checkpoint as jax_save
from flexflow_tpu_torch.runtime.checkpoint import (CheckpointError,
                                                   restore_checkpoint,
                                                   save_checkpoint,
                                                   verify_checkpoint)
from flexflow_tpu_torch.runtime.durability import (DurableCheckpointer,
                                                   checkpoint_counters,
                                                   reset_checkpoint_counters)
from tests.test_torch_zoo import one_torch_thread

TOL = dict(rtol=1e-5, atol=1e-6)

_one_thread = pytest.fixture(scope="module", autouse=True)(one_torch_thread)


def _net(pkg, m):
    inp = m.create_tensor([8, 16])
    t = m.dense(inp, 32, pkg.ActiMode.AC_MODE_RELU)
    m.softmax(m.dense(t, 4))


def build(seed, moments=None):
    """tests/test_checkpoint.py's model on the port: Adam 1e-2, f32,
    weights drawn from `seed`."""
    model = pt.FFModel(pt.FFConfig(batch_size=8, allow_mixed_precision=False,
                                   device="cpu"))
    _net(pt, model)
    model.compile(
        optimizer=pt.AdamOptimizer(model, alpha=1e-2, moments_dtype=moments),
        loss_type=pt.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
        metrics=[pt.MetricsType.METRICS_SPARSE_CATEGORICAL_CROSSENTROPY],
        generator=torch.Generator().manual_seed(seed))
    return model


def build_jax(moments=None):
    config = ff.FFConfig()
    config.num_devices = 1
    config.batch_size = 8
    config.allow_mixed_precision = False
    model = ff.FFModel(config)
    _net(ff, model)
    model.compile(
        optimizer=ff.AdamOptimizer(model, alpha=1e-2, moments_dtype=moments),
        loss_type=ff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
        metrics=[ff.MetricsType.METRICS_SPARSE_CATEGORICAL_CROSSENTROPY])
    return model


def _data():
    rng = np.random.RandomState(0)
    return (rng.randn(64, 16).astype(np.float32),
            rng.randint(0, 4, size=(64, 1)).astype(np.int32))


def test_checkpoint_roundtrip_and_resume(tmp_path):
    x, y = _data()
    m1 = build(0)
    m1.fit(x, y, epochs=2)
    pred1 = m1.predict(x)
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, m1, step=7)

    m2 = build(1)
    assert not np.allclose(m2.predict(x), pred1)
    assert restore_checkpoint(path, m2) == 7
    np.testing.assert_array_equal(m2.predict(x), pred1)
    assert m2._step_count == m1._step_count == 16
    # training resumes from the restored optimizer state: the same bits
    h1 = m1.fit(x, y, epochs=1)
    h2 = m2.fit(x, y, epochs=1)
    assert h1[-1]["sparse_cce"] == h2[-1]["sparse_cce"]
    for op, ws in m1.params.items():
        for w, t in ws.items():
            assert torch.equal(m2.params[op][w], t), (op, w)


def test_restore_non_checkpoint_npz_raises_named_error(tmp_path):
    path = str(tmp_path / "weights.npz")
    np.savez(path, w=np.ones((3, 3), np.float32))
    with pytest.raises(CheckpointError, match="weights.npz"):
        restore_checkpoint(path, build(0))
    with pytest.raises(CheckpointError, match="not a flexflow_tpu"):
        verify_checkpoint(path)


def test_restore_missing_and_garbage_files(tmp_path):
    with pytest.raises(CheckpointError, match="does not exist"):
        restore_checkpoint(str(tmp_path / "nope"), build(0))
    garbage = tmp_path / "bad.npz"
    garbage.write_bytes(b"this is not a zip archive")
    with pytest.raises(CheckpointError, match="bad.npz"):
        restore_checkpoint(str(garbage), build(0))


class _FakeModel:
    """A model's checkpoint surface alone: weight, optimizer and state
    trees of tensors, and the in-place loads."""

    def __init__(self, params):
        self.params, self.opt_state, self.state = params, {}, {}
        self._step_count = 3

    def load_params(self, tree):
        for op, ws in tree.items():
            for w, v in ws.items():
                self.params[op][w].copy_(v)


def test_bfloat16_roundtrip_with_checksums(tmp_path):
    """bf16 tensors survive save and restore with the CRCs checked: the
    checksums cover the widened f32 bytes as stored, and the receiving
    tensor keeps its bf16."""
    src = torch.randn(16, 8, generator=torch.Generator().manual_seed(0)
                      ).to(torch.bfloat16)
    path = save_checkpoint(str(tmp_path / "bf16"), _FakeModel(
        {"fc": {"kernel": src, "bias": torch.zeros(8)}}), step=5)
    meta = verify_checkpoint(path)
    assert meta["dtypes"] == {"params/fc/kernel": "bfloat16"}
    assert set(meta["crc32"]) == {"params/fc/kernel", "params/fc/bias"}
    assert meta["format"] == "flexflow_tpu_checkpoint"
    assert meta["version"] == 1 and meta["step_count"] == 3

    dst = _FakeModel({"fc": {"kernel": torch.zeros(16, 8,
                                                   dtype=torch.bfloat16),
                             "bias": torch.ones(8)}})
    assert restore_checkpoint(path, dst) == 5
    assert dst.params["fc"]["kernel"].dtype == torch.bfloat16
    assert torch.equal(dst.params["fc"]["kernel"], src)
    assert torch.equal(dst.params["fc"]["bias"], torch.zeros(8))


def test_crc_mismatch_detected(tmp_path):
    path = save_checkpoint(str(tmp_path / "c"), _FakeModel(
        {"fc": {"w": torch.ones(4, 4)}}), step=1)
    data = dict(np.load(path, allow_pickle=False))
    meta = json.loads(str(data.pop("__meta__")))
    meta["crc32"]["params/fc/w"] ^= 0xFF
    np.savez(path, __meta__=json.dumps(meta), **data)
    with pytest.raises(CheckpointError, match="CRC32"):
        verify_checkpoint(path)


def test_save_is_atomic_no_tmp_left_behind(tmp_path):
    path = save_checkpoint(str(tmp_path / "a"), _FakeModel(
        {"fc": {"w": torch.ones(3)}}), step=0)
    assert os.path.basename(path) == "a.npz"
    assert sorted(os.listdir(tmp_path)) == ["a.npz"]


class _Events:
    """What DurableCheckpointer needs of an event log."""

    def __init__(self):
        self.records = []

    def record(self, kind, **details):
        self.records.append((kind, details))

    def events(self, kind):
        return [d for k, d in self.records if k == kind]


def test_manifest_retention_gc(tmp_path):
    ckpt, model = DurableCheckpointer(str(tmp_path), keep_last=2), build(0)
    for step in (0, 2, 4, 6):
        ckpt.save(model, step=step)
    files = sorted(f for f in os.listdir(tmp_path) if f.endswith(".npz"))
    assert files == ["ckpt_000004.npz", "ckpt_000006.npz"]
    assert [e["step"] for e in ckpt.entries()] == [4, 6]
    with open(ckpt.manifest_path) as f:
        manifest = json.load(f)
    assert manifest["keep_last"] == 2
    step, path = ckpt.latest_verified()
    assert step == 6 and path.endswith("ckpt_000006.npz")


def test_torn_write_falls_back_to_previous_verified(tmp_path):
    reset_checkpoint_counters()
    events = _Events()
    ckpt = DurableCheckpointer(str(tmp_path), keep_last=3, events=events)
    model = build(0)
    ckpt.save(model, step=0)
    model.fit(np.random.RandomState(0).randn(16, 16).astype(np.float32),
              np.zeros((16, 1), np.int32), epochs=1)
    ckpt.save(model, step=2)
    newest = os.path.join(str(tmp_path), "ckpt_000002.npz")
    with open(newest, "r+b") as f:
        f.truncate(os.path.getsize(newest) // 2)

    target = build(1)
    step, path = ckpt.restore_latest(target)
    assert step == 0 and path.endswith("ckpt_000000.npz")
    assert len(events.events("checkpoint.corrupt")) == 1
    fb = events.events("checkpoint.fallback")
    assert len(fb) == 1 and fb[0]["skipped"] == 1
    assert checkpoint_counters() == {"saved": 2, "corrupt": 1,
                                     "verified": 1, "fallback": 1,
                                     "restored": 1}
    reset_checkpoint_counters()
    assert checkpoint_counters() == {}


def test_no_verified_checkpoint_raises(tmp_path):
    ckpt, model = DurableCheckpointer(str(tmp_path)), build(0)
    path = ckpt.save(model, step=0)
    with open(path, "r+b") as f:
        f.truncate(10)
    with pytest.raises(CheckpointError, match="no verified checkpoint"):
        ckpt.restore_latest(build(1))


def test_entries_survive_missing_manifest(tmp_path):
    save_checkpoint(str(tmp_path / "ckpt_000004"), build(0), step=4)
    ckpt = DurableCheckpointer(str(tmp_path))
    step, path = ckpt.latest_verified()
    assert step == 4 and path.endswith("ckpt_000004.npz")


# -- the shared format ---------------------------------------------------------
@pytest.mark.parametrize("moments", [None, "bfloat16"])
def test_jax_checkpoint_restores_into_the_port(tmp_path, moments):
    import jax.numpy as jnp

    x, y = _data()
    jm = build_jax(jnp.bfloat16 if moments else None)
    jm.fit(x, y, epochs=2)
    path = jax_save(str(tmp_path / "jax"), jm, step=3)
    pm = build(1, getattr(torch, moments) if moments else None)
    assert restore_checkpoint(path, pm) == 3
    np.testing.assert_allclose(pm.predict(x), jm.predict(x), **TOL)
    assert int(pm.opt_state["step"]) == int(jm.opt_state["step"])
    if moments:
        assert pm.opt_state["m"]["linear_0"]["kernel"].dtype == \
            torch.bfloat16
        np.testing.assert_array_equal(
            pm.opt_state["v"]["linear_0"]["kernel"].float().numpy(),
            np.asarray(jm.opt_state["v"]["linear_0"]["kernel"]).astype(
                np.float32))
    jh = jm.fit(x, y, epochs=1)
    ph = pm.fit(x, y, epochs=1)
    assert ph[-1]["sparse_cce"] == pytest.approx(jh[-1]["sparse_cce"],
                                                 rel=1e-4)


@pytest.mark.parametrize("moments", [None, "bfloat16"])
def test_port_checkpoint_restores_into_jax(tmp_path, moments):
    import jax.numpy as jnp

    x, y = _data()
    pm = build(0, getattr(torch, moments) if moments else None)
    pm.fit(x, y, epochs=2)
    path = save_checkpoint(str(tmp_path / "port"), pm, step=9)
    if moments:
        assert verify_checkpoint(path)["dtypes"]["opt_state/m/linear_0/"
                                                 "kernel"] == "bfloat16"
    jm = build_jax(jnp.bfloat16 if moments else None)
    assert jax_restore(path, jm) == 9
    assert jm._step_count == pm._step_count
    np.testing.assert_allclose(jm.predict(x), pm.predict(x), **TOL)
    jh = jm.fit(x, y, epochs=1)
    ph = pm.fit(x, y, epochs=1)
    assert jh[-1]["sparse_cce"] == pytest.approx(ph[-1]["sparse_cce"],
                                                 rel=1e-4)


# -- in place ----------------------------------------------------------------
def _tensors(model):
    return [t for ws in model.executor.parameters().values()
            for t in ws.values()] + [
        t for k in ("step", "lr") for t in [model.opt_state[k]]] + [
        t for k in ("m", "v") for ws in model.opt_state[k].values()
        for t in ws.values()]


def test_restore_keeps_every_tensor_in_place(tmp_path):
    x, y = _data()
    src = build(0)
    src.fit(x, y, epochs=1)
    path = save_checkpoint(str(tmp_path / "src"), src, step=1)
    dst = build(1)
    before = [(id(t), t.data_ptr(), t._version) for t in _tensors(dst)]
    restore_checkpoint(path, dst)
    after = [(id(t), t.data_ptr(), t._version) for t in _tensors(dst)]
    assert [a[:2] for a in after] == [b[:2] for b in before]
    # every weight and moment was written (its version moved)
    assert all(a[2] > b[2] for a, b in zip(after, before))
    for op, ws in src.params.items():
        for w, t in ws.items():
            assert torch.equal(dst.params[op][w], t)


def test_corrupt_or_foreign_file_leaves_the_model_untouched(tmp_path):
    x, y = _data()
    src = build(0)
    src.fit(x, y, epochs=1)
    good = save_checkpoint(str(tmp_path / "good"), src, step=1)
    dst = build(1)
    snapshot = [t.clone() for t in _tensors(dst)]

    def untouched():
        return all(torch.equal(a, b) for a, b in zip(_tensors(dst),
                                                     snapshot))

    # a flipped byte in the last array's data: its CRC fails
    data = dict(np.load(good, allow_pickle=False))
    meta = json.loads(str(data.pop("__meta__")))
    last = sorted(data)[-1]
    data[last] = data[last] + 1
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, __meta__=json.dumps(meta), **data)
    with pytest.raises(CheckpointError, match="CRC32"):
        restore_checkpoint(bad, dst)
    assert untouched() and dst._step_count == 0
    # another model's checkpoint: names or shapes differ
    other = pt.FFModel(pt.FFConfig(batch_size=8, device="cpu"))
    t = other.dense(other.create_tensor([8, 16]), 8)
    other.softmax(other.dense(t, 4))
    other.compile(optimizer=pt.AdamOptimizer(other, alpha=1e-2))
    foreign = save_checkpoint(str(tmp_path / "foreign"), other)
    with pytest.raises(CheckpointError, match="shape"):
        restore_checkpoint(foreign, dst)
    assert untouched()
    renamed = dict(np.load(good, allow_pickle=False))
    meta = json.loads(str(renamed.pop("__meta__")))
    renamed["params/extra/w"] = np.ones(2, np.float32)
    meta["crc32"]["params/extra/w"] = 0
    np.savez(str(tmp_path / "extra.npz"), __meta__=json.dumps(meta),
             **renamed)
    with pytest.raises(CheckpointError, match="names differ"):
        restore_checkpoint(str(tmp_path / "extra.npz"), dst, verify=False)
    assert untouched()


def test_inference_model_takes_the_weights_only(tmp_path):
    x, y = _data()
    src = build(0)
    src.fit(x, y, epochs=1)
    path = save_checkpoint(str(tmp_path / "src"), src, step=2)
    inf = pt.FFModel(pt.FFConfig(batch_size=8, allow_mixed_precision=False,
                                 device="cpu"))
    _net(pt, inf)
    inf.compile(comp_mode=pt.CompMode.COMP_MODE_INFERENCE)
    assert restore_checkpoint(path, inf) == 2
    np.testing.assert_array_equal(inf.predict(x), src.predict(x))


# -- a stage mesh (ROADMAP C13) ------------------------------------------
STAGE_MESHES = {"stage4": {"stage": 4}, "data2_stage2": {"data": 2, "stage": 2}}


def _jax_stage_model(axes, seed=45):
    import flexflow_tpu.models  # noqa: F401
    from flexflow_tpu_torch.tools.tp_train import MODELS
    from tests.test_torch_pipeline import B, WIDTHS

    cfg = ff.FFConfig()
    cfg.num_devices = 4
    cfg.batch_size = B
    cfg.pipeline_microbatches = 4
    cfg.allow_mixed_precision = False
    cfg.seed = seed
    jm = ff.FFModel(cfg)
    MODELS["encoder"](ff, jm, {"batch": B, "use_flash": None}, **WIDTHS)
    jm.compile(optimizer=ff.AdamOptimizer(jm, alpha=0.01),
               loss_type=ff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[ff.MetricsType.METRICS_ACCURACY],
               parallel_axes=axes)
    return jm


@pytest.fixture(scope="module")
def stage_runs(tmp_path_factory):
    from flexflow_tpu_torch.tools.tp_train import spawn_jobs
    from tests.test_torch_pipeline import B, WIDTHS, _data, _host

    tmp = tmp_path_factory.mktemp("stage_ckpt")
    x, y = _data()
    base = dict(model="encoder", widths=WIDTHS, batch=B, mixed=False,
                optimizer=("adam", 0.01, None), x=x, y=y,
                config={"pipeline_microbatches": 4}, predict_batch=B)
    jax_side, jobs = {}, []
    for name, axes in STAGE_MESHES.items():
        jm = _jax_stage_model(axes)
        init = _host(jm.params)
        jm.fit(x, y, batch_size=B, epochs=2)
        path = jax_save(str(tmp / f"jax_{name}.npz"), jm, step=2)
        jax_side[name] = {"file": path, "keys": sorted(
            np.load(path).files), "predict": np.asarray(
                jm.predict(x, batch_size=B))}
        jobs.append(dict(base, axes=axes, steps=0, restore_path=path))
        jobs.append(dict(base, axes=axes, steps=2, jax_params=init,
                         checkpoint_dir=str(tmp / f"port_{name}")))
    ranks = spawn_jobs(4, "cpu", jobs, timeout_s=300)
    out = {}
    for i, name in enumerate(STAGE_MESHES):
        out[name] = {"from_jax": [r["jobs"][2 * i] for r in ranks],
                     "own": [r["jobs"][2 * i + 1] for r in ranks]}
    return out, jax_side


@pytest.mark.parametrize("mesh", sorted(STAGE_MESHES))
def test_stage_mesh_checkpoint_is_the_jax_stacked_tree(stage_runs, mesh):
    """The port's file names the arrays as JAX's file does: the stacked
    `__pipeline__` tree, Adam's moments following it."""
    runs, jax_side = stage_runs
    keys = runs[mesh]["own"][0]["checkpoint_keys"]
    assert keys == jax_side[mesh]["keys"]
    assert any(k.startswith("params/__pipeline__/seg0_op") for k in keys)
    assert any(k.startswith("opt_state/m/__pipeline__/") for k in keys)


@pytest.mark.parametrize("mesh", sorted(STAGE_MESHES))
def test_jax_stage_checkpoint_restores_into_the_port(stage_runs, mesh):
    runs, jax_side = stage_runs
    for r in runs[mesh]["from_jax"]:
        np.testing.assert_allclose(r["predict"], jax_side[mesh]["predict"],
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("mesh", sorted(STAGE_MESHES))
def test_port_stage_checkpoint_restores_into_jax(stage_runs, mesh):
    from tests.test_torch_pipeline import B, _data

    runs, _ = stage_runs
    own = runs[mesh]["own"][0]
    jm = _jax_stage_model(STAGE_MESHES[mesh], seed=46)
    assert jax_restore(own["checkpoint"], jm) == own["restored_step"]
    x, _ = _data()
    np.testing.assert_allclose(np.asarray(jm.predict(x, batch_size=B)),
                               own["predict"], rtol=0, atol=1e-6)


@pytest.mark.parametrize("mesh", sorted(STAGE_MESHES))
def test_port_stage_round_trip_keeps_adam_moments(stage_runs, mesh):
    runs, _ = stage_runs
    for r in runs[mesh]["own"]:
        assert r["restored_step"] == 2
        assert r["restored_state_equal"]
        np.testing.assert_array_equal(r["restored_predict"], r["predict"])
