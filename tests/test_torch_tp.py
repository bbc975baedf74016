"""Tensor- and data-parallel training of the port on gloo ranks on the
CPU: the flagship BERT encoder (2 layers, hidden 64, 4 heads, seq 16,
batch 8, f32, use_flash=True) under `compile(parallel_axes={"data": 2,
"model": 2})` on 4 ranks against the JAX package's dp x tp fit on 4 of
conftest's 8 CPU devices (its TP attention runs the head-separated flash
kernels in interpret mode, the port their plain versions), from JAX's
weights, 3 Adam steps; the port on a `model` or `data` axis of 2 ranks
against the port on one device; each rank's shard shapes against JAX's
per-device shards; and the raises of what is not ported.

The ranks are spawned processes (flexflow_tpu_torch.tools.tp_train
`spawn_jobs`, which imports no jax) meeting at a file:// rendezvous in a
temporary directory, each spawn under its own time limit.
"""
import numpy as np
import pytest
import torch

import flexflow_tpu as ff
import flexflow_tpu_torch as pt
from flexflow_tpu.models import TransformerConfig as JaxTransformerConfig
from flexflow_tpu.models import build_bert_encoder as jax_build_bert
from flexflow_tpu_torch.runtime import distributed
from flexflow_tpu_torch.tools.tp_train import build_encoder, spawn_jobs

WIDTHS = dict(hidden_size=64, embedding_size=64, num_heads=4, num_layers=2,
              sequence_length=16, vocab_size=97)
B, STEPS = 8, 3
DP_TP = {"data": 2, "model": 2}
# a spawn's time limit: a hung rank fails its test, not the suite's clock
JOIN_S = 120
# f32, as tests/test_torch_train.py: the same math in another summation
# order (the all-reduced partial sums of wo, the mean over data ranks);
# Adam passes gradient noise through at full relative size, and bk's
# gradient is noise (~1e-11) in both packages, so weights get an absolute
# floor
LOSS_REL = 1e-4
W_RTOL, W_ATOL = 1e-4, 5e-5
JOB = dict(widths=WIDTHS, batch=B, mixed=False,
           adam=(1e-3, None), use_flash=True, steps=STEPS)


def _host(tree):
    """A JAX tree (weights or optimizer state) as numpy, gathered whole."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32) if np.ndim(tree) else np.asarray(tree)


def _data():
    rng = np.random.RandomState(0)
    x = rng.randint(0, WIDTHS["vocab_size"], size=(B, 16)).astype(np.int32)
    y = rng.randint(0, 2, size=(B, 16, 1)).astype(np.int32)
    return x, y


@pytest.fixture(scope="module")
def jax_run():
    """JAX dp x tp: initial weights, per-device shard shapes, per-step
    losses and the final weights."""
    config = ff.FFConfig()
    config.num_devices = 4
    config.batch_size = B
    config.allow_mixed_precision = False
    jm = ff.FFModel(config)
    tok = jm.create_tensor([B, 16], ff.DataType.DT_INT32)
    jax_build_bert(jm, tok, JaxTransformerConfig(**WIDTHS), use_flash=True)
    jm.compile(optimizer=ff.AdamOptimizer(jm, alpha=1e-3),
               loss_type=ff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[ff.MetricsType.METRICS_ACCURACY],
               parallel_axes=DP_TP)
    shards = {op: {w: tuple(v.sharding.shard_shape(v.shape))
                   for w, v in ws.items()} for op, ws in jm.params.items()}
    init = _host(jm.params)
    x, y = _data()
    hist = jm.fit(x, y, batch_size=B, epochs=1)
    # the state after one step: weights and nonzero Adam moments
    after1 = (_host(jm.params), _host(dict(jm.opt_state)))
    hist += jm.fit(x, y, batch_size=B, epochs=STEPS - 1)
    return {"init": init, "shards": shards, "final": _host(jm.params),
            "after1": after1, "losses": [h["loss"] for h in hist]}


@pytest.fixture(scope="module")
def port_dp_tp(jax_run, tmp_path_factory):
    """The port on 4 gloo ranks: from JAX's initial weights, and from
    JAX's weights and optimizer state after one step; results by rank."""
    x, y = _data()
    job = dict(JOB, axes=DP_TP, params=jax_run["init"], x=x, y=y,
               return_params=True, eval=True)
    params1, opt1 = jax_run["after1"]
    resume = dict(job, params=params1, opt_state=opt1, steps=STEPS - 1,
                  eval=False)
    res = spawn_jobs(4, "cpu", [job, resume], timeout_s=JOIN_S,
                     workdir=str(tmp_path_factory.mktemp("rdv")))
    return [r["jobs"] for r in res]


@pytest.mark.parametrize("job", [0, 1], ids=["from_init", "resumed"])
def test_dp_tp_losses_match_jax(jax_run, port_dp_tp, job):
    """From JAX's initial weights (3 steps), and from its weights and Adam
    state after one step (the last 2), each rank loading them whole."""
    want = jax_run["losses"][job:]
    for ranks in port_dp_tp:
        got = ranks[job]["losses"]
        assert len(got) == len(want)
        for p, j in zip(got, want):
            assert p == pytest.approx(j, rel=LOSS_REL)


@pytest.mark.parametrize("job", [0, 1], ids=["from_init", "resumed"])
def test_dp_tp_weights_match_jax(jax_run, port_dp_tp, job):
    got = port_dp_tp[0][job]["params"]
    assert set(got) == set(jax_run["final"])
    for op, ws in jax_run["final"].items():
        for w, v in ws.items():
            np.testing.assert_allclose(got[op][w], v, rtol=W_RTOL,
                                       atol=W_ATOL, err_msg=f"{op}/{w}")


def test_dp_tp_ranks_agree(port_dp_tp):
    """Every rank reports the same losses and eval, holds the same
    replicated weights to the bit, and gathers the same whole model."""
    port_dp_tp = [r[0] for r in port_dp_tp]
    coords = sorted(tuple(sorted(r["mesh_coords"].items()))
                    for r in port_dp_tp)
    assert coords == [(("data", d), ("model", m)) for d in (0, 1)
                      for m in (0, 1)]
    first = port_dp_tp[0]
    for r in port_dp_tp[1:]:
        assert r["losses"] == first["losses"]
        assert r["eval"] == first["eval"]
        assert r["replicated_digest"] == first["replicated_digest"]
        for op, ws in first["params"].items():
            for w, v in ws.items():
                np.testing.assert_array_equal(r["params"][op][w], v)
    assert first["eval"]["samples"] == B
    assert np.isfinite(first["eval"]["loss"])


def test_shard_shapes_match_jax_per_device_shards(jax_run, port_dp_tp):
    for ranks in port_dp_tp:
        assert ranks[0]["shard_shapes"] == jax_run["shards"]
    # the TP weights are cut, the rest whole (hidden 64, 4 heads, 2 ranks)
    got = port_dp_tp[0][0]["shard_shapes"]
    assert got["layer0_attn"]["wq"] == (64, 2, 16)
    assert got["layer0_attn"]["wo"] == (2, 16, 64)
    assert got["layer0_attn"]["bo"] == (64,)
    assert got["layer0_ff1"]["kernel"] == (64, 128)
    assert got["tok_emb"]["weight"] == (97, 32)
    assert got["cls"]["kernel"] == (64, 1)
    assert got["layer0_ln1"]["gamma"] == (64,)


@pytest.mark.parametrize("axes", [{"model": 2}, {"data": 2}])
def test_two_ranks_match_one_device(axes, tmp_path):
    """The port on a 2-rank axis against the port on one device, both
    from the same seed's weights."""
    x, y = _data()
    job = dict(JOB, seed=3, x=x, y=y, return_params=True)
    one = build_encoder(dict(job, axes={}), "cpu")
    one.fit(x, y, batch_size=B, epochs=STEPS)
    hist = one.step_records  # per step, as tp_train reports the ranks'
    res = spawn_jobs(2, "cpu", [dict(job, axes=axes)], timeout_s=JOIN_S,
                     workdir=str(tmp_path))
    for r in res:
        got = r["jobs"][0]
        for p, j in zip(got["losses"], hist):
            assert p == pytest.approx(j["loss"], rel=LOSS_REL)
        for op, ws in one.params.items():
            for w, v in ws.items():
                np.testing.assert_allclose(got["params"][op][w], v.numpy(),
                                           rtol=W_RTOL, atol=W_ATOL,
                                           err_msg=f"{op}/{w}")


def _small_model():
    m = pt.FFModel(pt.FFConfig(batch_size=4, device="cpu"))
    t = m.create_tensor([4, 8, 16])
    m.dense(t, 8)
    return m


@pytest.mark.parametrize("axis", ["seq", "expert", "attr", "stage"])
def test_unported_axes_raise_naming_roadmap(axis):
    with pytest.raises(NotImplementedError, match=f"'{axis}'.*ROADMAP A8"):
        _small_model().compile(parallel_axes={"data": 2, axis: 2})


def test_mesh_raises_without_process_group_and_on_bad_axes():
    assert not distributed.is_initialized()
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        _small_model().compile(parallel_axes={"data": 2, "model": 2})
    with pytest.raises(ValueError, match="unknown mesh axis"):
        _small_model().compile(parallel_axes={"rows": 2})
    with pytest.raises(NotImplementedError, match="sharded serving"):
        _small_model().compile(parallel_axes={"model": 2},
                               comp_mode=pt.CompMode.COMP_MODE_INFERENCE)
    # axes of size 1 are no mesh: the one-device plan
    m = _small_model()
    m.compile(parallel_axes={"data": 1, "model": 1})
    assert m.mesh is None


def test_world_size_mismatch_raises(tmp_path):
    info = distributed.initialize("file://" + str(tmp_path / "rdv"),
                                  world_size=1, rank=0, device="cpu")
    try:
        assert info["backend"] == "gloo" and not info["host_staging"]
        with pytest.raises(ValueError, match="needs 4 processes.*has 1"):
            _small_model().compile(parallel_axes=DP_TP)
    finally:
        distributed.shutdown()
    assert not distributed.is_initialized()
