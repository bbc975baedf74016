"""The port's native prefetching batch loader (csrc/ffcore/dataloader.cc
through flexflow_tpu_torch.native.BatchStream) on the CPU:
tests/test_native_dataloader.py's cases over the port's library and
SingleDataLoader, then the port's stream and loader held against the JAX
package's on the same data and seeds, batch for batch (C20): in order and
shuffled, over three epochs and a reset.
"""
import time

import numpy as np
import pytest

import flexflow_tpu as ff
import flexflow_tpu_torch as pt
from flexflow_tpu import native as jnative
from flexflow_tpu_torch import native


def make_data(n=32, f=5):
    return (np.arange(n * f, dtype=np.float32).reshape(n, f) + 1.0)


def _model(pkg, batch=8, f=5, classes=4, **cfg):
    config = (pkg.FFConfig(device="cpu") if pkg is pt else pkg.FFConfig())
    config.batch_size = batch
    config.allow_mixed_precision = False
    for k, v in cfg.items():
        setattr(config, k, v)
    model = pkg.FFModel(config)
    x = model.create_tensor([batch, f])
    model.softmax(model.dense(x, classes))
    return model, x


# ---------------------------------------------------------------------
# tests/test_native_dataloader.py's cases
# ---------------------------------------------------------------------
def test_sequential_batches_match_slices():
    data = make_data()
    bs = 8
    s = native.BatchStream(data, bs, shuffle=False)
    try:
        for epoch in range(3):
            for i in range(s.num_batches):
                np.testing.assert_array_equal(
                    s.next_batch(), data[i * bs:(i + 1) * bs])
    finally:
        s.close()


def test_shuffled_epoch_is_permutation_and_deterministic():
    data = make_data(n=24)
    bs = 6

    def epoch_rows(stream):
        rows = []
        for _ in range(stream.num_batches):
            rows.extend(stream.next_batch()[:, 0].tolist())
        return rows

    s1 = native.BatchStream(data, bs, shuffle=True, seed=7)
    s2 = native.BatchStream(data, bs, shuffle=True, seed=7)
    s3 = native.BatchStream(data, bs, shuffle=True, seed=8)
    try:
        e0 = epoch_rows(s1)
        assert sorted(e0) == sorted(data[:, 0].tolist())  # a permutation
        assert e0 != data[:, 0].tolist()  # actually shuffled
        assert epoch_rows(s2) == e0  # deterministic per seed
        assert epoch_rows(s3) != e0  # seed-sensitive
        e1 = epoch_rows(s1)
        assert e1 != e0 and sorted(e1) == sorted(e0)  # reshuffles per epoch
    finally:
        s1.close()
        s2.close()
        s3.close()


def test_reset_restarts_epoch_zero():
    data = make_data(n=16)
    s = native.BatchStream(data, 4, shuffle=True, seed=3)
    try:
        first = s.next_batch().copy()
        s.next_batch()
        s.reset()
        np.testing.assert_array_equal(s.next_batch(), first)
        assert s.epoch == 0
    finally:
        s.close()


def test_buffer_stable_until_next_call():
    """The handed-out buffer is not overwritten by the producer before
    the consumer's NEXT call (the ring keeps a one-slot margin), even
    when the consumer is slow; a batch kept after the stream is dropped
    still reads (the buffer holds the stream)."""
    data = make_data(n=64, f=3)
    s = native.BatchStream(data, 4, shuffle=False, prefetch_depth=3)
    try:
        for i in range(s.num_batches):
            b = s.next_batch()
            expect = data[i * 4:(i + 1) * 4]
            np.testing.assert_array_equal(b, expect)
            if i < 3:
                time.sleep(0.02)  # let the producer run ahead
                np.testing.assert_array_equal(b, expect)  # still intact
    finally:
        s.close()
    s = native.BatchStream(data, 4)
    kept = s.next_batch()
    del s
    np.testing.assert_array_equal(kept, data[:4])


def test_single_dataloader_native_backend():
    model, x = _model(pt)
    data = make_data(n=32)
    loader = pt.SingleDataLoader(model, x, data)
    assert loader.backend == "native"
    np.testing.assert_array_equal(loader.next_batch(), data[:8])
    np.testing.assert_array_equal(loader.next_batch(), data[8:16])
    loader.reset()
    np.testing.assert_array_equal(loader.next_batch(), data[:8])


def test_single_dataloader_numpy_fallback_matches():
    model, x = _model(pt)
    data = make_data(n=32)
    nat = pt.SingleDataLoader(model, x, data, prefetch=True)
    py = pt.SingleDataLoader(model, x, data, prefetch=False)
    assert nat.backend == "native" and py.backend == "numpy"
    for _ in range(2 * nat.num_batches):  # across an epoch wrap
        np.testing.assert_array_equal(nat.next_batch(), py.next_batch())
    # a dataset smaller than a batch takes the numpy path
    assert pt.SingleDataLoader(model, x, make_data(n=4)).backend == "numpy"


def test_fit_consumes_loaders_via_next_batch(monkeypatch):
    """fit() without x/y pulls batches through next_batch() (prefetch
    ring + shuffle honored), not by reading loader.data."""
    from flexflow_tpu_torch.runtime.dataloader import SingleDataLoader

    calls = {"n": 0}
    orig = SingleDataLoader.next_batch

    def counting(self, ffmodel=None):
        calls["n"] += 1
        return orig(self, ffmodel)

    monkeypatch.setattr(SingleDataLoader, "next_batch", counting)
    model, x = _model(pt, epochs=1)
    model.compile(loss_type=pt.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    data = make_data(n=32)
    labels = np.random.RandomState(0).randint(0, 4, size=(32, 1)).astype(
        np.int32)
    pt.SingleDataLoader(model, x, data, shuffle=True, seed=7)
    pt.SingleDataLoader(model, model.label_tensor, labels, shuffle=True,
                        seed=7)
    model.fit()
    # 4 batches per epoch, x and label loaders each pulled once per batch
    assert calls["n"] == 2 * (32 // 8)


def test_fit_shuffled_loaders_stay_aligned():
    """Loaders sharing a seed shuffle in lockstep: training on a learnable
    identity mapping with shuffle=True still converges."""
    rs = np.random.RandomState(3)
    n, f = 64, 4
    data = rs.randn(n, f).astype(np.float32)
    labels = np.argmax(data, axis=1).astype(np.int32).reshape(n, 1)
    model, x = _model(pt, f=f, classes=f, epochs=30, learning_rate=0.5)
    model.compile(optimizer=pt.SGDOptimizer(model, lr=0.5),
                  loss_type=pt.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                  metrics=[pt.MetricsType.METRICS_ACCURACY])
    a = pt.SingleDataLoader(model, x, data, shuffle=True, seed=11)
    b = pt.SingleDataLoader(model, model.label_tensor, labels, shuffle=True,
                            seed=11)
    assert a.backend == b.backend == "native"
    hist = model.fit()
    assert hist[-1]["accuracy"] > 0.9, hist[-1]


# ---------------------------------------------------------------------
# against the JAX package's loader (C20)
# ---------------------------------------------------------------------
@pytest.mark.parametrize("shuffle", [False, True])
def test_batch_stream_yields_jax_s_batches(shuffle):
    """The same rows in the same order as JAX's stream over three epochs,
    then again from epoch 0 after a reset; each batch's epoch too."""
    data = make_data(n=64, f=3)
    mine = native.BatchStream(data, 8, shuffle=shuffle, seed=3)
    theirs = jnative.BatchStream(data, 8, shuffle=shuffle, seed=3)
    try:
        for _ in range(2):
            for _ in range(3 * mine.num_batches):
                np.testing.assert_array_equal(mine.next_batch(),
                                              theirs.next_batch())
                assert mine.epoch == theirs.epoch
            assert mine.epoch == 2
            mine.reset()
            theirs.reset()
    finally:
        mine.close()
        theirs.close()


@pytest.mark.parametrize("shuffle", [False, True])
def test_default_loader_is_jax_s_default_loader(shuffle):
    """SingleDataLoader with its defaults in both packages: the native
    backend, and the same batches across epoch wraps and a reset. The
    C20 example (64 rows, batch 8, seed 3) gives JAX's first batch."""
    data = np.arange(64 * 4, dtype=np.float32).reshape(64, 4)
    jm, jx = _model(ff, f=4)
    pm, px = _model(pt, f=4)
    jl = ff.SingleDataLoader(jm, jx, data, shuffle=shuffle, seed=3)
    pl = pt.SingleDataLoader(pm, px, data, shuffle=shuffle, seed=3)
    assert pl.backend == jl.backend == "native"
    first = pl.next_batch()
    np.testing.assert_array_equal(first, jl.next_batch())
    if shuffle:
        assert first[:, 0].tolist() == [204, 240, 80, 184, 12, 100, 56,
                                        236]
    for _ in range(2 * pl.num_batches + 3):
        np.testing.assert_array_equal(pl.next_batch(), jl.next_batch())
    pl.reset()
    jl.reset()
    for _ in range(pl.num_batches):
        np.testing.assert_array_equal(pl.next_batch(), jl.next_batch())
