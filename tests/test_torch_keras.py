"""The Keras frontend of the port (flexflow_tpu_torch/keras/) against the
JAX package's (flexflow_tpu/keras/): each scenario of tests/test_keras.py
runs in both packages on the CPU in f32.

Each model is built by the same code with either package's keras
(`_pair`): the JAX one compiles first, its weights (JAX's draws, in
`get_weights()`' order: op name, then weight name) go into the port's
through `set_weights`, and the two graphs must hold the same op names and
types, with `predict` within 1e-5 absolute on the same rows. Training
scenarios then fit both on the same batches: the per-epoch losses must
agree within 1e-4 relative, and an accuracy-gated scenario must clear
JAX's own bar on the port. Dropout's masks are not jax.random's: the
dropout case trains at rate 0 (its op names and shapes are what differ
by package otherwise)."""
import os

import numpy as np
import pytest

import flexflow_tpu.keras as jk
import flexflow_tpu_torch.keras as pk
from flexflow_tpu.config import FFConfig as JaxConfig
from flexflow_tpu_torch import FFConfig as TorchConfig
from tests.test_keras import separable_data
from tests.test_torch_zoo import one_torch_thread, unoptimised_xla

_one_thread = pytest.fixture(scope="module", autouse=True)(one_torch_thread)

PREDICT_ATOL = 1e-5
LOSS_RTOL = 1e-4


def small_config(k, batch=16):
    if k is pk:
        return TorchConfig(batch_size=batch, num_devices=1, device="cpu",
                           allow_mixed_precision=False)
    c = JaxConfig()
    c.batch_size = batch
    c.num_devices = 1
    c.allow_mixed_precision = False
    return c


def _ops(model):
    return [(op.name, op.op_type.value) for op in model.ffmodel.ops]


def _pair(build, x=None):
    """build(k) -> a compiled keras model of package k. Returns the JAX
    and the port's model, the port's holding JAX's weights; with `x`,
    their predictions are held within PREDICT_ATOL."""
    with unoptimised_xla():
        jm = build(jk)
    pm = build(pk)
    assert _ops(pm) == _ops(jm)
    jw = jm.get_weights()
    assert [w.shape for w in pm.get_weights()] == [w.shape for w in jw]
    pm.set_weights(jw)
    if x is not None:
        pj, pp = jm.predict(x), pm.predict(x)
        assert pp.shape == pj.shape
        np.testing.assert_allclose(pp, pj, rtol=0, atol=PREDICT_ATOL)
    return jm, pm


def _same_losses(hj, hp, keys=("loss",)):
    assert hp.epoch == hj.epoch
    for key in keys:
        np.testing.assert_allclose(hp.history[key], hj.history[key],
                                   rtol=LOSS_RTOL)


def _mlp(k, hidden=32, opt=None, reg=None, steps=1, metrics=("accuracy",)):
    m = k.models.Sequential()
    m.add(k.layers.Dense(hidden, activation="relu", input_shape=(20,),
                         kernel_regularizer=reg))
    m.add(k.layers.Dense(4))
    m.add(k.layers.Activation("softmax"))
    m.compile(optimizer=opt or k.optimizers.SGD(learning_rate=0.1),
              loss="sparse_categorical_crossentropy", metrics=list(metrics),
              ffconfig=small_config(k), steps_per_execution=steps)
    return m


@pytest.mark.parametrize("steps", [1, 4], ids=["per_step",
                                               "steps_per_execution"])
def test_sequential_mlp_learns_like_jax(steps):
    """test_keras.py's sequential_mlp_learns and
    steps_per_execution_learns: 8 SGD epochs; at K = 4 the model's one
    K-step dispatch serves every epoch's fit call."""
    x, y = separable_data()
    jm, pm = _pair(lambda k: _mlp(k, steps=steps), x)
    kept = []

    class Keep(pk.callbacks.Callback):
        def on_epoch_end(self, epoch, logs=None):
            kept.append(dict(self.model.ffmodel._multi_steps))

    hj = jm.fit(x, y, epochs=8)
    hp = pm.fit(x, y, epochs=8, callbacks=[Keep()])
    _same_losses(hj, hp, ("loss", "accuracy"))
    assert hp.history["accuracy"][-1] > 0.8
    assert hp.history["loss"][-1] < hp.history["loss"][0]
    if steps == 4:
        assert [list(d) for d in kept] == [[4]] * 8
        assert len({id(d[4]) for d in kept}) == 1
    else:
        assert kept == [{}] * 8


def test_sequential_cnn_like_jax():
    rng = np.random.RandomState(0)
    x = rng.rand(16, 3, 8, 8).astype(np.float32)
    y = rng.randint(0, 2, size=(16, 1)).astype(np.int32)

    def build(k):
        L = k.layers
        m = k.models.Sequential()
        m.add(L.Conv2D(filters=4, input_shape=(3, 8, 8), kernel_size=(3, 3),
                       strides=(1, 1), padding=(1, 1), activation="relu"))
        m.add(L.MaxPooling2D(pool_size=(2, 2), strides=(2, 2),
                             padding="valid"))
        m.add(L.Flatten())
        m.add(L.Dense(2))
        m.add(L.Activation("softmax"))
        m.compile(optimizer="sgd", loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"], ffconfig=small_config(k))
        return m

    jm, pm = _pair(build, x)
    _same_losses(jm.fit(x, y, epochs=3), pm.fit(x, y, epochs=3))


def test_functional_model_merge_like_jax():
    rng = np.random.RandomState(1)
    xa = rng.rand(32, 10).astype(np.float32)
    xb = rng.rand(32, 10).astype(np.float32)
    y = rng.randint(0, 3, size=(32, 1)).astype(np.int32)

    def build(k):
        L = k.layers
        a, b = L.Input(shape=(10,)), L.Input(shape=(10,))
        ha = L.Dense(8, activation="relu")(a)
        hb = L.Dense(8, activation="relu")(b)
        merged = L.Concatenate(axis=1)([ha, hb])
        out = L.Dense(3, activation="softmax")(merged)
        m = k.models.Model(inputs=[a, b], outputs=out)
        m.compile(optimizer=k.optimizers.Adam(learning_rate=0.01),
                  loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"], ffconfig=small_config(k))
        return m

    jm, pm = _pair(build, [xa, xb])
    hj, hp = jm.fit([xa, xb], y, epochs=2), pm.fit([xa, xb], y, epochs=2)
    assert len(hp.history["loss"]) == 2
    _same_losses(hj, hp)
    assert pm.summary() == jm.summary()
    assert "Total params" in pm.summary()


def test_residual_add_like_jax():
    x = np.random.RandomState(2).rand(16, 16).astype(np.float32)
    y = np.zeros((16, 1), dtype=np.int32)

    def build(k):
        L = k.layers
        a = L.Input(shape=(16,))
        h = L.Dense(16, activation="relu")(a)
        res = L.Add()([a, h])
        out = L.Dense(2, activation="softmax")(res)
        m = k.models.Model(inputs=a, outputs=out)
        m.compile(optimizer="sgd", loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"], ffconfig=small_config(k))
        return m

    jm, pm = _pair(build, x)
    _same_losses(jm.fit(x, y, epochs=3), pm.fit(x, y, epochs=3))


def test_embedding_sequential_like_jax():
    x = np.random.RandomState(3).randint(0, 100, size=(16, 12)).astype(
        np.int32)
    y = np.random.RandomState(4).randint(0, 4, size=(16, 1)).astype(np.int32)

    def build(k):
        L = k.layers
        m = k.models.Sequential()
        m.add(L.Embedding(100, 8, input_shape=(12,)))
        m.add(L.Flatten())
        m.add(L.Dense(4, activation="softmax"))
        m.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"], ffconfig=small_config(k))
        return m

    jm, pm = _pair(build, x)
    _same_losses(jm.fit(x, y, epochs=3), pm.fit(x, y, epochs=3))


def test_lr_scheduler_and_early_stop_like_jax():
    x, y = separable_data(n=64)
    lrs = {"jax": [], "torch": []}

    def run(k, key, m):
        def schedule(epoch):
            lr = 0.1 * (0.5 ** epoch)
            lrs[key].append(lr)
            return lr

        cb = k.callbacks.LearningRateScheduler(schedule)
        stop = k.callbacks.EpochVerifyMetrics(10.0)  # stop once acc >= 10%
        return m.fit(x, y, epochs=6, callbacks=[cb, stop])

    jm, pm = _pair(lambda k: _mlp(k, hidden=16), x)
    hj, hp = run(jk, "jax", jm), run(pk, "torch", pm)
    assert lrs["torch"] == lrs["jax"] and len(lrs["torch"]) >= 1
    assert len(hp.epoch) < 6  # early stop triggered
    _same_losses(hj, hp)
    # the rate set in place on the device scalar the update reads
    assert float(pm.ffmodel.opt_state["lr"]) == pytest.approx(
        lrs["torch"][-1])


def test_predict_and_weights_roundtrip_like_jax():
    x, _ = separable_data(n=32)
    jm, pm = _pair(lambda k: _mlp(k, hidden=8), x)
    pred = pm.predict(x)
    assert pred.shape == (32, 4)
    w = pm.get_weights()
    pm.set_weights([np.zeros_like(a) for a in w])
    assert float(np.abs(pm.get_weights()[0]).sum()) == 0.0
    np.testing.assert_allclose(pm.predict(x), 0.25, atol=1e-7)
    pm.set_weights(w)
    np.testing.assert_array_equal(pm.predict(x), pred)
    for a, b in zip(pm.get_weights(), jm.get_weights()):
        np.testing.assert_array_equal(a, b)


def test_regularizer_increases_loss_like_jax():
    x, y = separable_data(n=32)

    def loss(reg):
        def build(k):
            r = k.regularizers.L2(10.0) if reg else None
            return _mlp(k, hidden=8, reg=r, metrics=(),
                        opt=k.optimizers.SGD(learning_rate=0.0))

        jm, pm = _pair(build, x)
        lj = jm.fit(x, y, epochs=1).history["loss"][0]
        lp = pm.fit(x, y, epochs=1).history["loss"][0]
        np.testing.assert_allclose(lp, lj, rtol=LOSS_RTOL)
        return lp

    base, reg = loss(False), loss(True)
    assert reg > base


def test_datasets_and_utils_equal_jax():
    """Host numpy: the same arrays as JAX's, bit for bit (the synthetic
    data, or the same cached files: both packages' caches resolve to
    the same directories)."""
    from flexflow_tpu.keras.datasets import _synthetic as js
    from flexflow_tpu_torch.keras.datasets import _synthetic as ps

    assert [os.path.realpath(d) for d in ps._CACHE_DIRS] == \
        [os.path.realpath(d) for d in js._CACHE_DIRS]
    for load in (lambda k: k.datasets.mnist.load_data(),
                 lambda k: k.datasets.cifar10.load_data(num_samples=100),
                 lambda k: k.datasets.reuters.load_data()):
        (pxt, pyt), (pxv, pyv) = load(pk)
        (jxt, jyt), (jxv, jyv) = load(jk)
        for a, b in ((pxt, jxt), (pyt, jyt), (pxv, jxv), (pyv, jyv)):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert all(np.array_equal(u, v) for u, v in zip(a, b))
    (xt, _), _ = pk.datasets.mnist.load_data()
    assert xt.shape[1:] == (28, 28) and xt.dtype == np.uint8
    (xc, yc), _ = pk.datasets.cifar10.load_data(num_samples=100)
    assert xc.shape == (100, 3, 32, 32) and yc.shape == (100, 1)

    oh = pk.utils.to_categorical([0, 2, 1], 3)
    assert oh.shape == (3, 3) and oh[1, 2] == 1
    np.testing.assert_array_equal(pk.utils.to_categorical([3, 0, 1]),
                                  jk.utils.to_categorical([3, 0, 1]))
    seqs = [[1, 2], [3], [4, 5, 6, 7, 8], []]
    for kw in ({"maxlen": 4}, {"maxlen": 3, "padding": "post",
                               "truncating": "post"}, {}):
        np.testing.assert_array_equal(
            pk.preprocessing.sequence.pad_sequences(seqs, **kw),
            jk.preprocessing.sequence.pad_sequences(seqs, **kw))
    texts = ["hello world", "hello there, world!", "a b c a"]
    toks = []
    for k in (pk, jk):
        tok = k.preprocessing.text.Tokenizer(num_words=6, oov_token="?")
        tok.fit_on_texts(texts)
        sq = tok.texts_to_sequences(["hello world", "zzz a"])
        toks.append((tok.word_index, sq, [
            tok.sequences_to_matrix(sq, mode=m).tolist()
            for m in ("binary", "count", "freq", "tfidf")]))
    assert toks[0] == toks[1]
    assert len(toks[0][1][0]) == 2


def test_model_checkpoint_callback_across_packages(tmp_path):
    """The port's ModelCheckpoint writes the JAX package's format: JAX
    restores the port's epoch-1 file (step 1) to the port's weights."""
    from flexflow_tpu.runtime.checkpoint import restore_checkpoint as jrest
    from flexflow_tpu_torch.runtime.checkpoint import restore_checkpoint

    x, y = separable_data(n=32)
    jm, pm = _pair(lambda k: _mlp(k, hidden=8))
    path = str(tmp_path / "ckpt_{epoch}")
    pm.fit(x, y, epochs=2, callbacks=[pk.callbacks.ModelCheckpoint(path)])
    assert os.path.exists(str(tmp_path / "ckpt_0.npz"))
    assert os.path.exists(str(tmp_path / "ckpt_1.npz"))
    assert restore_checkpoint(str(tmp_path / "ckpt_1"), pm.ffmodel) == 1
    assert jrest(str(tmp_path / "ckpt_1"), jm.ffmodel) == 1
    for a, b in zip(jm.get_weights(), pm.get_weights()):
        np.testing.assert_array_equal(a, b)


def test_stable_layer_names_like_jax():
    def names(k):
        m = k.models.Sequential()
        m.add(k.layers.Dense(8, activation="relu", input_shape=(20,)))
        m.add(k.layers.Dense(4, activation="softmax"))
        m.compile(optimizer="sgd", loss="sparse_categorical_crossentropy",
                  metrics=[], ffconfig=small_config(k))
        return sorted(m.ffmodel.params.keys()), _ops(m)

    with unoptimised_xla():
        want = names(jk)
    first, second = names(pk), names(pk)
    assert first == second == want


def test_bfloat16_checkpoint_from_jax(tmp_path):
    """A JAX checkpoint holding a bf16 weight (test_keras.py's forced bf16
    param) restores into the port's keras model at its step, the value
    widened to the port's f32 master; the port's checkpoint of it
    restores into JAX's model."""
    import jax.numpy as jnp
    from flexflow_tpu.runtime.checkpoint import restore_checkpoint as jrest
    from flexflow_tpu.runtime.checkpoint import save_checkpoint as jsave
    from flexflow_tpu_torch.runtime.checkpoint import (restore_checkpoint,
                                                       save_checkpoint)

    jm, pm = _pair(lambda k: _mlp(k, hidden=8, metrics=()))
    fm = jm.ffmodel
    op = sorted(fm.params)[0]
    w = sorted(fm.params[op])[0]
    orig = fm.params[op][w]
    fm.params[op][w] = orig.astype(jnp.bfloat16)
    jsave(str(tmp_path / "bf16"), fm, step=3)
    assert restore_checkpoint(str(tmp_path / "bf16"), pm.ffmodel) == 3
    got = pm.ffmodel.params[op][w]
    assert str(got.dtype) == "torch.float32"
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(orig.astype(jnp.bfloat16), np.float32))
    save_checkpoint(str(tmp_path / "back"), pm.ffmodel, step=4)
    fm.params[op][w] = orig
    assert jrest(str(tmp_path / "back"), fm) == 4
    np.testing.assert_array_equal(np.asarray(fm.params[op][w], np.float32),
                                  got.numpy())


def test_same_padding_stride_aware_like_jax():
    from flexflow_tpu.keras.layers.convolutional import _padding as jpad
    from flexflow_tpu_torch.keras.layers.convolutional import _padding

    assert _padding("same", (2, 2), (2, 2)) == (0, 0)
    assert _padding("same", (3, 3), (1, 1)) == (1, 1)
    for pad in ("same", "valid", 2, (1, 3)):
        for kern in ((1, 1), (2, 3), (3, 3), (5, 4)):
            for stride in ((1, 1), (2, 2), (3, 1)):
                assert _padding(pad, kern, stride) == jpad(pad, kern, stride)
    for pad in ("same", "valid"):
        shape = [(None, 4, 8, 8)]
        assert pk.layers.MaxPooling2D(
            pool_size=(2, 2), strides=(2, 2), padding=pad
        ).compute_output_shape(shape) == jk.layers.MaxPooling2D(
            pool_size=(2, 2), strides=(2, 2), padding=pad
        ).compute_output_shape(shape)
    pool = pk.layers.MaxPooling2D(pool_size=(2, 2), strides=(2, 2),
                                  padding="same")
    assert pool.compute_output_shape([(None, 4, 8, 8)]) == (None, 4, 4, 4)


def test_remaining_layers_like_jax():
    """The layers the scenarios above do not reach, in one functional
    model: Reshape, Permute, LayerNormalization, BatchNormalization,
    AveragePooling2D, Subtract, Multiply, Maximum, Minimum, Dropout
    (rate 0), Dense with an ELU epilogue and the keras initializers;
    3 SGD epochs."""
    rng = np.random.RandomState(5)
    x = rng.rand(16, 48).astype(np.float32)
    y = rng.randint(0, 3, size=(16, 1)).astype(np.int32)

    def build(k):
        L, I = k.layers, k.initializers
        a = L.Input(shape=(48,))
        h = L.Reshape((3, 4, 4))(a)
        h = L.BatchNormalization()(h)
        h = L.AveragePooling2D(pool_size=(2, 2))(h)
        h = L.Permute((2, 3, 1))(h)
        h = L.Flatten()(h)
        h = L.LayerNormalization()(h)
        u = L.Dense(8, activation="elu",
                    kernel_initializer=I.RandomUniform(-0.3, 0.3),
                    bias_initializer=I.Constant(0.1))(h)
        v = L.Dense(8, activation="tanh",
                    kernel_initializer=I.RandomNormal(0.0, 0.2),
                    bias_initializer="zeros")(h)
        d = L.Dropout(0.0)(u)
        m = L.Maximum()([L.Subtract()([d, v]), L.Multiply()([u, v])])
        m = L.Minimum()([m, L.Add()([u, v])])
        out = L.Dense(3, activation="softmax",
                      kernel_initializer=I.GlorotUniform(seed=3))(m)
        model = k.models.Model(inputs=a, outputs=out)
        model.compile(optimizer=k.optimizers.SGD(learning_rate=0.05),
                      loss="sparse_categorical_crossentropy",
                      metrics=["accuracy"], ffconfig=small_config(k))
        return model

    jm, pm = _pair(build, x)
    _same_losses(jm.fit(x, y, epochs=3), pm.fit(x, y, epochs=3))
