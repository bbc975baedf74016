"""The model zoo on the CPU (ROADMAP A6): every builder the port has, at
tests/test_models.py's sizes, built in both packages from the same
builder code, the port given the JAX model's weights (`params_from_jax`),
then two SGD steps (lr 0.01, f32) on the same seeded numpy batch: each
step's loss and every weight after the two steps against JAX's. Also the
op and weight names and shapes of the two graphs, the builders too large
for a CPU step (ResNeXt-50, Inception-v3) at full size, and the
pipeline transformer's names (held against JAX in
tests/test_torch_pipeline.py; the MoE builders are held against JAX in
tests/test_torch_moe.py).

Tolerance: f32, the same math through another BLAS / convolution and
summation order: losses rel 1e-5, weights rtol 1e-4 / atol 1e-6 (a
conv stack's gradients sum over thousands of products in another
order)."""
import contextlib

import jax
import numpy as np
import pytest
import torch

import flexflow_tpu as ff
import flexflow_tpu_torch as pt
from flexflow_tpu import models as jzoo
from flexflow_tpu_torch import models as pzoo

LOSS_REL = 1e-5
W_TOL = dict(rtol=1e-4, atol=1e-6)


def one_torch_thread():
    """Generator behind the zoo and op-set modules' module-scoped fixture
    (`pytest.fixture(scope="module", autouse=True)(one_torch_thread)`):
    torch on one intra-op thread for the module. These models' CPU ops
    are small, and on many threads each spends most of its time handing
    work between them; the results differ at most by the summation
    order the tolerances allow."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_one_thread = pytest.fixture(scope="module", autouse=True)(one_torch_thread)


@contextlib.contextmanager
def unoptimised_xla():
    """XLA's optimisations off while a JAX model compiles (draws its
    initial weights): each weight shape's random draw is an XLA compile
    of its own, several times cheaper unoptimised. The training steps
    compile later, optimised as usual."""
    prev = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        yield
    finally:
        jax.config.update("jax_disable_most_optimizations", prev)


def _zoo(pkg):
    return jzoo if pkg is ff else pzoo


def _config(pkg, batch):
    if pkg is pt:
        return pt.FFConfig(batch_size=batch, allow_mixed_precision=False,
                           device="cpu")
    config = ff.FFConfig()
    config.num_devices = 1
    config.batch_size = batch
    config.allow_mixed_precision = False
    return config


def _image(builder, chans, size, batch=4, **kw):
    def build(pkg, m):
        t = m.create_tensor([batch, chans, size, size])
        getattr(_zoo(pkg), builder)(m, t, **kw)

    def data(rng):
        return [rng.randn(batch, chans, size, size).astype(np.float32)], \
            rng.randint(0, 10, size=(batch, 1)).astype(np.int32)

    return build, data, batch


def _dlrm(interaction, bag):
    batch = 8

    def cfg(pkg):
        return _zoo(pkg).DLRMConfig(
            sparse_feature_size=8, embedding_size=[100, 100],
            embedding_bag_size=bag, mlp_bot=[4, 16, 8], mlp_top=[8, 16, 2],
            arch_interaction_op=interaction)

    def build(pkg, m):
        c = cfg(pkg)
        dense = m.create_tensor([batch, 4])
        sparse = [m.create_tensor([batch, bag], pkg.DataType.DT_INT32)
                  for _ in c.embedding_size]
        _zoo(pkg).build_dlrm(m, dense, sparse, c)

    def data(rng):
        return [rng.randn(batch, 4).astype(np.float32)] + [
            rng.randint(0, 100, size=(batch, bag)).astype(np.int32)
            for _ in range(2)], \
            rng.randint(0, 2, size=(batch, 1)).astype(np.int32)

    return build, data, batch


def _xdl():
    batch = 8

    def build(pkg, m):
        c = _zoo(pkg).XDLConfig(sparse_feature_size=8,
                                embedding_size=[100, 100, 100])
        sparse = [m.create_tensor([batch, 1], pkg.DataType.DT_INT32)
                  for _ in c.embedding_size]
        _zoo(pkg).build_xdl(m, sparse, c)

    def data(rng):
        return [rng.randint(0, 100, size=(batch, 1)).astype(np.int32)
                for _ in range(3)], \
            rng.randint(0, 2, size=(batch, 1)).astype(np.int32)

    return build, data, batch


def _candle_uno():
    batch = 4
    feats = {"dose1": 1, "cell.rnaseq": 942, "drug1.descriptors": 5270}

    def build(pkg, m):
        c = _zoo(pkg).CandleUnoConfig(dense_layers=[32, 32],
                                      dense_feature_layers=[32, 32])
        ins = {k: m.create_tensor([batch, d]) for k, d in feats.items()}
        _zoo(pkg).build_candle_uno(m, ins, c)

    def data(rng):
        return [rng.randn(batch, d).astype(np.float32)
                for d in feats.values()], \
            rng.randn(batch, 1).astype(np.float32)

    return build, data, batch


def _mlp_unify():
    batch = 8

    def build(pkg, m):
        a = m.create_tensor([batch, 16])
        b = m.create_tensor([batch, 16])
        _zoo(pkg).build_mlp_unify(m, a, b, hidden_dims=(32, 32))

    def data(rng):
        return [rng.randn(batch, 16).astype(np.float32) for _ in range(2)], \
            rng.randint(0, 32, size=(batch, 1)).astype(np.int32)

    return build, data, batch


def _transformer():
    batch = 2

    def build(pkg, m):
        c = _zoo(pkg).TransformerConfig(hidden_size=32, embedding_size=32,
                                        num_heads=4, num_layers=2,
                                        sequence_length=8)
        _zoo(pkg).build_transformer(m, m.create_tensor([batch, 8, 32]), c)

    def data(rng):
        return [rng.randn(batch, 8, 32).astype(np.float32)], \
            rng.randint(0, 2, size=(batch, 8, 1)).astype(np.int32)

    return build, data, batch


def _nmt(layers=2, hidden=16):
    batch, seq = 2, 6

    def build(pkg, m):
        src = m.create_tensor([batch, seq], pkg.DataType.DT_INT32)
        tgt = m.create_tensor([batch, seq], pkg.DataType.DT_INT32)
        _zoo(pkg).build_lstm_nmt(m, src, tgt, src_vocab=50, tgt_vocab=50,
                                 embed_dim=8, hidden_size=hidden,
                                 num_layers=layers)

    def data(rng):
        return [rng.randint(0, 50, size=(batch, seq)).astype(np.int32)
                for _ in range(2)], \
            rng.randint(0, 50, size=(batch, seq, 1)).astype(np.int32)

    return build, data, batch


def _mnist_mlp():
    batch = 8

    def build(pkg, m):
        _zoo(pkg).build_mnist_mlp(m, m.create_tensor([batch, 784]))

    def data(rng):
        return [rng.randn(batch, 784).astype(np.float32)], \
            rng.randint(0, 10, size=(batch, 1)).astype(np.int32)

    return build, data, batch


BUILDERS = {
    "mnist_mlp": _mnist_mlp(),
    "mnist_cnn": _image("build_mnist_cnn", 1, 28),
    "cifar10_cnn": _image("build_cifar10_cnn", 3, 32),
    "alexnet": _image("build_alexnet", 3, 128),
    "resnet": _image("build_resnet", 3, 64, stages=(1, 1)),
    "dlrm_cat": _dlrm("cat", 1),
    "dlrm_cat_bag4": _dlrm("cat", 4),
    "dlrm_dot": _dlrm("dot", 1),
    "xdl": _xdl(),
    "candle_uno": _candle_uno(),
    "mlp_unify": _mlp_unify(),
    "transformer": _transformer(),
    "lstm_nmt": _nmt(),
}


def _compile(pkg, build, batch):
    m = pkg.FFModel(_config(pkg, batch))
    build(pkg, m)
    regress = m.ops[-1].op_type.value == "linear"
    loss = ("LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE" if regress
            else "LOSS_SPARSE_CATEGORICAL_CROSSENTROPY")
    with unoptimised_xla() if pkg is ff else contextlib.nullcontext():
        m.compile(optimizer=pkg.SGDOptimizer(m, lr=0.01),
                  loss_type=getattr(pkg.LossType, loss))
    return m


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_two_sgd_steps_match_jax(name):
    build, data, batch = BUILDERS[name]
    jm = _compile(ff, build, batch)
    pm = _compile(pt, build, batch)
    pt.params_from_jax(pm, jm.params)
    rng = np.random.RandomState(0)
    for step in range(2):
        xs, y = data(rng)
        jl = jm.fit(xs, y, batch_size=batch, epochs=1)[0]["loss"]
        pl = pm.fit(xs, y, batch_size=batch, epochs=1)[0]["loss"]
        assert np.isfinite(pl)
        assert pl == pytest.approx(jl, rel=LOSS_REL), step
    for op, ws in jm.params.items():
        for w, v in ws.items():
            np.testing.assert_allclose(pm.params[op][w].numpy(),
                                       np.asarray(v), err_msg=f"{op}/{w}",
                                       **W_TOL)


def _graph(pkg, build, batch):
    m = pkg.FFModel(_config(pkg, batch))
    build(pkg, m)
    ops = [(op.name, op.op_type.value, [t.dims for t in op.outputs])
           for op in m.ops]
    weights = {op.name: {ws.name: tuple(ws.dims) for ws in
                         (op.specs if pkg is pt else
                          [w._weight_spec for w in op.weights])}
               for op in m.ops}
    return ops, weights


FULL_SIZE = {
    "resnext50": _image("build_resnext50", 3, 64, batch=2, num_classes=10,
                        groups=4),
    "inception_v3": _image("build_inception_v3", 3, 299, batch=2),
    "resnet50": _image("build_resnet50", 3, 224, batch=2),
    "alexnet_224": _image("build_alexnet", 3, 224, batch=2),
    "nmt_defaults": (lambda pkg, m: _zoo(pkg).build_lstm_nmt(
        m, m.create_tensor([4, 24], pkg.DataType.DT_INT32),
        m.create_tensor([4, 24], pkg.DataType.DT_INT32)), None, 4),
}


@pytest.mark.parametrize("name", sorted(FULL_SIZE))
def test_graph_matches_jax(name):
    """The same builder in both packages gives the same ops (name, type,
    output dims, in order) and the same weights (name, shape)."""
    build, _, batch = FULL_SIZE[name]
    assert _graph(pt, build, batch) == _graph(ff, build, batch)


@pytest.mark.parametrize("name", ["pipeline_transformer",
                                  "init_pipeline_params",
                                  "sequential_forward", "pipeline_forward"])
def test_unported_builders_raise(name):
    """The pipeline transformer is ported (tests/test_torch_pipeline.py):
    its module, as in the JAX package, and its names through the zoo
    package; it is not in `__all__`, as JAX's is not."""
    from flexflow_tpu_torch.models import pipeline_transformer as ptx

    got = getattr(pzoo, name)
    assert got is (ptx if name == "pipeline_transformer"
                   else getattr(ptx, name))
    assert name not in pzoo.__all__


def test_zoo_exports_the_jax_builders():
    """Every builder JAX exports is in the port's zoo."""
    assert set(jzoo.__all__) == set(pzoo.__all__)
