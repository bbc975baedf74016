"""The ONNX importer of flexflow_tpu_torch on the CPU (ROADMAP A11):
tests/test_onnx_frontend.py's cases through the port, and the port held
against the JAX package on the same files.

Against the JAX package:
 - `wire.make_model` writes the same bytes for the same arguments
   (identical);
 - one .onnx file imported by both packages builds the same op names and
   types, and predicts the same in f32 within 1e-5;
 - every transferred weight equals its initializer (identical), which
   holds the port's in-place copy (`Op.set_weight`) against the silent
   no-op an assignment into `FFModel.params` would be.
Model files are authored with the port's wire codec; inputs come from
seeded numpy generators."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import flexflow_tpu as jff
import flexflow_tpu_torch as ff
from flexflow_tpu.onnx import ONNXModel as JaxONNXModel
from flexflow_tpu.onnx import wire as jax_wire
from flexflow_tpu_torch.onnx import ONNXModel, wire
from tests.test_torch_zoo import one_torch_thread

_one_thread = pytest.fixture(scope="module", autouse=True)(one_torch_thread)

try:
    import onnx

    HAS_ONNX = True
except ImportError:
    HAS_ONNX = False

# f32 through two BLAS orders: a few ulps
F32_TOL = dict(atol=1e-5, rtol=1e-5)


def _mlp_bytes():
    rng = np.random.RandomState(0)
    w1 = rng.randn(20, 32).astype(np.float32)
    w2 = rng.randn(32, 4).astype(np.float32)
    nodes = [
        wire.make_node("MatMul", ["x", "w1"], ["h"], name="fc1"),
        wire.make_node("Relu", ["h"], ["hr"], name="relu1"),
        wire.make_node("MatMul", ["hr", "w2"], ["y"], name="fc2"),
    ]
    proto = wire.make_model(nodes, {"x": (8, 20)}, {"y": (8, 4)},
                            {"w1": w1, "w2": w2}, name="mlp")
    return proto, w1, w2


def _conv_graph(w):
    """Conv with pads and strides, a max pool, a Gemm head (transB, alpha,
    beta) and a softmax."""
    rng = np.random.RandomState(1)
    k = rng.randn(4, 2, 3, 3).astype(np.float32) * 0.2
    kb = rng.randn(4).astype(np.float32) * 0.1
    gw = rng.randn(5, 4 * 2 * 2).astype(np.float32) * 0.2
    gb = rng.randn(5).astype(np.float32) * 0.1
    nodes = [
        w.make_node("Conv", ["x", "k", "kb"], ["c"], name="conv1",
                    kernel_shape=[3, 3], strides=[2, 2], pads=[1, 1, 1, 1]),
        w.make_node("Relu", ["c"], ["cr"], name="r1"),
        w.make_node("MaxPool", ["cr"], ["p"], name="pool1",
                    kernel_shape=[2, 2], strides=[2, 2]),
        w.make_node("Flatten", ["p"], ["f"], name="flat1"),
        w.make_node("Gemm", ["f", "gw", "gb"], ["g"], name="head",
                    transB=1, alpha=0.5, beta=2.0),
        w.make_node("Softmax", ["g"], ["y"], name="sm", axis=-1),
    ]
    return w.make_model(nodes, {"x": (2, 2, 8, 8)}, {"y": (2, 5)},
                        {"k": k, "kb": kb, "gw": gw, "gb": gb}, name="conv")


def _attention_graph(w, batch=2, seq=8, hidden=16, heads=2):
    """One attention block with a residual and an FFN: MatMul, Add,
    Reshape, Transpose, Div, Softmax, Gelu; shape initializers in int64."""
    rng = np.random.RandomState(2)
    hd = hidden // heads

    def mat(*s):
        return (rng.randn(*s) * 0.2).astype(np.float32)

    inits = {"wq": mat(hidden, hidden), "wk": mat(hidden, hidden),
             "wv": mat(hidden, hidden), "wo": mat(hidden, hidden),
             "w1": mat(hidden, 4 * hidden), "w2": mat(4 * hidden, hidden),
             "heads_shape": np.array([batch, seq, heads, hd], np.int64),
             "merge_shape": np.array([0, 0, -1], np.int64),
             "scale": np.array(np.sqrt(hd), np.float32)}
    n = []
    for p in ("q", "k", "v"):
        n += [w.make_node("MatMul", ["x", f"w{p}"], [p], name=f"proj_{p}"),
              w.make_node("Reshape", [p, "heads_shape"], [f"{p}4"],
                          name=f"split_{p}")]
    n += [w.make_node("Transpose", ["q4"], ["qh"], name="qT",
                      perm=[0, 2, 1, 3]),
          w.make_node("Transpose", ["k4"], ["kh"], name="kT",
                      perm=[0, 2, 3, 1]),
          w.make_node("Transpose", ["v4"], ["vh"], name="vT",
                      perm=[0, 2, 1, 3]),
          w.make_node("MatMul", ["qh", "kh"], ["s"], name="scores"),
          w.make_node("Div", ["s", "scale"], ["ss"], name="scaled"),
          w.make_node("Softmax", ["ss"], ["pr"], name="probs", axis=-1),
          w.make_node("MatMul", ["pr", "vh"], ["ctx"], name="context"),
          w.make_node("Transpose", ["ctx"], ["ctxT"], name="ctxT",
                      perm=[0, 2, 1, 3]),
          w.make_node("Reshape", ["ctxT", "merge_shape"], ["m"],
                      name="merge"),
          w.make_node("MatMul", ["m", "wo"], ["o"], name="out_proj"),
          w.make_node("Add", ["x", "o"], ["r1"], name="residual1"),
          w.make_node("MatMul", ["r1", "w1"], ["f1"], name="ffn1"),
          w.make_node("Gelu", ["f1"], ["g"], name="gelu"),
          w.make_node("MatMul", ["g", "w2"], ["f2"], name="ffn2"),
          w.make_node("Add", ["r1", "f2"], ["y"], name="residual2")]
    return w.make_model(n, {"x": (batch, seq, hidden)},
                        {"y": (batch, seq, hidden)}, inits, name="attn")


def _misc_graph(w):
    """Split, Concat, ReduceMean, ReduceSum, Mul / Sub by a scalar, Tanh,
    Sigmoid, Identity, Dropout, AveragePool and GlobalAveragePool."""
    rng = np.random.RandomState(3)
    k = (rng.randn(6, 3, 3, 3) * 0.2).astype(np.float32)
    nodes = [
        w.make_node("Conv", ["x", "k"], ["c"], name="conv",
                    kernel_shape=[3, 3], auto_pad="SAME_UPPER"),
        w.make_node("Split", ["c"], ["c0", "c1"], name="split", axis=1,
                    split=[2, 4]),
        w.make_node("Tanh", ["c0"], ["t0"], name="tanh"),
        w.make_node("Sigmoid", ["c1"], ["t1"], name="sig"),
        w.make_node("Concat", ["t0", "t1"], ["cc"], name="cat", axis=1),
        w.make_node("Mul", ["cc", "two"], ["m"], name="twice"),
        w.make_node("Sub", ["m", "half"], ["s"], name="shift"),
        w.make_node("Identity", ["s"], ["i"], name="ident"),
        w.make_node("Dropout", ["i"], ["d"], name="drop", ratio=0.1),
        w.make_node("AveragePool", ["d"], ["ap"], name="avg",
                    kernel_shape=[2, 2], strides=[2, 2]),
        w.make_node("GlobalAveragePool", ["ap"], ["gp"], name="gap"),
        w.make_node("ReduceSum", ["gp"], ["rs"], name="rsum", axes=[2, 3],
                    keepdims=0),
        w.make_node("ReduceMean", ["rs"], ["y"], name="rmean", axes=[1],
                    keepdims=1),
    ]
    return w.make_model(nodes, {"x": (2, 3, 8, 8)}, {"y": (2, 1)},
                        {"k": k, "two": np.array(2.0, np.float32),
                         "half": np.array(0.5, np.float32)}, name="misc")


def _embed_graph(w):
    """Gather over an embedding table, Cast and a mean over the sequence."""
    rng = np.random.RandomState(4)
    table = (rng.randn(50, 8) * 0.5).astype(np.float32)
    wd = (rng.randn(8, 3) * 0.5).astype(np.float32)
    nodes = [
        w.make_node("Gather", ["table", "ids"], ["e"], name="embed"),
        w.make_node("ReduceMean", ["e"], ["em"], name="pool", axes=[1],
                    keepdims=0),
        w.make_node("Cast", ["em"], ["ec"], name="cast", to=1),
        w.make_node("MatMul", ["ec", "wd"], ["y"], name="head"),
    ]
    return w.make_model(nodes, {"ids": (4, 6)}, {"y": (4, 3)},
                        {"table": table, "wd": wd}, name="embed")


GRAPHS = {"conv": _conv_graph, "attention": _attention_graph,
          "misc": _misc_graph, "embed": _embed_graph}
INPUTS = {"conv": [((2, 2, 8, 8), "float32")],
          "attention": [((2, 8, 16), "float32")],
          "misc": [((2, 3, 8, 8), "float32")],
          "embed": [((4, 6), "int32")]}


def _inputs(name, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for dims, dt in INPUTS[name]:
        out.append(rng.randint(0, 50, size=dims).astype(np.int32)
                   if dt == "int32" else rng.randn(*dims).astype(np.float32))
    return out


def _port_import(proto, inputs, mixed=False):
    model = ff.FFModel(ff.FFConfig(batch_size=inputs[0][0][0],
                                   allow_mixed_precision=mixed,
                                   device="cpu"))
    ts = [model.create_tensor(list(d), ff.DataType.DT_INT32 if dt == "int32"
                              else ff.DataType.DT_FLOAT)
          for d, dt in inputs]
    om = ONNXModel(proto)
    model.final_tensor = om.apply(model, ts)[0]
    model.compile(optimizer=ff.SGDOptimizer(model, lr=0.0),
                  loss_type=ff.LossType.LOSS_IDENTITY)
    return model, om


def _jax_import(proto, inputs):
    config = jff.FFConfig()
    config.batch_size = inputs[0][0][0]
    config.allow_mixed_precision = False
    model = jff.FFModel(config)
    ts = [model.create_tensor(list(d), jff.DataType.DT_INT32
                              if dt == "int32" else jff.DataType.DT_FLOAT)
          for d, dt in inputs]
    om = JaxONNXModel(proto)
    model.final_tensor = om.apply(model, ts)[0]
    model.compile(optimizer=jff.SGDOptimizer(model, lr=0.0),
                  loss_type=jff.LossType.LOSS_IDENTITY)
    return model, om


# ---------------------------------------------------------------------
# tests/test_onnx_frontend.py's cases
# ---------------------------------------------------------------------
def test_module_imports_without_onnx():
    from flexflow_tpu_torch.onnx import ONNXModel, ONNXModelKeras  # noqa

    assert issubclass(ONNXModelKeras, ONNXModel)


def test_wire_codec_roundtrip():
    proto, w1, w2 = _mlp_bytes()
    m = wire.load(proto)
    assert [n.op_type for n in m.graph.node] == ["MatMul", "Relu", "MatMul"]
    inits = {t.name: wire.to_array(t) for t in m.graph.initializer}
    np.testing.assert_array_equal(inits["w1"], w1)
    np.testing.assert_array_equal(inits["w2"], w2)
    assert [i.name for i in m.graph.input] == ["x", "w1", "w2"]
    assert m.graph.input[0].dims == [8, 20]


@pytest.mark.skipif(not HAS_ONNX, reason="onnx not installed")
def test_wire_bytes_parse_with_real_onnx():
    """The wire encoder's output is schema-valid for the onnx package."""
    proto, w1, _ = _mlp_bytes()
    m = onnx.ModelProto()
    m.ParseFromString(proto)
    assert [n.op_type for n in m.graph.node] == ["MatMul", "Relu", "MatMul"]
    import onnx.numpy_helper as nph

    got = {t.name: nph.to_array(t) for t in m.graph.initializer}
    np.testing.assert_array_equal(got["w1"], w1)
    onnx.checker.check_model(m)


def test_onnx_mlp_roundtrip():
    """f32 against numpy within 1e-4 (JAX's tolerance)."""
    proto, w1, w2 = _mlp_bytes()
    model, om = _port_import(proto, [((8, 20), "float32")])
    assert om.transfer_weights(model) == 2
    x = np.random.RandomState(0).randn(8, 20).astype(np.float32)
    ref = np.maximum(x @ w1, 0) @ w2
    np.testing.assert_allclose(model.predict(x), ref, atol=1e-4, rtol=1e-4)


def test_onnx_conv_attrs_and_file_load(tmp_path):
    """Conv with pads/strides + MatMul head, loaded from a FILE path;
    against torch's conv within 1e-3 (JAX's tolerance)."""
    rng = np.random.RandomState(1)
    k = rng.randn(4, 2, 3, 3).astype(np.float32) * 0.2
    gw = rng.randn(4 * 4 * 4, 5).astype(np.float32) * 0.2
    nodes = [
        wire.make_node("Conv", ["x", "k"], ["c"], name="conv1",
                       kernel_shape=[3, 3], strides=[2, 2],
                       pads=[1, 1, 1, 1]),
        wire.make_node("Relu", ["c"], ["cr"], name="r1"),
        wire.make_node("Flatten", ["cr"], ["f"], name="flat1"),
        wire.make_node("MatMul", ["f", "gw"], ["y"], name="fc"),
    ]
    proto = wire.make_model(nodes, {"x": (2, 2, 8, 8)}, {"y": (2, 5)},
                            {"k": k, "gw": gw})
    path = str(tmp_path / "conv.onnx")
    wire.save(proto, path)
    model, om = _port_import(path, [((2, 2, 8, 8), "float32")])
    assert om.transfer_weights(model) == 2
    x = rng.randn(2, 2, 8, 8).astype(np.float32)
    ref_c = F.conv2d(torch.from_numpy(x), torch.from_numpy(k), stride=2,
                     padding=1).numpy()
    ref = np.maximum(ref_c, 0).reshape(2, -1) @ gw
    np.testing.assert_allclose(model.predict(x), ref, atol=1e-3, rtol=1e-3)


# ---------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------
@pytest.mark.parametrize("name", ["mlp", "conv", "attention", "misc",
                                  "embed"])
def test_make_model_bytes_equal_jax(name):
    if name == "mlp":
        rng = np.random.RandomState(0)
        w1 = rng.randn(20, 32).astype(np.float32)
        w2 = rng.randn(32, 4).astype(np.float32)
        ours = _mlp_bytes()[0]
        theirs = jax_wire.make_model(
            [jax_wire.make_node("MatMul", ["x", "w1"], ["h"], name="fc1"),
             jax_wire.make_node("Relu", ["h"], ["hr"], name="relu1"),
             jax_wire.make_node("MatMul", ["hr", "w2"], ["y"], name="fc2")],
            {"x": (8, 20)}, {"y": (8, 4)}, {"w1": w1, "w2": w2}, name="mlp")
    else:
        ours, theirs = GRAPHS[name](wire), GRAPHS[name](jax_wire)
    assert ours == theirs


def test_attribute_kinds_encode_like_jax():
    """Every attribute kind the encoder writes (float, int, string, tensor,
    floats, ints, empty ints) and every initializer dtype it keeps."""
    attrs = dict(f=0.25, i=-3, s="SAME_UPPER", b=b"raw",
                 t=np.arange(6, dtype=np.int64).reshape(2, 3),
                 fl=[0.5, -1.5], il=[1, -2, 3], empty=[])
    inits = {f"w_{dt}": np.arange(4).astype(dt) for dt in
             ("float32", "int32", "int64", "uint8", "int8", "float16",
              "float64", "bool")}
    ours = wire.make_model([wire.make_node("Op", ["a"], ["b"], **attrs)],
                           {"a": (4,)}, {"b": (4,)}, inits)
    theirs = jax_wire.make_model(
        [jax_wire.make_node("Op", ["a"], ["b"], **attrs)],
        {"a": (4,)}, {"b": (4,)}, inits)
    assert ours == theirs
    node = wire.load(ours).graph.node[0]
    got = {a.name: wire.get_attribute_value(a) for a in node.attribute}
    assert got["f"] == 0.25 and got["i"] == -3 and got["il"] == [1, -2, 3]
    np.testing.assert_array_equal(wire.to_array(got["t"]), attrs["t"])
    for t in wire.load(ours).graph.initializer:
        np.testing.assert_array_equal(wire.to_array(t), inits[t.name])


@pytest.mark.parametrize("name", ["conv", "attention", "misc", "embed"])
def test_same_file_same_graph_and_predictions_as_jax(name, tmp_path):
    """One file through both packages: the same op names and types, every
    transferred weight equal to its initializer, and f32 predictions
    within 1e-5."""
    path = str(tmp_path / f"{name}.onnx")
    wire.save(GRAPHS[name](wire), path)
    pm, pom = _port_import(path, INPUTS[name])
    jm, jom = _jax_import(path, INPUTS[name])
    assert [(op.name, op.op_type.value) for op in pm.ops] == \
        [(op.name, op.op_type.value) for op in jm.ops]
    n = pom.transfer_weights(pm)
    assert n == jom.transfer_weights(jm) == sum(
        len(v) for v in pom._pending_weights.values())
    params = pm.params
    for op_name, slot in pom._pending_weights.items():
        for key, arr in slot.items():
            np.testing.assert_array_equal(params[op_name][key].numpy(),
                                          np.asarray(arr, np.float32))
    x = _inputs(name)
    np.testing.assert_allclose(pm.predict(x), jm.predict(x), **F32_TOL)


def test_transfer_writes_in_place_and_reaches_predict():
    """The weights a predict reads are the ONNX ones, not the random
    init, and the tensor objects the model holds are the same ones."""
    proto, w1, w2 = _mlp_bytes()
    model, om = _port_import(proto, [((8, 20), "float32")])
    before = {op.name: op.w("kernel") for op in model.ops if op.specs}
    assert not np.array_equal(before["fc1"].detach().numpy(), w1)
    assert om.transfer_weights(model) == 2
    for op in model.ops:
        if op.specs:
            assert op.w("kernel") is before[op.name]
    np.testing.assert_array_equal(model.params["fc1"]["kernel"].numpy(), w1)
    np.testing.assert_array_equal(model.params["fc2"]["kernel"].numpy(), w2)


def test_scalar_on_the_left_computes_c_minus_t_and_c_over_t():
    """Sub and Div with the scalar initializer first: c - x and c / x, as
    numpy computes them."""
    nodes = [wire.make_node("Sub", ["three", "x"], ["a"], name="rsub"),
             wire.make_node("Div", ["two", "a"], ["y"], name="rdiv")]
    proto = wire.make_model(nodes, {"x": (4, 5)}, {"y": (4, 5)},
                            {"three": np.array(3.0, np.float32),
                             "two": np.array(2.0, np.float32)})
    model, _ = _port_import(proto, [((4, 5), "float32")])
    x = np.random.RandomState(5).rand(4, 5).astype(np.float32)
    np.testing.assert_allclose(model.predict(x), 2.0 / (3.0 - x), **F32_TOL)


def test_bf16_import_within_bf16_tolerance():
    """The repository's default: bf16 activations, against the f32 numpy
    MLP within 2e-2 of the output's scale."""
    proto, w1, w2 = _mlp_bytes()
    model, om = _port_import(proto, [((8, 20), "float32")], mixed=True)
    om.transfer_weights(model)
    x = np.random.RandomState(0).randn(8, 20).astype(np.float32)
    ref = np.maximum(x @ w1, 0) @ w2
    err = np.abs(model.predict(x) - ref).max()
    assert err <= 2e-2 * np.abs(ref).max(), err
