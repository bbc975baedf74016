"""The C model spec's loader in flexflow_tpu_torch on the CPU (ROADMAP
A11): tests/test_c_model_api.py's cases over the port's
`model_from_spec`, and the port held against the JAX package's loader on
the same spec.

The spec comes from the port's C API (its own libffcore, through ctypes
as a C program would link it) where `flexflow_tpu_torch.native.
ensure_built()` builds it (g++), else from the handwritten spec of
tests/test_serving.py. tests/test_c_model_api.py's cases also run on the
port's library itself: shape inference, the native search, the error
report, an exported spec trained by the port. Against the JAX package,
f32: predictions and three SGD losses within 1e-5 after the JAX model's
weights are carried across (`params_from_jax`)."""
import ctypes
import json

import numpy as np
import pytest

import flexflow_tpu as jff
import flexflow_tpu_torch as ff
from flexflow_tpu.native.c_model import model_from_spec as jax_from_spec
from flexflow_tpu_torch import native, params_from_jax
from flexflow_tpu_torch.native.c_model import model_from_spec
from tests.test_torch_zoo import one_torch_thread

_one_thread = pytest.fixture(scope="module", autouse=True)(one_torch_thread)

# f32, the same math through another BLAS order
F32_TOL = dict(atol=1e-5, rtol=1e-5)
LOSS_REL = 1e-5

# tests/test_serving.py's handwritten spec, widened to the C API MLP's
# shapes (x 8 x 32 -> 64 relu -> 16 -> softmax)
HANDWRITTEN = {
    "format": "flexflow_tpu_c_model",
    "config": {"batch_size": 8},
    "ops": [
        {"type": "input", "name": "x", "dims": [8, 32], "dtype": "float32",
         "inputs": [], "outputs": [1]},
        {"type": "dense", "name": "dense_0", "inputs": [1], "outputs": [2],
         "params": {"out_dim": 64, "activation": "relu"}},
        {"type": "dense", "name": "dense_1", "inputs": [2], "outputs": [3],
         "params": {"out_dim": 16}},
        {"type": "softmax", "name": "softmax_0", "inputs": [3],
         "outputs": [4], "params": {}},
    ],
}


def _lib():
    path = native.ensure_built()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    lib.ffc_model_create.argtypes = [ctypes.c_int]
    lib.ffc_model_create.restype = ctypes.c_void_p
    lib.ffc_model_destroy.argtypes = [ctypes.c_void_p]
    lib.ffc_model_last_error.argtypes = [ctypes.c_void_p]
    lib.ffc_model_last_error.restype = ctypes.c_char_p
    lib.ffc_tensor_create.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.POINTER(ctypes.c_int64),
                                      ctypes.c_char_p]
    lib.ffc_tensor_create.restype = ctypes.c_int64
    lib.ffc_op.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
                           ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p]
    lib.ffc_op.restype = ctypes.c_int64
    lib.ffc_tensor_ndims.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                     ctypes.POINTER(ctypes.c_int64),
                                     ctypes.c_int]
    lib.ffc_tensor_ndims.restype = ctypes.c_int
    lib.ffc_model_export_json.argtypes = [ctypes.c_void_p]
    lib.ffc_model_export_json.restype = ctypes.c_void_p
    lib.ffc_model_optimize.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_double]
    lib.ffc_model_optimize.restype = ctypes.c_void_p
    lib.ffc_free.argtypes = [ctypes.c_void_p]
    return lib


def _i64(vals):
    return (ctypes.c_int64 * len(vals))(*vals)


@pytest.fixture(scope="module")
def c_spec():
    """(spec, C-side output dims): the C API's MLP exported as JSON, or
    the handwritten spec where the native core does not build."""
    lib = _lib()
    if lib is None:
        return json.loads(json.dumps(HANDWRITTEN)), [8, 16]
    h = lib.ffc_model_create(8)
    x = lib.ffc_tensor_create(h, 2, _i64([8, 32]), b"float32")
    t = lib.ffc_op(h, b"dense", 1, _i64([x]), b"out_dim=64;activation=relu")
    assert t > 0, lib.ffc_model_last_error(h)
    t = lib.ffc_op(h, b"dense", 1, _i64([t]), b"out_dim=16")
    t = lib.ffc_op(h, b"softmax", 1, _i64([t]), b"")
    dims = (ctypes.c_int64 * 4)()
    n = lib.ffc_tensor_ndims(h, t, dims, 4)
    ptr = lib.ffc_model_export_json(h)
    spec = json.loads(ctypes.string_at(ptr).decode())
    lib.ffc_free(ptr)
    lib.ffc_model_destroy(h)
    return spec, list(dims[:n])


def _cpu(batch=None, mixed=False):
    return ff.FFConfig(allow_mixed_precision=mixed, device="cpu",
                       **({"batch_size": batch} if batch else {}))


def _jax_config():
    c = jff.FFConfig()
    c.num_devices = 1
    c.allow_mixed_precision = False
    return c


# ---------------------------------------------------------------------
# tests/test_c_model_api.py's cases
# ---------------------------------------------------------------------
def test_c_api_builds_infers_shapes_and_optimizes(c_spec):
    """The loaded graph's output has the shape the C side inferred; the
    batch override rewrites the input's leading dim."""
    spec, c_dims = c_spec
    assert spec["format"] == "flexflow_tpu_c_model"
    model = model_from_spec(spec, config=_cpu())
    assert list(model.ops[-1].outputs[0].dims) == c_dims
    assert sorted(model._c_tensors) == sorted(
        g for op in spec["ops"] for g in op["outputs"])
    big = model_from_spec(json.dumps(spec), config=_cpu(), batch_size=32)
    assert big.config.batch_size == 32
    assert list(big.input_ops[0].outputs[0].dims) == [32, 32]
    assert list(big.ops[-1].outputs[0].dims) == [32] + c_dims[1:]


def test_c_api_error_reporting(c_spec):
    """An op type or activation the loader does not know raises, naming
    it, as the C API reports `warp_drive` in its last error."""
    spec, _ = c_spec
    bad = json.loads(json.dumps(spec))
    bad["ops"].append({"type": "warp_drive", "name": "w", "inputs": [],
                       "outputs": [99]})
    with pytest.raises(NotImplementedError, match="warp_drive"):
        model_from_spec(bad, config=_cpu())
    bad = json.loads(json.dumps(spec))
    bad["ops"][1]["params"]["activation"] = "swish"
    with pytest.raises(ValueError, match="swish"):
        model_from_spec(bad, config=_cpu())
    with pytest.raises(AssertionError):
        model_from_spec({"format": "onnx", "ops": []}, config=_cpu())


def test_c_built_model_trains_in_python_runtime(c_spec, tmp_path):
    """The spec, from a FILE path, compiles with Adam and takes a finite
    training step in the port."""
    spec, _ = c_spec
    path = tmp_path / "spec.json"
    path.write_text(json.dumps(spec))
    model = model_from_spec(str(path), config=_cpu())
    model.compile(optimizer=ff.AdamOptimizer(model, alpha=1e-3),
                  loss_type=ff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                  metrics=[ff.MetricsType.METRICS_ACCURACY])
    x = np.random.RandomState(0).randn(8, 32).astype(np.float32)
    y = np.zeros((8, 1), dtype=np.int32)
    hist = model.fit([x], y, batch_size=8, epochs=1)
    assert np.isfinite(hist[0]["loss"])


# ---------------------------------------------------------------------
# tests/test_c_model_api.py's cases on the port's library
# ---------------------------------------------------------------------
def _take_string(lib, ptr):
    s = ctypes.string_at(ptr).decode()
    lib.ffc_free(ptr)
    return s


def _build_mlp(lib, batch=8):
    h = lib.ffc_model_create(batch)
    x = lib.ffc_tensor_create(h, 2, _i64([batch, 32]), b"float32")
    assert x > 0
    t = lib.ffc_op(h, b"dense", 1, _i64([x]), b"out_dim=64;activation=relu")
    assert t > 0, lib.ffc_model_last_error(h)
    t = lib.ffc_op(h, b"dense", 1, _i64([t]), b"out_dim=16")
    t = lib.ffc_op(h, b"softmax", 1, _i64([t]), b"")
    assert t > 0
    return h, t


def test_port_c_api_builds_infers_shapes_and_optimizes():
    lib = _lib()
    assert lib is not None, native.load_error()
    h, out = _build_mlp(lib)
    dims = (ctypes.c_int64 * 4)()
    n = lib.ffc_tensor_ndims(h, out, dims, 4)
    assert n == 2 and list(dims[:2]) == [8, 16]
    result = _take_string(lib, lib.ffc_model_optimize(h, 8, 4, 1.2))
    assert result.startswith("cost "), result
    assert "mesh " in result and "strategy " in result
    lib.ffc_model_destroy(h)


def test_port_c_api_error_reporting():
    lib = _lib()
    h = lib.ffc_model_create(8)
    bad = lib.ffc_op(h, b"warp_drive", 0, _i64([]), b"")
    assert bad == -1
    assert b"warp_drive" in lib.ffc_model_last_error(h)
    lib.ffc_model_destroy(h)


def test_port_c_built_model_trains_in_the_port():
    """The port's library exports the spec, the port's loader builds it,
    and one Adam epoch gives a finite loss."""
    lib = _lib()
    h, _ = _build_mlp(lib)
    spec = _take_string(lib, lib.ffc_model_export_json(h))
    lib.ffc_model_destroy(h)
    doc = json.loads(spec)
    assert doc["format"] == "flexflow_tpu_c_model"
    model = model_from_spec(doc, config=_cpu())
    model.compile(optimizer=ff.AdamOptimizer(model, alpha=1e-3),
                  loss_type=ff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                  metrics=[ff.MetricsType.METRICS_ACCURACY])
    x = np.random.RandomState(0).randn(8, 32).astype(np.float32)
    y = np.zeros((8, 1), dtype=np.int32)
    hist = model.fit([x], y, batch_size=8, epochs=1)
    assert np.isfinite(hist[0]["loss"])


# ---------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------
def test_predict_and_sgd_losses_equal_jax(c_spec):
    """The same spec through both loaders: the same op names and types;
    from JAX's weights, predictions within 1e-5 and three SGD steps'
    losses within 1e-5 relative, then the trained weights."""
    spec, _ = c_spec
    jm = jax_from_spec(spec, config=_jax_config())
    pm = model_from_spec(spec, config=_cpu())
    assert [(op.name, op.op_type.value) for op in pm.ops] == \
        [(op.name, op.op_type.value) for op in jm.ops]
    for m, pkg in ((jm, jff), (pm, ff)):
        m.compile(optimizer=pkg.SGDOptimizer(m, lr=0.1),
                  loss_type=pkg.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                  metrics=[])
    params_from_jax(pm, jm.params)
    rng = np.random.RandomState(1)
    x = rng.randn(8, 32).astype(np.float32)
    y = rng.randint(0, 16, size=(8, 1)).astype(np.int32)
    np.testing.assert_allclose(pm.predict(x), jm.predict(x), **F32_TOL)
    for step in range(3):
        jl = jm.fit([x], y, batch_size=8, epochs=1)[0]["loss"]
        pl = pm.fit([x], y, batch_size=8, epochs=1)[0]["loss"]
        assert np.isfinite(pl)
        assert pl == pytest.approx(jl, rel=LOSS_REL), step
    for op, ws in jm.params.items():
        for w, v in ws.items():
            np.testing.assert_allclose(pm.params[op][w].numpy(),
                                       np.asarray(v), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(pm.predict(x), jm.predict(x), **F32_TOL)


def test_every_op_kind_builds_like_jax():
    """Each op type the loader knows (but pool and conv, which the
    image spec below holds), in one spec: the same op names, types and
    output shapes as JAX's loader builds."""
    ops = [
        {"type": "input", "name": "x", "dims": [4, 6, 8],
         "dtype": "float32", "inputs": [], "outputs": [1]},
        {"type": "input", "name": "ids", "dims": [4, 6], "dtype": "int32",
         "inputs": [], "outputs": [2]},
        {"type": "embedding", "name": "emb", "inputs": [2], "outputs": [3],
         "params": {"num_entries": 20, "out_dim": 8}},
        {"type": "add", "name": "sum", "inputs": [1, 3], "outputs": [4]},
        {"type": "multihead_attention", "name": "attn", "inputs": [4],
         "outputs": [5], "params": {"embed_dim": 8, "num_heads": 2}},
        {"type": "layer_norm", "name": "ln", "inputs": [5], "outputs": [6]},
        {"type": "dense", "name": "fc", "inputs": [6], "outputs": [7],
         "params": {"out_dim": 8, "activation": "gelu"}},
        {"type": "subtract", "name": "sub", "inputs": [7, 6],
         "outputs": [8]},
        {"type": "multiply", "name": "mul", "inputs": [8, 6],
         "outputs": [9]},
        {"type": "batch_matmul", "name": "bmm", "inputs": [9, 10],
         "outputs": [11]},
        {"type": "dropout", "name": "drop", "inputs": [11], "outputs": [12],
         "params": {"rate": 0.1}},
        {"type": "tanh", "name": "th", "inputs": [12], "outputs": [13]},
        {"type": "concat", "name": "cat", "inputs": [13, 13],
         "outputs": [14], "params": {"axis": 2}},
        {"type": "flat", "name": "fl", "inputs": [14], "outputs": [15]},
        {"type": "softmax", "name": "sm", "inputs": [15], "outputs": [16]},
    ]
    # bmm's right operand: the LayerNorm output transposed is not a spec
    # op; a second input stands in for it
    ops.insert(2, {"type": "input", "name": "r", "dims": [4, 8, 6],
                   "dtype": "float32", "inputs": [], "outputs": [10]})
    spec = {"format": "flexflow_tpu_c_model", "config": {"batch_size": 4},
            "ops": ops}
    image = {"format": "flexflow_tpu_c_model", "config": {"batch_size": 2},
             "ops": [
                 {"type": "input", "name": "img", "dims": [2, 3, 8, 8],
                  "dtype": "float32", "inputs": [], "outputs": [1]},
                 {"type": "conv2d", "name": "conv", "inputs": [1],
                  "outputs": [2], "params": {
                      "out_channels": 4, "kernel_h": 3, "kernel_w": 3,
                      "stride_h": 1, "stride_w": 1, "padding_h": 1,
                      "padding_w": 1, "activation": "relu"}},
                 {"type": "batch_norm", "name": "bn", "inputs": [2],
                  "outputs": [3]},
                 {"type": "pool2d", "name": "pool", "inputs": [3],
                  "outputs": [4], "params": {
                      "kernel_h": 2, "kernel_w": 2, "stride_h": 2,
                      "stride_w": 2, "pool_type": "avg"}},
                 {"type": "sigmoid", "name": "sg", "inputs": [4],
                  "outputs": [5]},
                 {"type": "relu", "name": "rl", "inputs": [5],
                  "outputs": [6]},
                 {"type": "identity", "name": "idn", "inputs": [6],
                  "outputs": [7]},
                 {"type": "gelu", "name": "ge", "inputs": [7],
                  "outputs": [8]},
             ]}
    for s in (spec, image):
        jm = jax_from_spec(s, config=_jax_config())
        pm = model_from_spec(s, config=_cpu())
        assert [(op.name, op.op_type.value,
                 [tuple(t.dims) for t in op.outputs]) for op in pm.ops] == \
            [(op.name, op.op_type.value,
              [tuple(t.dims) for t in op.outputs]) for op in jm.ops]
