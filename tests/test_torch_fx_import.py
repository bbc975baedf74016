"""The torch.fx importer of flexflow_tpu_torch on the CPU (ROADMAP A11):
the cases of tests/test_torch_frontend.py and tests/test_torch_hf.py (the
JAX package's own tests of its importer) through the port, each against
the torch module's forward at JAX's tolerances, and the port held
against the JAX package:
 - `trace_to_records` gives JAX's records for the same module
   (identical), so a .ff file written by either package loads in the
   other;
 - a .ff file written by JAX loads in the port and predicts as JAX's
   import of it does, the weights carried across by `params_from_jax`
   (f32, 1e-5);
 - every transferred weight equals its torch source (identical), which
   holds the port's in-place copy (`Op.set_weight`) against the silent
   no-op an assignment into `FFModel.params` would be.
The HuggingFace cases build BERT and MT5 from local configs and skip
without `transformers`. Inputs come from seeded numpy generators."""
import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

import flexflow_tpu as jff
import flexflow_tpu_torch as ff
from flexflow_tpu.torch import PyTorchModel as JaxPyTorchModel
from flexflow_tpu.torch import fx as jax_fx
from flexflow_tpu_torch import params_from_jax
from flexflow_tpu_torch.torch import PyTorchModel, fx
from tests.test_torch_hf import T5StyleBlock
from tests.test_torch_zoo import one_torch_thread

_one_thread = pytest.fixture(scope="module", autouse=True)(one_torch_thread)

# f32 through another BLAS order
F32_TOL = dict(atol=1e-5, rtol=1e-5)


def make_config(batch=8):
    return ff.FFConfig(batch_size=batch, allow_mixed_precision=False,
                       device="cpu")


class MLP(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(20, 32)
        self.fc2 = nn.Linear(32, 4)

    def forward(self, x):
        x = F.relu(self.fc1(x))
        return self.fc2(x)


class CNN(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 8, 3, padding=1)
        self.pool = nn.MaxPool2d(2, 2)
        self.fc = nn.Linear(8 * 4 * 4, 5)

    def forward(self, x):
        x = self.pool(F.relu(self.conv1(x)))
        x = torch.flatten(x, 1)
        return self.fc(x)


class Residual(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(16, 16)
        self.ln = nn.LayerNorm(16)

    def forward(self, x):
        h = self.fc1(x)
        return self.ln(x + h)


class Tok(nn.Module):
    def __init__(self):
        super().__init__()
        self.emb = nn.Embedding(50, 8)
        self.fc = nn.Linear(8, 4)

    def forward(self, x):
        h = self.emb(x)
        h = h.mean([1])
        return self.fc(h)


class ScalarLeft(nn.Module):
    def forward(self, x):
        return 1.0 - x + 2.0 / (x * x + 1.0)


class SplitChunk(nn.Module):
    def forward(self, x):
        a, b, c = torch.split(x, 2, dim=1)  # chunk SIZE 2 over dim of 6
        return a + b + c


class GlobalMean(nn.Module):
    def forward(self, x):
        return x - x.mean()


class MHA(nn.Module):
    def __init__(self):
        super().__init__()
        self.attn = nn.MultiheadAttention(16, 4, batch_first=True)

    def forward(self, x):
        out, _ = self.attn(x, x, x)
        return out


class SizeView(nn.Module):
    def forward(self, x):
        return x.view(x.size(0), x.size(1) * x.size(2))


class Squeeze(nn.Module):
    def forward(self, x):
        return x.unsqueeze(1).squeeze() + x.squeeze(1)  # squeeze(1) no-op


class MaskAdd(nn.Module):
    def forward(self, x):
        m = torch.zeros(4)
        m[0] = 1.0
        return x + m  # references the original zeros node


class PosEncoder(nn.Module):
    """An embedding, a learned position table read through get_attr, a
    post-norm attention block with an FFN and a softmax head: phase 60's
    encoder of chip_smoke.py at a small width."""

    def __init__(self, vocab=50, hidden=16, heads=2, seq=6, ffn=32,
                 blocks=2):
        super().__init__()
        self.emb = nn.Embedding(vocab, hidden)
        self.pos = nn.Parameter(torch.randn(seq, hidden) * 0.02)
        self.attn = nn.ModuleList(nn.MultiheadAttention(
            hidden, heads, batch_first=True) for _ in range(blocks))
        self.ln1 = nn.ModuleList(nn.LayerNorm(hidden) for _ in range(blocks))
        self.ff1 = nn.ModuleList(nn.Linear(hidden, ffn)
                                 for _ in range(blocks))
        self.ff2 = nn.ModuleList(nn.Linear(ffn, hidden)
                                 for _ in range(blocks))
        self.ln2 = nn.ModuleList(nn.LayerNorm(hidden) for _ in range(blocks))
        self.head = nn.Linear(hidden, 2)

    def forward(self, ids):
        h = self.emb(ids) + self.pos
        for attn, ln1, ff1, ff2, ln2 in zip(self.attn, self.ln1, self.ff1,
                                            self.ff2, self.ln2):
            a, _ = attn(h, h, h)
            h = ln1(h + a)
            h = ln2(h + ff2(F.gelu(ff1(h))))
        return torch.softmax(self.head(h), dim=-1)


# name -> (module factory, input dims, int input, seed, atol, rtol): the
# cases and tolerances of tests/test_torch_frontend.py
CASES = {
    "mlp": (MLP, (8, 20), False, 0, 1e-4, 1e-4),
    "cnn": (CNN, (8, 3, 8, 8), False, 1, 1e-4, 1e-4),
    "residual_layernorm": (Residual, (8, 16), False, 2, 1e-4, 1e-4),
    "embedding_and_methods": (Tok, (8, 6), True, 5, 1e-4, 1e-4),
    "scalar_left_sub_div": (ScalarLeft, (8, 10), False, 6, 1e-5, 1e-5),
    "split_chunk_size": (SplitChunk, (8, 6), False, 7, 1e-6, 1e-7),
    "global_mean": (GlobalMean, (8, 5), False, 8, 1e-6, 1e-7),
    "multihead_attention": (MHA, (4, 6, 16), False, 9, 1e-4, 1e-4),
    "squeeze": (Squeeze, (4, 6), False, 11, 1e-6, 1e-7),
    "setitem_aliasing": (MaskAdd, (2, 4), False, 0, 1e-6, 1e-7),
    "t5_style_get_attr": (T5StyleBlock, (2, 8, 32), False, 0, 1e-4, 1e-4),
    "pos_encoder": (PosEncoder, (2, 6), True, 3, 1e-4, 1e-4),
}


def _input(name):
    _, dims, ints, seed, _, _ = CASES[name]
    rng = np.random.RandomState(seed)
    if ints:
        return rng.randint(0, 50, size=dims).astype(np.int32)
    if name == "scalar_left_sub_div":
        return rng.rand(*dims).astype(np.float32) + 0.5
    if name in ("split_chunk_size", "global_mean", "squeeze"):
        return rng.rand(*dims).astype(np.float32)
    return rng.randn(*dims).astype(np.float32)


def _module(name):
    torch.manual_seed(0)
    return CASES[name][0]().eval()


def _port(module_or_path, dims, ints, batch):
    model = ff.FFModel(make_config(batch))
    t = model.create_tensor(list(dims), ff.DataType.DT_INT32 if ints
                            else ff.DataType.DT_FLOAT)
    pt = PyTorchModel(module_or_path)
    model.final_tensor = pt.apply(model, [t])[0]
    model.compile(optimizer=ff.SGDOptimizer(model, lr=0.0),
                  loss_type=ff.LossType.LOSS_IDENTITY)
    return model, pt


def _jax(module_or_path, dims, ints, batch):
    config = jff.FFConfig()
    config.batch_size = batch
    config.num_devices = 1
    config.allow_mixed_precision = False
    model = jff.FFModel(config)
    t = model.create_tensor(list(dims), jff.DataType.DT_INT32 if ints
                            else jff.DataType.DT_FLOAT)
    pt = JaxPyTorchModel(module_or_path)
    model.final_tensor = pt.apply(model, [t])[0]
    model.compile(optimizer=jff.SGDOptimizer(model, lr=0.0),
                  loss_type=jff.LossType.LOSS_IDENTITY)
    return model, pt


def _assert_weights_equal_sources(module, model, pt):
    """Every weight the import holds equals its torch source, bit for
    bit (the layouts: Linear (out, in) -> kernel (in, out); attention's
    projections (E_out, E_in) -> (E_in, heads, head dim) and out_proj ->
    (heads, head dim, E))."""
    modules = dict(module.named_modules())
    params = model.params
    checked = 0

    def same(op, key, src):
        nonlocal checked
        np.testing.assert_array_equal(params[op][key].numpy(),
                                      src.detach().numpy(),
                                      err_msg=f"{op}/{key}")
        checked += 1

    for rec in pt.records:
        if rec["op"] != "call_module" or rec["name"] not in params:
            continue
        mod, op = modules[rec["target"]], rec["name"]
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            same(op, "kernel", mod.weight.T if isinstance(mod, nn.Linear)
                 else mod.weight)
            if mod.bias is not None:
                same(op, "bias", mod.bias)
        elif isinstance(mod, nn.Embedding):
            same(op, "weight", mod.weight)
        elif isinstance(mod, nn.LayerNorm):
            same(op, "gamma", mod.weight)
            same(op, "beta", mod.bias)
        elif isinstance(mod, nn.MultiheadAttention):
            e, h = mod.embed_dim, mod.num_heads
            for key, w, b in zip(("q", "k", "v"),
                                 mod.in_proj_weight.chunk(3),
                                 mod.in_proj_bias.chunk(3)):
                same(op, f"w{key}", w.T.reshape(e, h, e // h))
                same(op, f"b{key}", b.reshape(h, e // h))
            same(op, "wo", mod.out_proj.weight.T.reshape(h, e // h, e))
            same(op, "bo", mod.out_proj.bias)
    for target, op in pt._attr_op_names.items():
        if op in params:
            same(op, "value", dict(module.named_parameters())[target])
    assert checked == sum(len(ws) for ws in params.values())


def _torch_out(module, x):
    with torch.no_grad():
        xt = torch.from_numpy(x.astype(np.int64) if x.dtype == np.int32
                              else x)
        return module(xt).numpy()


# ---------------------------------------------------------------------
# tests/test_torch_frontend.py's and test_torch_hf.py's get_attr cases
# ---------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(CASES))
def test_import_matches_torch_forward(name):
    """Trace, compile, transfer the weights, predict: the torch module's
    own forward within the case's tolerance; every transferred weight
    equals its source."""
    _, dims, ints, _, atol, rtol = CASES[name]
    module = _module(name)
    x = _input(name)
    model, pt = _port(module, dims, ints, dims[0])
    n = pt.transfer_weights(model)
    assert n == sum(len(ws) for ws in model.params.values())
    _assert_weights_equal_sources(module, model, pt)
    np.testing.assert_allclose(model.predict(x), _torch_out(module, x),
                               atol=atol, rtol=rtol)


def test_size_arithmetic_view():
    model = ff.FFModel(make_config(4))
    t = model.create_tensor([4, 3, 5], ff.DataType.DT_FLOAT)
    outs = PyTorchModel(SizeView().eval()).apply(model, [t])
    assert outs[0].dims == (4, 15)


def test_ff_file_roundtrip(tmp_path):
    """A .ff file written by the port builds and trains."""
    path = str(tmp_path / "mlp.ff")
    fx.torch_to_flexflow(MLP(), path)
    model = ff.FFModel(make_config())
    t = model.create_tensor([8, 20], ff.DataType.DT_FLOAT)
    outs = PyTorchModel(path).apply(model, [t])
    assert outs[0].dims == (8, 4)
    model.final_tensor = outs[0]
    model.compile(optimizer=ff.SGDOptimizer(model, lr=0.01),
                  loss_type=ff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                  metrics=[ff.MetricsType.METRICS_ACCURACY])
    x = np.random.RandomState(3).randn(16, 20).astype(np.float32)
    y = np.random.RandomState(4).randint(0, 4, size=(16, 1)).astype(np.int32)
    hist = model.fit([x], y, epochs=1)
    assert len(hist) == 1 and np.isfinite(hist[0]["loss"])


def test_transfer_writes_in_place_and_refreshes_get_attr():
    """transfer_weights writes into the tensors the model holds (the
    same objects before and after), and a second call after the module
    changed, a get_attr parameter included, carries the new values."""
    module = _module("pos_encoder")
    model, pt = _port(module, (2, 6), True, 2)
    before = {(op.name, ws.name): op.w(ws.name)
              for op in model.ops for ws in op.specs}
    pt.transfer_weights(model)
    assert all(op.w(ws.name) is before[(op.name, ws.name)]
               for op in model.ops for ws in op.specs)
    with torch.no_grad():
        module.pos.add_(1.0)
        module.head.weight.mul_(2.0)
    pt.transfer_weights(model)
    pos_op = pt._attr_op_names["pos"]
    np.testing.assert_array_equal(model.params[pos_op]["value"].numpy(),
                                  module.pos.detach().numpy())
    np.testing.assert_array_equal(model.params["head"]["kernel"].numpy(),
                                  module.head.weight.detach().numpy().T)
    x = _input("pos_encoder")
    np.testing.assert_allclose(model.predict(x), _torch_out(module, x),
                               atol=1e-4, rtol=1e-4)


def test_transfer_needs_a_live_module(tmp_path):
    path = str(tmp_path / "mlp.ff")
    fx.torch_to_flexflow(MLP(), path)
    model, pt = _port(path, (8, 20), False, 8)
    with pytest.raises(ValueError, match="live torch module"):
        pt.transfer_weights(model)


# ---------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(CASES))
def test_records_equal_jax(name):
    """Each package traces its own fresh copy of the module (a trace
    names its tensor constants after the ones the module already
    holds)."""
    assert fx.trace_to_records(_module(name)) == \
        jax_fx.trace_to_records(_module(name))


@pytest.mark.parametrize("name", ["mlp", "cnn", "multihead_attention",
                                  "t5_style_get_attr", "pos_encoder"])
def test_jax_ff_file_loads_and_predicts_as_jax(name, tmp_path):
    """A .ff file written by the JAX package: the port builds the same op
    names and types, and from JAX's weights (`params_from_jax`) predicts
    as JAX's import of the same file, f32 within 1e-5; the port's file
    loads in JAX the same way."""
    _, dims, ints, _, _, _ = CASES[name]
    module = _module(name)
    x = _input(name)
    for writer in (jax_fx, fx):
        path = str(tmp_path / f"{writer.__name__.split('.')[0]}.ff")
        writer.torch_to_flexflow(module, path)
        jm, _ = _jax(path, dims, ints, dims[0])
        pm, _ = _port(path, dims, ints, dims[0])
        assert [(op.name, op.op_type.value) for op in pm.ops] == \
            [(op.name, op.op_type.value) for op in jm.ops]
        params_from_jax(pm, jm.params)
        np.testing.assert_allclose(pm.predict(x), jm.predict(x), **F32_TOL)


# ---------------------------------------------------------------------
# tests/test_torch_hf.py's HuggingFace cases
# ---------------------------------------------------------------------
def _hf_import(m, inputs, input_names):
    model = ff.FFModel(make_config(inputs[0].shape[0]))
    ts = [model.create_tensor(list(a.shape), ff.DataType.DT_INT32)
          for a in inputs]
    pt = PyTorchModel(m, input_names=input_names)
    out = pt.apply(model, ts)[0]
    if isinstance(out, dict):
        out = out.get("last_hidden_state", out)
    model.final_tensor = out
    model.compile(optimizer=ff.SGDOptimizer(model, lr=0.0),
                  loss_type=ff.LossType.LOSS_IDENTITY)
    return model, pt


def test_hf_bert_encoder_align():
    """A HuggingFace BERT encoder traced through transformers.utils.fx:
    the torch output within atol 2e-4, rtol 1e-3 (JAX's)."""
    pytest.importorskip("transformers")
    from transformers import BertConfig, BertModel

    cfg = BertConfig(
        vocab_size=128, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=128,
        max_position_embeddings=32, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0)
    torch.manual_seed(0)
    m = BertModel(cfg).eval()
    ids = np.random.RandomState(0).randint(0, 128, size=(2, 16)).astype(
        np.int32)
    model, pt = _hf_import(m, [ids], ["input_ids"])
    n = pt.transfer_weights(model)
    assert n > 20  # embeddings + 2 layers of qkv/out/ffn/ln + pooler
    with torch.no_grad():
        theirs = m(torch.from_numpy(ids.astype(np.int64))
                   ).last_hidden_state.numpy()
    np.testing.assert_allclose(model.predict(ids), theirs, atol=2e-4,
                               rtol=1e-3)


def test_hf_mt5_align():
    """The full MT5 encoder-decoder (relative position bias, causal masks
    folded at trace time, cross-attention): the torch output within atol
    5e-4, rtol 1e-3 (JAX's)."""
    pytest.importorskip("transformers")
    from transformers import MT5Config, MT5Model

    cfg = MT5Config(vocab_size=128, d_model=64, d_kv=16, d_ff=128,
                    num_layers=2, num_decoder_layers=2, num_heads=4,
                    dropout_rate=0.0)
    torch.manual_seed(0)
    m = MT5Model(cfg).eval()
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 128, size=(2, 16)).astype(np.int32)
    dids = rng.randint(0, 128, size=(2, 16)).astype(np.int32)
    model, pt = _hf_import(m, [ids, dids],
                           ["input_ids", "decoder_input_ids"])
    n = pt.transfer_weights(model)
    assert n >= 50, n  # embeddings + 2 enc + 2 dec blocks incl. cross-attn
    with torch.no_grad():
        theirs = m(input_ids=torch.from_numpy(ids.astype(np.int64)),
                   decoder_input_ids=torch.from_numpy(dids.astype(np.int64)),
                   ).last_hidden_state.numpy()
    np.testing.assert_allclose(model.predict([ids, dids]), theirs,
                               atol=5e-4, rtol=1e-3)


def test_hf_records_equal_jax():
    """The HuggingFace route's records equal JAX's for the same BERT."""
    pytest.importorskip("transformers")
    from transformers import BertConfig, BertModel

    cfg = BertConfig(vocab_size=64, hidden_size=32, num_hidden_layers=1,
                     num_attention_heads=2, intermediate_size=64,
                     max_position_embeddings=16)
    torch.manual_seed(0)
    m = BertModel(cfg).eval()
    assert fx.trace_to_records(m, input_names=["input_ids"]) == \
        jax_fx.trace_to_records(m, input_names=["input_ids"])
