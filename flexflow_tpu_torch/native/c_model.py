"""Load a model spec exported by the C API (ffc_model_export_json) into the
port's FFModel (counterpart of flexflow_tpu/native/c_model.py: the
consuming half of flexflow_c.h. C programs build the graph, and the port
runs it on the card)."""
from __future__ import annotations

import json
from typing import Dict

from ..config import FFConfig
from ..ffconst import ActiMode, AggrMode, DataType, PoolType
from ..model import FFModel


_ACT = {
    "": ActiMode.AC_MODE_NONE, "none": ActiMode.AC_MODE_NONE,
    "relu": ActiMode.AC_MODE_RELU, "sigmoid": ActiMode.AC_MODE_SIGMOID,
    "tanh": ActiMode.AC_MODE_TANH, "gelu": ActiMode.AC_MODE_GELU,
}


def model_from_spec(spec, config=None, batch_size=None):
    """spec: dict, JSON string, or path to a .json file. Returns a built
    (not yet compiled) FFModel; tensors keyed by the C-side guids are in
    model._c_tensors. batch_size overrides the spec's (input tensors'
    leading dim is rewritten accordingly). `config` (an FFConfig) chooses
    the device, the card unless it says otherwise."""
    if isinstance(spec, str):
        try:
            spec = json.loads(spec)
        except json.JSONDecodeError:
            with open(spec) as f:
                spec = json.load(f)
    assert spec.get("format") == "flexflow_tpu_c_model", spec.get("format")

    cfg = config or FFConfig()
    spec_batch = int(spec["config"].get("batch_size", cfg.batch_size))
    cfg.batch_size = int(batch_size) if batch_size else spec_batch
    model = FFModel(cfg)
    env: Dict[int, object] = {}

    for op in spec["ops"]:
        t = op["type"]
        p = {k: v for k, v in op.get("params", {}).items()}
        ins = [env[g] for g in op["inputs"]]
        name = op.get("name", "")

        def geti(key, dflt=0):
            return int(p.get(key, dflt))

        act_key = p.get("activation", "")
        if act_key not in _ACT:
            raise ValueError(
                f"op {name} ({t}): unsupported activation {act_key!r}")

        if t == "input":
            try:
                dtype = DataType(op.get("dtype", "float32"))
            except ValueError as e:
                raise ValueError(
                    f"op {name}: unsupported dtype {op.get('dtype')!r}"
                ) from e
            dims = list(op["dims"])
            if dims and dims[0] == spec_batch:
                dims[0] = cfg.batch_size  # batch override rewrites dim 0
            out = model.create_tensor(dims, dtype, name=name)
        elif t == "dense":
            out = model.dense(ins[0], geti("out_dim"), _ACT[act_key],
                              bool(geti("use_bias", 1)), name=name)
        elif t == "conv2d":
            out = model.conv2d(ins[0], geti("out_channels"),
                               geti("kernel_h"), geti("kernel_w"),
                               geti("stride_h"), geti("stride_w"),
                               geti("padding_h"), geti("padding_w"),
                               activation=_ACT[act_key],
                               groups=geti("groups", 1),
                               use_bias=bool(geti("use_bias", 1)), name=name)
        elif t == "pool2d":
            pt = (PoolType.POOL_AVG if p.get("pool_type") == "avg"
                  else PoolType.POOL_MAX)
            out = model.pool2d(ins[0], geti("kernel_h"), geti("kernel_w"),
                               geti("stride_h"), geti("stride_w"),
                               geti("padding_h"), geti("padding_w"),
                               pool_type=pt, name=name)
        elif t == "flat":
            out = model.flat(ins[0], name=name)
        elif t == "embedding":
            out = model.embedding(ins[0], geti("num_entries"),
                                  geti("out_dim"), AggrMode.AGGR_MODE_NONE,
                                  name=name)
        elif t == "multihead_attention":
            out = model.multihead_attention(
                ins[0], ins[0] if len(ins) < 2 else ins[1],
                ins[0] if len(ins) < 3 else ins[2],
                geti("embed_dim"), geti("num_heads"), name=name)
        elif t == "concat":
            # default must match the C side's shape inference (axis=0)
            out = model.concat(ins, geti("axis", 0), name=name)
        elif t == "batch_matmul":
            out = model.batch_matmul(ins[0], ins[1], name=name)
        elif t == "layer_norm":
            out = model.layer_norm(ins[0], [-1], name=name)
        elif t == "batch_norm":
            out = model.batch_norm(ins[0], relu=False, name=name)
        elif t == "softmax":
            out = model.softmax(ins[0], geti("axis", -1), name=name)
        elif t == "dropout":
            out = model.dropout(ins[0], float(p.get("rate", 0.5)), name=name)
        elif t in ("relu", "sigmoid", "tanh", "gelu", "identity"):
            out = getattr(model, t)(ins[0], name=name)
        elif t == "add":
            out = model.add(ins[0], ins[1], name=name)
        elif t == "subtract":
            out = model.subtract(ins[0], ins[1], name=name)
        elif t == "multiply":
            out = model.multiply(ins[0], ins[1], name=name)
        else:
            raise NotImplementedError(f"C-model op type {t}")
        env[op["outputs"][0]] = out

    model._c_tensors = env
    return model
