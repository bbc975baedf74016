"""Replay a torch.fx trace (.ff records) into the port's FFModel layer
calls (counterpart of flexflow_tpu/torch/model.py): one dispatch table
over the serialized JSON records, with trace-time tensor math (masks,
position ids, size arithmetic) folded eagerly with numpy.

`transfer_weights` copies the traced module's weights into the compiled
model through `Op.set_weight` (core/op.py), in place: the port's
`FFModel.params` is a fresh dict on each read, so assigning into it, as
the JAX importer does into its params tree, would change nothing.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.tensor import Tensor
from ..ffconst import ActiMode, AggrMode, PoolType
from ..onnx.model import copy_weight, weight_ops


class _Env(dict):
    """node name -> flexflow_tpu_torch Tensor or plain python value."""


def _is_tensor(v) -> bool:
    return isinstance(v, Tensor)


class _Const:
    """A concrete value flowing through the import — get_attr
    parameters/buffers and trace-time mask/position arithmetic. Folded
    eagerly with numpy; materialized into the graph (create_constant) only
    where a real tensor op consumes it. The materialized tensor is stored on
    the object itself (not an id()-keyed cache — transient ids get reused),
    so a parameter read once but consumed at several sites stays ONE weight.
    source_target: the originating get_attr target, for weight transfer."""

    def __init__(self, value, trainable: bool = False,
                 source_target: Optional[str] = None):
        self.value = np.asarray(value)
        self.trainable = trainable
        self.source_target = source_target
        self._tensor = None  # set by _materialize

    def __repr__(self):
        return f"_Const{self.value.shape}"


_TORCH_NP_DTYPES = {
    "torch.float32": np.float32, "torch.float": np.float32,
    "torch.float64": np.float64, "torch.float16": np.float16,
    "torch.bfloat16": np.float32,  # folded math runs f32; cast at materialize
    "torch.int64": np.int64, "torch.long": np.int64,
    "torch.int32": np.int32, "torch.int": np.int32,
    "torch.bool": np.bool_, "torch.uint8": np.uint8,
}


def _np_dtype(d, default=np.float32):
    if d is None:
        return default
    if isinstance(d, dict):
        d = d.get("dtype")
    return _TORCH_NP_DTYPES.get(str(d), default)


def _npv(v):
    """Unwrap to a numpy-compatible value (non-Tensor args only)."""
    return v.value if isinstance(v, _Const) else v


def _foldable(v) -> bool:
    """True when v (possibly nested) contains no graph Tensor."""
    if isinstance(v, Tensor):
        return False
    if isinstance(v, (list, tuple)):
        return all(_foldable(x) for x in v)
    if isinstance(v, dict):
        return all(_foldable(x) for x in v.values())
    return True


def _fold(target: str, args, kwargs):
    """Evaluate trace-time tensor math (masks, position ids, size
    arithmetic) eagerly with numpy. Returns NotImplemented when the target
    is not a known fold. Folds run under errstate(ignore): traced models
    legitimately build masks via log(0) -> -inf and cast +-inf sentinels
    (HF attention masks), and a RuntimeWarning here is trace noise — or,
    under -W error, a spurious fold failure."""
    a = [_npv(x) for x in args]
    k = {key: _npv(v) for key, v in kwargs.items()}

    def wrap(v):
        return _Const(v) if isinstance(v, np.ndarray) else v

    def shape_args(rest):
        if len(rest) == 1 and isinstance(rest[0], (list, tuple)):
            return tuple(rest[0])
        return tuple(rest)

    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        # unknown targets and fold failures resolve to NotImplemented
        # inside the dispatch
        return _fold_dispatch(target, a, k, args, kwargs, wrap, shape_args)


def _fold_dispatch(target, a, k, args, kwargs, wrap, shape_args):
    try:
        if target in ("add", "iadd"):
            return wrap(a[0] + a[1])
        if target in ("sub", "isub"):
            return wrap(a[0] - a[1])
        if target == "rsub":  # torch.rsub(input, other) = other - input
            return wrap(a[1] - a[0])
        if target in ("mul", "imul"):
            return wrap(a[0] * a[1])
        if target in ("truediv", "div"):
            return wrap(a[0] / a[1])
        if target == "floordiv":
            return wrap(a[0] // a[1])
        if target == "neg":
            return wrap(-a[0])
        if target == "abs":
            return wrap(np.abs(a[0]))
        if target in ("pow",):
            return wrap(np.power(a[0], a[1]))
        if target == "rsqrt":
            return wrap(1.0 / np.sqrt(a[0]))
        if target == "sqrt":
            return wrap(np.sqrt(a[0]))
        if target == "log":
            return wrap(np.log(a[0]))
        if target in ("eq", "ne", "gt", "lt", "ge", "le"):
            return wrap(getattr(np, {"eq": "equal", "ne": "not_equal",
                                     "gt": "greater", "lt": "less",
                                     "ge": "greater_equal",
                                     "le": "less_equal"}[target])(a[0], a[1]))
        if target in ("min", "max"):
            if len(a) > 1 and isinstance(a[1], (int, np.integer)) \
                    and np.asarray(a[0]).ndim > 0:
                # torch dim-reduction form: returns (values, indices)
                dim = int(a[1])
                red = np.min if target == "min" else np.max
                arg = np.argmin if target == "min" else np.argmax
                return (wrap(red(a[0], axis=dim)), wrap(arg(a[0], axis=dim)))
            if len(a) > 1:
                fn = np.minimum if target == "min" else np.maximum
                return wrap(fn(a[0], a[1]))
            return wrap((np.min if target == "min" else np.max)(a[0]))
        if target == "minimum":
            return wrap(np.minimum(a[0], a[1]))
        if target == "maximum":
            return wrap(np.maximum(a[0], a[1]))
        if target == "where":
            return wrap(np.where(a[0], a[1], a[2]))
        if target == "triu":
            return wrap(np.triu(a[0], k.get("diagonal", a[1] if len(a) > 1 else 0)))
        if target == "cumsum":
            return wrap(np.cumsum(a[0], axis=k.get("dim", a[1] if len(a) > 1 else None)))
        if target == "arange":
            return wrap(np.arange(*a, dtype=_np_dtype(k.get("dtype"), np.int64)))
        if target == "ones":
            return wrap(np.ones(shape_args(a), dtype=_np_dtype(k.get("dtype"))))
        if target == "zeros":
            return wrap(np.zeros(shape_args(a), dtype=_np_dtype(k.get("dtype"))))
        if target == "full":
            # fill may be positional or the fill_value kwarg (the HF T5/mt5
            # causal-mask trace passes it by keyword, with token-dict
            # dtype/device kwargs from tensor introspection)
            fill = a[1] if len(a) > 1 else k["fill_value"]
            return wrap(np.full(shape_args([a[0]]), fill,
                                dtype=_np_dtype(k.get("dtype"))))
        if target == "full_like":
            return wrap(np.full_like(a[0], a[1] if len(a) > 1
                                     else k["fill_value"]))
        if target == "zeros_like":
            return wrap(np.zeros_like(a[0]))
        if target == "ones_like":
            return wrap(np.ones_like(a[0]))
        if target == "tensor":
            return wrap(np.asarray(a[0]))
        if target == "finfo":
            return np.finfo(_np_dtype(args[0] if args else None))
        if target == "getitem":
            idx = args[1]
            if isinstance(idx, list):
                idx = tuple(x if isinstance(x, (slice, int)) else _npv(x)
                            for x in idx)
            return wrap(a[0][idx])
        if target == "setitem":
            # trace-time mask surgery (e.g. the T5/mt5 causal-mask window
            # writes). Python never rebinds on __setitem__, so downstream
            # nodes keep referencing the ORIGINAL tensor node — mutating
            # the stored array in place (the same object in env via
            # _Const.value) serves both it and the setitem node, matching
            # eager/fx-Interpreter semantics.
            idx = args[1]
            if isinstance(idx, list):
                idx = tuple(x if isinstance(x, (slice, int)) else _npv(x)
                            for x in idx)
            arr = a[0]
            if not (isinstance(arr, np.ndarray) and arr.flags.writeable):
                # non-writeable source (e.g. a broadcast_to fold): replace
                # the value INSIDE the original holder so downstream
                # references to the source node keep aliasing the mutation
                if not isinstance(args[0], _Const):
                    raise ValueError(
                        "setitem on a non-writeable trace-time array with no "
                        "value holder — in-place aliasing cannot be preserved")
                arr = np.array(arr)
                args[0].value = arr
            arr[idx] = a[2]
            return wrap(arr)
        if target == "getattr":
            return wrap(getattr(a[0], args[1]))
        if target in ("to", "type_as"):
            dt = _np_dtype(args[1] if len(args) > 1 else k.get("dtype"),
                           default=None)
            return wrap(a[0].astype(dt) if dt is not None else a[0])
        if target in ("float",):
            return wrap(np.asarray(a[0], np.float32))
        if target in ("long", "int"):
            return wrap(np.asarray(a[0], np.int64))
        if target == "bool":
            return wrap(np.asarray(a[0], np.bool_))
        if target == "expand":
            sizes = shape_args(a[1:])
            src = np.asarray(a[0])
            tgt = [s if s != -1 else src.shape[i]
                   for i, s in enumerate(sizes)]
            return wrap(np.broadcast_to(src, tuple(tgt)).copy())
        if target == "masked_fill":
            out = np.array(a[0], dtype=np.float32 if not np.issubdtype(
                np.asarray(a[0]).dtype, np.floating) else None)
            out[np.asarray(a[1], bool)] = a[2]
            return wrap(out)
        if target in ("unsqueeze",):
            return wrap(np.expand_dims(a[0], a[1]))
        if target in ("squeeze",):
            return wrap(np.squeeze(a[0], a[1] if len(a) > 1 else None))
        if target in ("view", "reshape"):
            shape = shape_args(a[1:])
            return wrap(np.reshape(a[0], shape))
        if target in ("contiguous", "clone", "detach"):
            return wrap(np.asarray(a[0]))
        if target == "size":
            return (list(np.asarray(a[0]).shape) if len(a) == 1
                    else np.asarray(a[0]).shape[a[1]])
        if target == "dim":
            return np.asarray(a[0]).ndim
        if target == "transpose":
            arr = np.asarray(a[0])
            perm = list(range(arr.ndim))
            perm[a[1]], perm[a[2]] = perm[a[2]], perm[a[1]]
            return wrap(arr.transpose(perm))
        if target == "permute":
            perm = shape_args(a[1:])
            return wrap(np.asarray(a[0]).transpose(perm))
    except Exception:
        return NotImplemented
    return NotImplemented


class PyTorchModel:
    def __init__(self, model_or_path, tracer_cls=None,
                 batch_size: Optional[int] = None, input_names=None):
        """model_or_path: a torch.nn.Module (traced on the fly; HuggingFace
        models route through transformers' fx tracer — pass input_names) or
        a path to a .ff file written by fx.torch_to_flexflow."""
        from . import fx

        self._torch_module = None
        if isinstance(model_or_path, str):
            self.records = fx.load_ff_file(model_or_path)
        else:
            self._torch_module = model_or_path
            self.records = fx.trace_to_records(
                model_or_path, tracer_cls=tracer_cls, input_names=input_names)
        self.batch_size = batch_size

    # ------------------------------------------------------------------
    def apply(self, ffmodel, input_tensors: Sequence[Tensor]) -> List[Tensor]:
        env = _Env()
        # get_attr target -> materialized constant-op name (weight transfer)
        self._attr_op_names: Dict[str, str] = {}
        inputs = list(input_tensors)
        outputs: List[Tensor] = []
        for rec in self.records:
            op = rec["op"]
            if op == "placeholder":
                env[rec["name"]] = inputs.pop(0)
            elif op == "call_module":
                env[rec["name"]] = self._call_module(ffmodel, rec, env)
            elif op == "call_function":
                env[rec["name"]] = self._call_function(ffmodel, rec, env)
            elif op == "call_method":
                env[rec["name"]] = self._call_method(ffmodel, rec, env)
            elif op == "get_attr":
                t = rec.get("tensor")
                if t is None:
                    raise NotImplementedError(
                        f"get_attr node {rec['name']} ({rec['target']}): the "
                        ".ff file predates get_attr capture — re-trace it"
                    )
                if "data_b64" in t:
                    import base64

                    val = np.frombuffer(
                        base64.b64decode(t["data_b64"]),
                        dtype=np.dtype(t["dtype"]),
                    ).reshape(t["shape"]).copy()
                else:
                    val = np.array(t["data"], dtype=np.dtype(t["dtype"]))
                env[rec["name"]] = _Const(
                    val, trainable=t.get("trainable", False),
                    source_target=rec["target"])
            elif op == "output":
                out = self._decode(rec["args"], env)[0]
                outputs = list(out) if isinstance(out, (list, tuple)) else [out]
        return outputs

    # ------------------------------------------------------------------
    def _decode(self, a, env):
        if isinstance(a, dict):
            if "node" in a:
                return env[a["node"]]
            if "slice" in a:
                return slice(*[self._decode(x, env) for x in a["slice"]])
            # token leaves are exactly {"dtype": str} / {"repr": str}
            # (fx._encode_arg); a kwargs dict merely CONTAINING a
            # dtype/repr key must still recurse so node refs resolve
            if len(a) == 1 and ("dtype" in a or "repr" in a):
                return a
            return {k: self._decode(v, env) for k, v in a.items()}
        if isinstance(a, list):
            return [self._decode(x, env) for x in a]
        return a

    def _materialize(self, fm, v, name: str):
        """Turn a _Const into a graph tensor where an op needs one (cached
        on the _Const itself, see _Const docstring)."""
        if isinstance(v, _Const):
            if v._tensor is not None:
                return v._tensor
            val = v.value
            # the JAX package's constant dtypes (JAX runs without x64),
            # so both imports build the same graph
            if val.dtype == np.int64:
                val = val.astype(np.int32)
            if val.dtype == np.float64:
                val = val.astype(np.float32)
            t = fm.create_constant(val, trainable=v.trainable,
                                   name=f"{name}_const")
            v._tensor = t
            if v.source_target is not None:
                self._attr_op_names[v.source_target] = t.owner_op.name
            return t
        return v

    def _args(self, rec, env):
        return self._decode(rec["args"], env), self._decode(rec["kwargs"], env)

    # -- call_module ----------------------------------------------------
    def _call_module(self, fm, rec, env):
        spec = rec["module"]
        t = spec["type"]
        args, kwargs = self._args(rec, env)
        name = rec["name"]
        # modules consume graph tensors: materialize folded constants (e.g.
        # the position-id buffer feeding an Embedding)
        args = [self._materialize(fm, a, f"{name}_in{i}")
                for i, a in enumerate(args)]
        x = args[0] if args else None

        if t == "Linear":
            return fm.dense(x, spec["out_features"], ActiMode.AC_MODE_NONE,
                            spec["bias"], name=name)
        if t == "Conv2d":
            pad = spec["padding"]
            if pad == "same":
                pad = [spec["kernel_size"][0] // 2, spec["kernel_size"][1] // 2]
            elif pad == "valid":
                pad = [0, 0]
            return fm.conv2d(
                x, spec["out_channels"], spec["kernel_size"][0], spec["kernel_size"][1],
                spec["stride"][0], spec["stride"][1], pad[0], pad[1],
                groups=spec["groups"], use_bias=spec["bias"], name=name,
            )
        if t in ("MaxPool2d", "AvgPool2d"):
            pt = PoolType.POOL_MAX if t == "MaxPool2d" else PoolType.POOL_AVG
            return fm.pool2d(
                x, spec["kernel_size"][0], spec["kernel_size"][1],
                spec["stride"][0], spec["stride"][1],
                spec["padding"][0], spec["padding"][1], pool_type=pt, name=name,
            )
        if t == "AdaptiveAvgPool2d":
            oh, ow = spec["output_size"]
            _, _, h, w = x.dims
            sh, sw = h // oh, w // ow
            kh, kw = h - (oh - 1) * sh, w - (ow - 1) * sw
            return fm.pool2d(x, kh, kw, sh, sw, 0, 0,
                             pool_type=PoolType.POOL_AVG, name=name)
        if t in ("BatchNorm2d",):
            return fm.batch_norm(x, relu=False, name=name)
        if t == "LayerNorm":
            axes = list(range(-len(spec["normalized_shape"]), 0))
            return fm.layer_norm(x, axes, spec["elementwise_affine"],
                                 spec["eps"], name=name)
        if t == "Embedding":
            return fm.embedding(x, spec["num_embeddings"], spec["embedding_dim"],
                                AggrMode.AGGR_MODE_NONE, name=name)
        if t == "Dropout":
            return fm.dropout(x, spec["p"], name=name)
        if t == "Softmax":
            return fm.softmax(x, spec.get("dim", -1), name=name)
        if t == "Flatten":
            if spec.get("start_dim", 1) == 1 and spec.get("end_dim", -1) == -1:
                return fm.flat(x, name=name)
            return self._flatten_range(fm, x, spec["start_dim"], spec["end_dim"], name)
        if t == "MultiheadAttention":
            q, k, v = args[0], args[1], args[2]
            if not spec.get("batch_first", False):
                # torch default layout is (L, N, E); the core op is batch-first
                q = fm.transpose(q, [1, 0, 2], name=f"{name}_qT")
                k = fm.transpose(k, [1, 0, 2], name=f"{name}_kT")
                v = fm.transpose(v, [1, 0, 2], name=f"{name}_vT")
            out = fm.multihead_attention(q, k, v, spec["embed_dim"],
                                         spec["num_heads"], name=name)
            if not spec.get("batch_first", False):
                out = fm.transpose(out, [1, 0, 2], name=f"{name}_oT")
            return [out, None]
        unary = {
            "ReLU": fm.relu, "GELU": fm.gelu, "Sigmoid": fm.sigmoid,
            "Tanh": fm.tanh, "ELU": fm.elu, "Identity": fm.identity,
        }
        if t in unary:
            return unary[t](x, name=name)
        raise NotImplementedError(f"call_module type {t} not supported")

    # -- call_function --------------------------------------------------
    def _call_function(self, fm, rec, env):
        target = rec["target"]
        name = rec["name"]
        args, kwargs = self._args(rec, env)

        # trace-time math on concrete values (masks, position ids, sizes)
        # folds eagerly; only ops touching graph tensors build graph nodes
        if _foldable(args) and _foldable(kwargs):
            folded = _fold(target, args, kwargs)
            if folded is not NotImplemented:
                return folded

        def binop(tensor_fn, scalar_fn, rev_scalar_fn=None, py_fn=None):
            """rev_scalar_fn(t, c) computes c OP t for non-commutative ops
            when the scalar is on the LEFT (e.g. 1.0 - x). Two plain numbers
            (traced size() arithmetic) fold in Python via py_fn. _Const
            operands scalarize when 0-d, else materialize as constants."""
            a, b = args[0], args[1]
            if isinstance(a, _Const):
                a = (float(a.value) if a.value.ndim == 0
                     else self._materialize(fm, a, name))
            if isinstance(b, _Const):
                b = (float(b.value) if b.value.ndim == 0
                     else self._materialize(fm, b, name))
            if not _is_tensor(a) and not _is_tensor(b):
                return py_fn(a, b)
            if _is_tensor(a) and _is_tensor(b):
                return tensor_fn(a, b, name=name)
            if _is_tensor(a):
                return scalar_fn(a, float(b), name=name)
            if rev_scalar_fn is not None:
                return rev_scalar_fn(b, float(a))
            return scalar_fn(b, float(a), name=name)

        def rev_sub(t, c):  # c - t
            return fm.scalar_add(fm.scalar_multiply(t, -1.0, name=f"{name}_neg"),
                                 c, name=name)

        def rev_div(t, c):  # c / t
            return fm.scalar_multiply(fm.pow(t, -1.0, name=f"{name}_inv"),
                                      c, name=name)

        if target in ("add", "iadd"):
            return binop(fm.add, fm.scalar_add, py_fn=lambda a, b: a + b)
        if target in ("sub", "isub"):
            return binop(fm.subtract, fm.scalar_sub, rev_sub,
                         py_fn=lambda a, b: a - b)
        if target in ("mul", "imul"):
            return binop(fm.multiply, fm.scalar_multiply,
                         py_fn=lambda a, b: a * b)
        if target in ("truediv", "div"):
            return binop(fm.divide, fm.scalar_true_divide, rev_div,
                         py_fn=lambda a, b: a / b)
        if target == "floordiv":
            return binop(None, None, py_fn=lambda a, b: a // b)
        if target == "matmul" or target == "bmm":
            return fm.batch_matmul(args[0], args[1], name=name)
        if target == "cat":
            dim = kwargs.get("dim", args[1] if len(args) > 1 else 0)
            return fm.concat(args[0], dim, name=name)
        if target == "split":
            sizes = args[1]
            dim = kwargs.get("dim", args[2] if len(args) > 2 else 0)
            if isinstance(sizes, int):
                # torch: int is the chunk SIZE; fm.split: int is the COUNT
                total = args[0].dims[dim]
                sizes = [sizes] * (total // sizes) + (
                    [total % sizes] if total % sizes else []
                )
            return fm.split(args[0], sizes, dim, name=name)
        if target == "flatten":
            start = kwargs.get("start_dim", args[1] if len(args) > 1 else 0)
            if start == 1:
                return fm.flat(args[0], name=name)
            return self._flatten_range(fm, args[0], start, -1, name)
        if target == "relu":
            return fm.relu(args[0], name=name)
        if target == "gelu":
            return fm.gelu(args[0], name=name)
        if target == "sigmoid":
            return fm.sigmoid(args[0], name=name)
        if target == "tanh":
            return fm.tanh(args[0], name=name)
        if target == "softmax":
            dim = kwargs.get("dim", args[1] if len(args) > 1 else -1)
            return fm.softmax(args[0], dim, name=name)
        if target == "dropout":
            p = kwargs.get("p", args[1] if len(args) > 1 else 0.5)
            return fm.dropout(args[0], p, name=name)
        if target == "getitem":
            if _is_tensor(args[0]):
                return self._tensor_getitem(fm, args[0], args[1], name)
            return args[0][args[1]]
        if target == "getattr":
            if args[1] == "shape":
                return args[0].dims
            if args[1] in ("device", "dtype"):
                # trace-time placement/dtype introspection: a token value —
                # consumed only by folded torch.* factory calls
                return {"repr": f"tensor.{args[1]}"}
            raise NotImplementedError(f"getattr {args[1]}")
        if target in ("mean",):
            dims = kwargs.get("dim", args[1] if len(args) > 1 else None)
            keep = kwargs.get("keepdim", False)
            return fm.mean(args[0], self._axes(args[0], dims), keep, name=name)
        if target in ("sum",):
            dims = kwargs.get("dim", args[1] if len(args) > 1 else None)
            keep = kwargs.get("keepdim", False)
            return fm.reduce_sum(args[0], self._axes(args[0], dims), keep,
                                 name=name)
        if target == "transpose":
            return self._transpose(fm, args[0], args[1], args[2], name)
        if target == "permute":
            perm = args[1] if isinstance(args[1], list) else list(args[1:])
            return fm.transpose(args[0], perm, name=name)
        if target == "reshape":
            return self._reshape(fm, args[0], args[1], name)
        if target == "scaled_dot_product_attention":
            return self._sdpa(fm, args, kwargs, name)
        if target == "rsqrt":
            return fm.rsqrt(args[0], name=name)
        if target == "pow":
            return fm.pow(args[0], float(args[1]), name=name)
        if target == "exp":
            return fm.exp(args[0], name=name)
        if target in ("to", "type_as", "float", "contiguous", "clone",
                      "detach"):
            # graph tensors carry their dtype through lowering; trace-time
            # dtype juggling is a no-op here
            return args[0]
        raise NotImplementedError(f"call_function {target} not supported")

    def _sdpa(self, fm, args, kwargs, name):
        """torch.nn.functional.scaled_dot_product_attention on [B, H, L, D]
        tensors, built from batch_matmul/softmax (the F.sdpa path HF BERT
        traces to)."""
        q, k, v = args[0], args[1], args[2]
        # positional signature: (q, k, v, attn_mask, dropout_p, is_causal)
        mask = kwargs.get("attn_mask", args[3] if len(args) > 3 else None)
        dropout_p = kwargs.get("dropout_p",
                               args[4] if len(args) > 4 else 0.0)
        is_causal = kwargs.get("is_causal",
                               args[5] if len(args) > 5 else False)
        if dropout_p:
            raise NotImplementedError("sdpa dropout_p not supported")
        d = q.dims[-1]
        lq, lk = q.dims[-2], k.dims[-2]
        add_mask = None
        if isinstance(mask, _Const):
            mv = mask.value
            if mv.dtype == np.bool_:
                mv = np.where(mv, 0.0, -1e9).astype(np.float32)
            if np.any(mv != 0.0):
                add_mask = mv.astype(np.float32)
            mask = None
        elif mask is not None:
            raise NotImplementedError("sdpa with a traced-tensor mask")
        if is_causal:
            causal = np.triu(np.full((lq, lk), -1e9, np.float32), 1)
            add_mask = causal if add_mask is None else add_mask + causal
        kt = fm.transpose(k, [0, 1, 3, 2], name=f"{name}_kT")
        s = fm.batch_matmul(q, kt, name=f"{name}_qk")
        s = fm.scalar_multiply(s, 1.0 / math.sqrt(d), name=f"{name}_scale")
        if add_mask is not None:
            # natural broadcast shape — the elementwise add broadcasts
            s = fm.add(s, self._materialize(fm, _Const(add_mask),
                                            f"{name}_mask"),
                       name=f"{name}_masked")
        p = fm.softmax(s, -1, name=f"{name}_probs")
        return fm.batch_matmul(p, v, name=f"{name}_ctx")

    # -- call_method ----------------------------------------------------
    def _call_method(self, fm, rec, env):
        target = rec["target"]
        name = rec["name"]
        args, kwargs = self._args(rec, env)
        if _foldable(args) and _foldable(kwargs):
            folded = _fold(target, args, kwargs)
            if folded is not NotImplemented:
                return folded
        x = args[0]
        if target in ("to", "type_as", "float", "clone", "detach"):
            return x
        if target == "dim":
            return len(x.dims)
        if target in ("view", "reshape"):
            shape = args[1] if isinstance(args[1], list) else list(args[1:])
            return self._reshape(fm, x, shape, name)
        if target == "permute":
            perm = args[1] if isinstance(args[1], list) else list(args[1:])
            return fm.transpose(x, perm, name=name)
        if target == "transpose":
            return self._transpose(fm, x, args[1], args[2], name)
        if target == "flatten":
            start = args[1] if len(args) > 1 else 0
            if start == 1:
                return fm.flat(x, name=name)
            return self._flatten_range(fm, x, start, -1, name)
        if target == "contiguous":
            return x
        if target == "size":
            return x.dims if len(args) == 1 else x.dims[args[1]]
        if target == "mean":
            dims = args[1] if len(args) > 1 else kwargs.get("dim")
            keep = kwargs.get("keepdim", False)
            return fm.mean(x, self._axes(x, dims), keep, name=name)
        if target == "squeeze":
            dims = list(x.dims)
            if len(args) > 1:
                d = args[1]
                if dims[d] != 1:
                    return x  # torch: squeezing a non-1 dim is a no-op
                dims.pop(d)
            else:
                dims = [s for s in dims if s != 1]
            return fm.reshape(x, dims, name=name)
        if target == "unsqueeze":
            if len(args) < 2:
                raise NotImplementedError("unsqueeze requires a dim argument")
            dims = list(x.dims)
            d = args[1]
            dims.insert(d if d >= 0 else len(dims) + d + 1, 1)
            return fm.reshape(x, dims, name=name)
        if target == "softmax":
            return fm.softmax(x, args[1] if len(args) > 1 else -1, name=name)
        if target == "pow":
            return fm.pow(x, float(args[1]), name=name)
        if target == "rsqrt":
            return fm.rsqrt(x, name=name)
        if target == "masked_fill":
            mask, value = args[1], args[2]
            if isinstance(mask, _Const):
                mv = mask.value.astype(bool)
                if not np.any(mv):
                    return x
                # exact replace semantics: x*(1-m) + value*m, constants at
                # the mask's natural shape (elementwise ops broadcast)
                keep = np.where(mv, 0.0, 1.0).astype(np.float32)
                fill = np.where(mv, float(value), 0.0).astype(np.float32)
                kept = fm.multiply(
                    x, self._materialize(fm, _Const(keep), f"{name}_keep"),
                    name=f"{name}_kept")
                return fm.add(
                    kept, self._materialize(fm, _Const(fill), f"{name}_fill"),
                    name=name)
            raise NotImplementedError("masked_fill with a traced mask")
        raise NotImplementedError(f"call_method {target} not supported")

    # -- helpers --------------------------------------------------------
    def _tensor_getitem(self, fm, x, idx, name):
        """Basic tensor indexing (x[:, 0], x[:, :L]) via split + reshape."""
        if not isinstance(idx, (list, tuple)):
            idx = [idx]
        out = x
        squeeze_axes = []
        for ax, it in enumerate(idx):
            size = out.dims[ax]
            if isinstance(it, slice):
                start, stop, step = it.indices(size)
                if step != 1:
                    raise NotImplementedError(f"strided getitem {it}")
                if (start, stop) == (0, size):
                    continue
            elif isinstance(it, int):
                start = it if it >= 0 else size + it
                stop = start + 1
                squeeze_axes.append(ax)
            else:
                raise NotImplementedError(f"getitem index {it!r}")
            pre, mid, post = start, stop - start, size - stop
            sizes = [s for s in (pre, mid, post) if s > 0]
            if len(sizes) > 1:
                out = fm.split(out, sizes, ax, name=f"{name}_ax{ax}")[
                    1 if pre > 0 else 0]
        if squeeze_axes:
            dims = [d for ax, d in enumerate(out.dims)
                    if ax not in squeeze_axes]
            out = fm.reshape(out, dims, name=f"{name}_sq")
        return out

    @staticmethod
    def _axes(x, dims):
        """torch dim=None means reduce over ALL axes."""
        if dims is None:
            return list(range(len(x.dims)))
        return dims if isinstance(dims, list) else [dims]

    def _reshape(self, fm, x, shape, name):
        shape = list(shape)
        total = math.prod(x.dims)
        if -1 in shape:
            known = math.prod(d for d in shape if d != -1)
            shape[shape.index(-1)] = total // known
        return fm.reshape(x, shape, name=name)

    def _transpose(self, fm, x, d0, d1, name):
        perm = list(range(len(x.dims)))
        perm[d0], perm[d1] = perm[d1], perm[d0]
        return fm.transpose(x, perm, name=name)

    def _flatten_range(self, fm, x, start, end, name):
        dims = list(x.dims)
        n = len(dims)
        start %= n
        end %= n
        merged = math.prod(dims[start:end + 1])
        return fm.reshape(x, dims[:start] + [merged] + dims[end + 1:], name=name)

    # ------------------------------------------------------------------
    def transfer_weights(self, ffmodel) -> int:
        """Copy weights from the traced torch module into the compiled
        FFModel, in place (`copy_weight`), each converted to the weight's
        dtype. Returns the number of tensors copied."""
        if self._torch_module is None:
            raise ValueError("weight transfer needs a live torch module")
        import torch.nn as nn

        from . import fx as _fx

        modules = dict(self._torch_module.named_modules())
        ops = weight_ops(ffmodel)
        copied = 0
        for rec in self.records:
            if rec["op"] != "call_module" or rec["name"] not in ops:
                continue
            mod = modules[rec["target"]]
            op = ops[rec["name"]]

            def put(key, arr):
                nonlocal copied
                copy_weight(op, key, arr)
                copied += 1

            if isinstance(mod, nn.Linear):
                put("kernel", mod.weight.T)
                if mod.bias is not None:
                    put("bias", mod.bias)
            elif isinstance(mod, nn.Conv2d):
                put("kernel", mod.weight)  # torch OIHW == ours
                if mod.bias is not None:
                    put("bias", mod.bias)
            elif isinstance(mod, nn.Embedding):
                put("weight", mod.weight)
            elif isinstance(mod, nn.LayerNorm) and mod.elementwise_affine:
                put("gamma", mod.weight)
                put("beta", mod.bias)
            elif isinstance(mod, nn.MultiheadAttention):
                e = mod.embed_dim
                h = mod.num_heads
                hd = e // h
                if mod.in_proj_weight is not None:
                    wq, wk, wv = mod.in_proj_weight.chunk(3, dim=0)
                else:
                    wq, wk, wv = (mod.q_proj_weight, mod.k_proj_weight,
                                  mod.v_proj_weight)
                # torch proj weight is (E_out, E_in); ours is (E_in, h, hd)
                put("wq", wq.T.reshape(e, h, hd))
                put("wk", wk.T.reshape(e, h, hd))
                put("wv", wv.T.reshape(e, h, hd))
                # out_proj (E, E) -> (h, hd, E)
                put("wo", mod.out_proj.weight.T.reshape(h, hd, e))
                if mod.in_proj_bias is not None and op.has_weight("bq"):
                    bq, bk, bv = mod.in_proj_bias.chunk(3, dim=0)
                    put("bq", bq.reshape(h, hd))
                    put("bk", bk.reshape(h, hd))
                    put("bv", bv.reshape(h, hd))
                    put("bo", mod.out_proj.bias)
        # get_attr-backed trainable parameters (materialized as constant
        # weights): refresh from the module's CURRENT values too
        for target, op_name in getattr(self, "_attr_op_names", {}).items():
            if op_name not in ops:
                continue
            val, _ = _fx._fetch_attr(self._torch_module, target)
            copy_weight(ops[op_name], "value", val.detach().float())
            copied += 1
        return copied
