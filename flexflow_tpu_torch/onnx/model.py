"""ONNX importer (counterpart of flexflow_tpu/onnx/model.py).

`ONNXModel(path_or_bytes).apply(ffmodel, inputs)` replays an ONNX graph
as the port's FFModel layer calls, each op named after its ONNX node,
and `transfer_weights` copies the graph's initializers into the compiled
model. The `onnx` package is used where it is installed, else the
built-in wire codec (onnx/wire.py), as in the JAX package.

Weights are written through `Op.set_weight` (core/op.py), in place: the
port's `FFModel.params` is a fresh dict on each read, so assigning into
it, as the JAX importer does into its params tree, would change nothing.
An in-place write also bumps the weight's version, so a serving bucket
captured before it re-captures (serving/model.py).
"""
from __future__ import annotations

import logging
import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..core.tensor import Tensor
from ..ffconst import ActiMode, AggrMode, DataType, PoolType


def _backend():
    """The onnx package when installed, else the built-in pure-Python wire
    codec (onnx/wire.py): the importer runs either way."""
    try:
        import onnx  # noqa: F401

        return onnx
    except ImportError:
        from . import wire

        return wire


def _attrs(node) -> Dict:
    be = _backend()
    get = (be.helper.get_attribute_value if hasattr(be, "helper")
           else be.get_attribute_value)
    return {a.name: get(a) for a in node.attribute}


def copy_weight(op, key: str, arr) -> None:
    """Write `arr` (numpy or tensor, the whole weight) into `op`'s weight
    `key` in place, in the weight's dtype; a shape that differs raises
    rather than broadcasting."""
    val = arr if torch.is_tensor(arr) else torch.from_numpy(
        np.ascontiguousarray(arr))
    spec = next(ws for ws in op.specs if ws.name == key)
    if tuple(val.shape) != tuple(spec.dims):
        raise ValueError(f"op {op.name!r} weight {key!r}: shape "
                         f"{tuple(val.shape)}, expected {tuple(spec.dims)}")
    op.set_weight(key, val.detach().cpu())


def weight_ops(ffmodel) -> Dict[str, object]:
    """op name -> op, for the ops that hold weights."""
    return {op.name: op for op in ffmodel.ops if op.specs}


class ONNXModel:
    """Replays an ONNX graph as flexflow_tpu_torch layer calls."""

    def __init__(self, path_or_proto):
        be = _backend()
        if isinstance(path_or_proto, bytes):
            # serialized proto bytes: the wire codec takes them directly;
            # the onnx package parses via its proto class
            if hasattr(be, "ModelProto"):
                m = be.ModelProto()
                m.ParseFromString(path_or_proto)
                self.model = m
            else:
                self.model = be.load(path_or_proto)
        elif isinstance(path_or_proto, str):
            self.model = be.load(path_or_proto)
        else:
            self.model = path_or_proto
        self.graph = self.model.graph
        self.inits = {i.name: i for i in self.graph.initializer}
        self._pending_weights: Dict[str, Dict[str, np.ndarray]] = {}

    def _init_array(self, name):
        t = self.inits[name]
        try:
            import onnx.numpy_helper as nph

            return nph.to_array(t)
        except ImportError:
            from .wire import to_array

            return to_array(t)

    def apply(self, ffmodel, input_tensors: Sequence[Tensor]) -> List[Tensor]:
        env: Dict[str, object] = {}
        graph_inputs = [i.name for i in self.graph.input
                        if i.name not in self.inits]
        for name, t in zip(graph_inputs, input_tensors):
            env[name] = t
        self._pending_weights = {}
        for node in self.graph.node:
            self._emit(ffmodel, node, env)
        return [env[o.name] for o in self.graph.output]

    # ------------------------------------------------------------------
    def _emit(self, fm, node, env):
        op = node.op_type
        at = _attrs(node)
        ins = node.input
        name = node.name or node.output[0]

        def x(i=0):
            return env[ins[i]]

        if op == "Gemm":
            if at.get("transA", 0):
                raise NotImplementedError("Gemm with transA=1")
            w = self._init_array(ins[1])
            out_dim = w.shape[0] if at.get("transB", 0) else w.shape[1]
            t = fm.dense(x(), int(out_dim), ActiMode.AC_MODE_NONE,
                         use_bias=len(ins) > 2, name=name)
            # y = alpha*A@B + beta*C folds exactly into the stashed weights
            kernel = ((w.T if at.get("transB", 0) else w)
                      * float(at.get("alpha", 1.0)))
            bias = None
            if len(ins) > 2:
                bias = self._init_array(ins[2]) * float(at.get("beta", 1.0))
            self._stash(name, kernel=kernel, bias=bias)
        elif op == "MatMul":
            if ins[1] in self.inits:
                w = self._init_array(ins[1])
                t = fm.dense(x(), int(w.shape[-1]), ActiMode.AC_MODE_NONE,
                             use_bias=False, name=name)
                self._stash(name, kernel=w)
            else:
                t = fm.batch_matmul(x(0), x(1), name=name)
        elif op == "Conv":
            w = self._init_array(ins[1])
            kh, kw = at.get("kernel_shape", w.shape[2:])
            strides = at.get("strides", [1, 1])
            ph, pw = self._spatial_pads(at, (int(kh), int(kw)))
            t = fm.conv2d(x(), int(w.shape[0]), int(kh), int(kw),
                          int(strides[0]), int(strides[1]), ph, pw,
                          groups=int(at.get("group", 1)),
                          use_bias=len(ins) > 2, name=name)
            self._stash(name, kernel=w,
                        bias=self._init_array(ins[2]) if len(ins) > 2
                        else None)
        elif op in ("MaxPool", "AveragePool"):
            kh, kw = at["kernel_shape"]
            strides = at.get("strides", [1, 1])
            ph, pw = self._spatial_pads(at, (int(kh), int(kw)))
            pt = PoolType.POOL_MAX if op == "MaxPool" else PoolType.POOL_AVG
            t = fm.pool2d(x(), int(kh), int(kw), int(strides[0]),
                          int(strides[1]), ph, pw, pool_type=pt, name=name)
        elif op == "GlobalAveragePool":
            _, _, h, w_ = x().dims
            t = fm.pool2d(x(), h, w_, 1, 1, 0, 0, pool_type=PoolType.POOL_AVG,
                          name=name)
        elif op == "Relu":
            t = fm.relu(x(), name=name)
        elif op == "Sigmoid":
            t = fm.sigmoid(x(), name=name)
        elif op == "Tanh":
            t = fm.tanh(x(), name=name)
        elif op == "Elu":
            t = fm.elu(x(), name=name)
        elif op == "Gelu":
            t = fm.gelu(x(), name=name)
        elif op == "Softmax":
            t = fm.softmax(x(), int(at.get("axis", -1)), name=name)
        elif op == "Dropout":
            t = fm.dropout(x(), float(at.get("ratio", 0.5)), name=name)
        elif op == "Flatten":
            t = fm.flat(x(), name=name)
        elif op == "Reshape":
            shape = [int(v) for v in self._init_array(ins[1])]
            if -1 in shape or 0 in shape:
                dims = list(x().dims)
                shape = [dims[i] if s == 0 else s for i, s in enumerate(shape)]
                if -1 in shape:
                    known = math.prod(s for s in shape if s != -1)
                    shape[shape.index(-1)] = math.prod(dims) // known
            t = fm.reshape(x(), shape, name=name)
        elif op == "Transpose":
            t = fm.transpose(x(), [int(v) for v in at["perm"]], name=name)
        elif op == "Concat":
            t = fm.concat([env[i] for i in ins], int(at["axis"]), name=name)
        elif op == "Split":
            axis = int(at.get("axis", 0))
            if "split" in at:
                sizes = [int(v) for v in at["split"]]
            elif len(ins) > 1 and ins[1] in self.inits:
                sizes = [int(v) for v in self._init_array(ins[1])]
            else:
                # equal split over the declared number of outputs
                n_out = len(node.output)
                total = x().dims[axis]
                if total % n_out:
                    raise NotImplementedError(
                        f"Split: {total} not divisible into {n_out} equal "
                        "parts")
                sizes = [total // n_out] * n_out
            parts = fm.split(x(), sizes, axis, name=name)
            for out_name, part in zip(node.output, parts):
                env[out_name] = part
            return
        elif op == "Add":
            t = self._binary(fm, fm.add, fm.scalar_add, env, ins, name)
        elif op == "Sub":
            t = self._binary(fm, fm.subtract, fm.scalar_sub, env, ins, name)
        elif op == "Mul":
            t = self._binary(fm, fm.multiply, fm.scalar_multiply, env, ins,
                             name)
        elif op == "Div":
            t = self._binary(fm, fm.divide, fm.scalar_true_divide, env, ins,
                             name)
        elif op in ("ReduceMean", "ReduceSum"):
            axes = [int(v) for v in at.get("axes", [])]
            if not axes and len(ins) > 1 and ins[1] in self.inits:
                axes = [int(v) for v in self._init_array(ins[1])]
            if not axes:  # ONNX default: reduce over ALL axes
                axes = list(range(len(x().dims)))
            fn = fm.mean if op == "ReduceMean" else fm.reduce_sum
            t = fn(x(), axes, bool(at.get("keepdims", 1)), name=name)
        elif op == "Cast":
            onnx_to_ff = {1: DataType.DT_FLOAT, 6: DataType.DT_INT32,
                          7: DataType.DT_INT64, 10: DataType.DT_HALF,
                          11: DataType.DT_DOUBLE}
            t = fm.cast(x(), onnx_to_ff[int(at["to"])], name=name)
        elif op == "Gather" and ins[0] in self.inits:
            w = self._init_array(ins[0])
            t = fm.embedding(env[ins[1]], int(w.shape[0]), int(w.shape[1]),
                             AggrMode.AGGR_MODE_NONE, name=name)
            self._stash(name, weight=w)
        elif op == "Identity":
            t = x()
        else:
            raise NotImplementedError(f"ONNX op {op} not supported")
        env[node.output[0]] = t

    @staticmethod
    def _spatial_pads(at, kernel):
        """Resolve pads/auto_pad to symmetric (ph, pw); asymmetric padding
        and stride-dependent SAME that can't be expressed symmetrically
        raise rather than silently shifting the output."""
        auto = at.get("auto_pad", b"NOTSET")
        auto = auto.decode() if isinstance(auto, bytes) else auto
        if auto in ("SAME_UPPER", "SAME_LOWER"):
            kh, kw = kernel
            if kh % 2 == 0 or kw % 2 == 0:
                raise NotImplementedError(
                    f"auto_pad={auto} with even kernel {kernel} is asymmetric"
                )
            return kh // 2, kw // 2
        pads = [int(v) for v in at.get("pads", [0, 0, 0, 0])]
        if pads[0] != pads[2] or pads[1] != pads[3]:
            raise NotImplementedError(f"asymmetric pads {pads}")
        return pads[0], pads[1]

    def _binary(self, fm, tensor_fn, scalar_fn, env, ins, name):
        a_const = ins[0] in self.inits
        b_const = ins[1] in self.inits
        if not a_const and not b_const:
            return tensor_fn(env[ins[0]], env[ins[1]], name=name)
        arr = self._init_array(ins[0] if a_const else ins[1])
        t = env[ins[1] if a_const else ins[0]]
        if arr.size != 1:
            raise NotImplementedError("binary op with non-scalar initializer")
        c = float(arr.reshape(()))
        if not a_const:
            return scalar_fn(t, c, name=name)
        # constant on the LEFT: rewrite the non-commutative cases
        if tensor_fn == fm.subtract:  # c - t
            return fm.scalar_add(fm.scalar_multiply(t, -1.0,
                                                    name=f"{name}_neg"),
                                 c, name=name)
        if tensor_fn == fm.divide:  # c / t
            return fm.scalar_multiply(fm.pow(t, -1.0, name=f"{name}_inv"),
                                      c, name=name)
        return scalar_fn(t, c, name=name)

    def _stash(self, name, **arrays):
        self._pending_weights[name] = {
            k: v for k, v in arrays.items() if v is not None
        }

    def transfer_weights(self, ffmodel) -> int:
        """Copy the ONNX initializer values into the compiled FFModel, in
        place (`copy_weight`). Warns when imported weights fail to match
        (e.g. compile-time graph rewrites renamed or merged ops): those
        ops keep their random init. Returns the number of tensors
        copied."""
        ops = weight_ops(ffmodel)
        copied = 0
        for name, slot in self._pending_weights.items():
            op = ops.get(name)
            if op is None:
                continue
            have = {ws.name for ws in op.specs}
            for key, arr in slot.items():
                if key in have:
                    copy_weight(op, key, arr)
                    copied += 1
        expected = sum(len(v) for v in self._pending_weights.values())
        if copied < expected:
            logging.getLogger(__name__).warning(
                "ONNX import: only %d of %d weights matched the compiled "
                "model (graph rewrites may have renamed ops): the rest "
                "keep their random init", copied, expected)
        return copied


class ONNXModelKeras(ONNXModel):
    """The same replay, constructed from a keras-exported ONNX proto (JAX
    `ONNXModelKeras`; `ffconfig` and `ffmodel` are accepted and unused, as
    there)."""

    def __init__(self, path_or_proto, ffconfig=None, ffmodel=None):
        super().__init__(path_or_proto)
