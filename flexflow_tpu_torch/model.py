"""FFModel: the layer API and an inference compile on one torch device
(the subset of flexflow_tpu/model.py the serving slice uses).

Op names follow the JAX package's scheme (an explicit name, else
`<op type>_<n>` per model), so the same builder code gives the same op
and weight names in both packages and `params_from_jax` can carry a JAX
model's weights across.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from . import ops as _ops  # noqa: F401  (registers every op type)
from .config import FFConfig
from .core.graph import Graph
from .core.op import OP_REGISTRY, Op
from .core.tensor import Tensor
from .ffconst import ActiMode, AggrMode, DataType, OpType
from .runtime.executor import Executor


class FFModel:
    def __init__(self, config: Optional[FFConfig] = None):
        self.config = config or FFConfig()
        self.ops: List[Op] = []
        self.input_ops: List[Op] = []
        self.final_tensor: Optional[Tensor] = None
        self.graph: Optional[Graph] = None
        self.executor: Optional[Executor] = None
        self._name_counts: Dict[OpType, int] = {}
        self._used_names: set = set()

    @property
    def device(self) -> torch.device:
        return torch.device(self.config.device)

    # -- tensor & op creation ---------------------------------------------
    def create_tensor(self, dims: Sequence[int],
                      dtype: DataType = DataType.DT_FLOAT,
                      name: str = "") -> Tensor:
        op = OP_REGISTRY[OpType.INPUT](
            self, [], name=name or f"input_{len(self.input_ops)}",
            dims=tuple(dims), dtype=dtype)
        self.ops.append(op)
        self.input_ops.append(op)
        return op.outputs[0]

    def _add_op(self, op_type: OpType, inputs: Sequence[Tensor],
                name: str = "", **params) -> Op:
        if not name:
            # per-model sequential names, skipping names the user took:
            # the JAX package's scheme, so weights key identically
            while True:
                idx = self._name_counts.get(op_type, 0)
                self._name_counts[op_type] = idx + 1
                name = f"{op_type.value}_{idx}"
                if name not in self._used_names:
                    break
        elif name in self._used_names:
            raise ValueError(f"duplicate op name {name!r}")
        self._used_names.add(name)
        op = OP_REGISTRY[op_type](self, list(inputs), name=name, **params)
        self.ops.append(op)
        return op

    def add(self, x: Tensor, y: Tensor, name: str = "") -> Tensor:
        return self._add_op(OpType.EW_ADD, [x, y], name).outputs[0]

    def dense(self, input: Tensor, out_dim: int,
              activation: ActiMode = ActiMode.AC_MODE_NONE,
              use_bias: bool = True, datatype: Optional[DataType] = None,
              kernel_initializer=None, bias_initializer=None,
              name: str = "") -> Tensor:
        return self._add_op(
            OpType.LINEAR, [input], name, out_dim=out_dim,
            activation=activation, use_bias=use_bias, dtype=datatype,
            kernel_initializer=kernel_initializer,
            bias_initializer=bias_initializer).outputs[0]

    def layer_norm(self, input: Tensor, axes: Sequence[int],
                   elementwise_affine: bool = True, eps: float = 1e-5,
                   name: str = "") -> Tensor:
        axes = [a if a >= 0 else input.num_dims + a for a in axes]
        return self._add_op(
            OpType.LAYERNORM, [input], name, axes=tuple(axes),
            elementwise_affine=elementwise_affine, eps=eps).outputs[0]

    def softmax(self, input: Tensor, axis: int = -1,
                name: str = "") -> Tensor:
        return self._add_op(OpType.SOFTMAX, [input], name,
                            axis=axis).outputs[0]

    def embedding(self, input: Tensor, num_entries: int, out_dim: int,
                  aggr: AggrMode = AggrMode.AGGR_MODE_NONE,
                  dtype: DataType = DataType.DT_FLOAT,
                  kernel_initializer=None, name: str = "") -> Tensor:
        return self._add_op(
            OpType.EMBEDDING, [input], name, num_entries=num_entries,
            out_dim=out_dim, aggr=aggr, dtype=dtype,
            kernel_initializer=kernel_initializer).outputs[0]

    def multihead_attention(self, query: Tensor, key: Tensor, value: Tensor,
                            embed_dim: int, num_heads: int, kdim: int = 0,
                            vdim: int = 0, bias: bool = True,
                            causal: bool = False, kernel_initializer=None,
                            name: str = "") -> Tensor:
        return self._add_op(
            OpType.MULTIHEAD_ATTENTION, [query, key, value], name,
            embed_dim=embed_dim, num_heads=num_heads, kdim=kdim or None,
            vdim=vdim or None, bias=bias, causal=causal,
            kernel_initializer=kernel_initializer).outputs[0]

    # -- compile ----------------------------------------------------------
    def compile(self, generator: Optional[torch.Generator] = None) -> None:
        """Build the graph and executor and draw every weight from
        `generator` (default: a CPU generator seeded 0) onto
        `config.device`. Inference only, one device, no search."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.graph = Graph(self.ops)
        order = self.graph.topo_order()
        self.final_tensor = self.final_tensor or order[-1].outputs[0]
        self.executor = Executor(self.graph, self.config)
        for op in order:
            op.init_weights(generator, self.device)

    # -- weights ----------------------------------------------------------
    @property
    def params(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """op name -> weight name -> tensor, the JAX `model.params` tree."""
        return {op.name: {ws.name: op.w(ws.name) for ws in op.specs}
                for op in self.ops if op.specs}

    def load_params(self, params: Mapping[str, Mapping[str, object]]) -> None:
        """Load every weight by op name and weight name. The tree must name
        exactly this model's weights with their shapes; each value (numpy
        array or tensor) is converted to the weight's dtype and device."""
        expected = {op.name: op for op in self.ops if op.specs}
        missing_ops = sorted(set(expected) - set(params))
        extra_ops = sorted(set(params) - set(expected))
        if missing_ops or extra_ops:
            raise KeyError(f"weight tree does not match the model: missing "
                           f"ops {missing_ops}, unknown ops {extra_ops}")
        staged = []
        for name, op in expected.items():
            given = params[name]
            want = {ws.name: ws for ws in op.specs}
            if set(given) != set(want):
                raise KeyError(
                    f"op {name!r}: expected weights {sorted(want)}, got "
                    f"{sorted(given)}")
            for wname, ws in want.items():
                val = given[wname]
                if not torch.is_tensor(val):
                    val = torch.from_numpy(
                        np.array(val, dtype=ws.dtype.np_dtype))
                if tuple(val.shape) != ws.dims:
                    raise ValueError(
                        f"op {name!r} weight {wname!r}: shape "
                        f"{tuple(val.shape)}, expected {ws.dims}")
                staged.append((op, wname, val))
        for op, wname, val in staged:
            op.set_weight(wname, val)


def params_from_jax(model: FFModel, params) -> None:
    """Carry a JAX FFModel's weights (`model.params`: op name -> weight
    name -> array) into the port's `model`, checking every name and
    shape. The layouts are the same in both packages, so nothing is
    transposed."""
    model.load_params({op: {w: np.asarray(v) for w, v in ws.items()}
                       for op, ws in params.items()})
