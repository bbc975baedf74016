"""Operator base class and registry (counterpart of flexflow_tpu/core/op.py).

An Op is an `nn.Module`: it computes its output shapes when it is built,
declares its weights as WeightSpecs, and `lower()` runs its forward on
torch tensors. Weights are registered as parameters under the JAX
package's weight names and layouts (`wq` (e, h, d), dense `kernel`
(in, out), ...), so weights move between the two packages by op name and
weight name with no transpose.

On a mesh (core/machine.py) an op holds only its shard of each weight
that `shards` names (FFModel._assign_tp_weights): drawn and loaded whole,
then cut to the mesh position's piece. Its `tp_degree` is the number of
shards over the `model` axis, 1 for an op that runs unsharded.

Weights are f32 master parameters. Serving reads them under
`torch.no_grad()` through a cache of compute-dtype copies (bf16 under
mixed precision); training casts them inside the autograd graph on every
step, so gradients reach the f32 masters (`Op.w`).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ffconst import CompMode, DataType, OpType
from .tensor import ParallelTensorShape, Tensor

_op_guid = itertools.count(1)


@dataclasses.dataclass
class WeightSpec:
    """Declaration of one weight tensor of an op."""

    name: str
    dims: Tuple[int, ...]
    dtype: DataType = DataType.DT_FLOAT
    initializer: Optional[Any] = None  # runtime.initializers.Initializer


class LoweringContext:
    """State threaded through one forward walk of the graph."""

    def __init__(self, config, mode: CompMode):
        self.config = config
        self.mode = mode
        # tensor guid -> value
        self.values: Dict[int, torch.Tensor] = {}
        # per-op device state, op name -> {var: tensor}; the attention op's
        # "k_cache"/"v_cache" are written IN PLACE (the batcher preallocates
        # them once — the port's counterpart of jit-donated buffers)
        self.state: Dict[str, Dict[str, torch.Tensor]] = {}
        # KV-cache decoding: an int chunk offset, or a (B,) int32 tensor of
        # per-row positions (ops/attention.py _decode_step)
        self.decode_pos = None
        # this process's core.machine.Mesh, None on one device
        self.mesh = None


class Op(nn.Module):
    """Base operator. Subclasses implement shape inference and lowering."""

    op_type: OpType = OpType.INPUT

    def __init__(self, model, inputs: Sequence[Tensor], name: str = "",
                 **params):
        super().__init__()
        self.guid = next(_op_guid)
        self.inputs: List[Tensor] = list(inputs)
        self.params: Dict[str, Any] = params
        self.name = name or f"{self.op_type.value}_{self.guid}"
        out_dims, out_dtypes = self.output_shapes()
        self.outputs: List[Tensor] = [
            Tensor(dims, dtype, name=f"{self.name}.out{i}", owner_op=self,
                   owner_idx=i)
            for i, (dims, dtype) in enumerate(zip(out_dims, out_dtypes))
        ]
        self.specs: List[WeightSpec] = list(self.weight_specs())
        # compute-dtype copies of the weights (bf16 under mixed precision)
        # for reads outside autograd, each beside the version of the master
        # it was cast from: an in-place update (set_weight, an optimizer
        # step) bumps the version and the next read casts again
        self._cast: Dict[Tuple[str, torch.dtype],
                         Tuple[int, torch.Tensor]] = {}
        # this op's kernel-tier choices, resolved once and kept until the
        # registry changes (kernels/registry.py KernelRegistry.resolve)
        self.kernel_memo: Dict[Any, Any] = {}
        # on a mesh: weight name -> its parallel shape, for the weights
        # that are sharded; the mesh coordinates of this process; the
        # shards over the `model` axis (1: the op runs unsharded)
        self.shards: Dict[str, ParallelTensorShape] = {}
        self.coords: Dict[str, int] = {}
        self.tp_degree = 1

    # -- subclass API -----------------------------------------------------
    def output_shapes(self) -> Tuple[List[Tuple[int, ...]], List[DataType]]:
        raise NotImplementedError

    def weight_specs(self) -> List[WeightSpec]:
        return []

    def lower(self, ctx: LoweringContext, inputs: List[torch.Tensor]):
        """Run the op; return one value per output tensor."""
        raise NotImplementedError

    # -- weights ----------------------------------------------------------
    def set_sharding(self, shards: Dict[str, ParallelTensorShape],
                     coords: Dict[str, int]) -> None:
        """Hold only this mesh position's piece of the weights `shards`
        names; call before init_weights."""
        self.shards = dict(shards)
        self.coords = dict(coords)
        self.tp_degree = max((pt.dims[i].degree for pt in shards.values()
                              for i in pt.sharded_dims()
                              if pt.dims[i].axis == "model"), default=1)

    def local_value(self, name: str, value: torch.Tensor) -> torch.Tensor:
        """This process's piece of the full weight `value`."""
        pt = self.shards.get(name)
        return value if pt is None else pt.shard(value, self.coords)

    def init_weights(self, generator: torch.Generator,
                     device: torch.device, trainable: bool = False) -> None:
        """Draw every weight whole from `generator` on the host, in spec
        order (so every mesh position draws the same model), keep this
        position's piece and place it on `device`; `trainable` weights
        take gradients."""
        for ws in self.specs:
            val = ws.initializer(generator, ws.dims, ws.dtype.torch_dtype)
            val = self.local_value(ws.name, val)
            self.register_parameter(
                ws.name, nn.Parameter(val.to(device).contiguous(),
                                      requires_grad=trainable))
        self._cast.clear()

    def set_weight(self, name: str, value: torch.Tensor) -> None:
        """Load the full weight `name` (this position keeps its piece)."""
        p = self._parameters[name]
        with torch.no_grad():
            p.copy_(self.local_value(name, value))
        self._cast.clear()

    def w(self, name: str, dtype: Optional[torch.dtype] = None):
        """Weight `name`, in `dtype` when given. Under autograd (a trainable
        weight with grad mode on) the cast is a node of the graph, made
        anew on every call; otherwise it is a cached copy, cast again only
        after the master changed."""
        p = self._parameters[name]
        if dtype is None or p.dtype == dtype:
            return p
        if p.requires_grad and torch.is_grad_enabled():
            return p.to(dtype)
        key = (name, dtype)
        hit = self._cast.get(key)
        if hit is None or hit[0] != p._version:
            hit = (p._version, p.detach().to(dtype))
            self._cast[key] = hit
        return hit[1]

    def has_weight(self, name: str) -> bool:
        return name in self._parameters


# registry: OpType -> Op subclass
OP_REGISTRY: Dict[OpType, type] = {}


def register_op(cls):
    OP_REGISTRY[cls.op_type] = cls
    return cls
