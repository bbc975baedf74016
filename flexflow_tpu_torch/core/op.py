"""Operator base class and registry (counterpart of flexflow_tpu/core/op.py).

An Op is an `nn.Module`: it computes its output shapes when it is built,
declares its weights as WeightSpecs, and `lower()` runs its forward on
torch tensors. Weights are registered as parameters under the JAX
package's weight names and layouts (`wq` (e, h, d), dense `kernel`
(in, out), ...), so weights move between the two packages by op name and
weight name with no transpose.

On a mesh (core/machine.py) an op holds only its shard of each weight
that `shards` names (FFModel._assign_tp_weights, and the stacked expert
weights over `expert`): drawn and loaded whole, then cut to the mesh
position's piece. Its `tp_degree` is the number of shards over the
`model` axis, 1 for an op that runs unsharded. An op whose plan puts it
below the mesh's data degree (`whole_batch`, from the strategy search)
computes the whole batch (runtime/executor.py); `seq_local` and
`attr_local` say that it computes on this rank's positions or H rows;
on a `stage` axis the ops of the other stages' part of the pipelined
region are not `held`: they keep no weights here.

Weights are f32 master parameters. Serving reads them under
`torch.no_grad()` through a cache of compute-dtype copies (bf16 under
mixed precision); training casts them inside the autograd graph on every
step, so gradients reach the f32 masters (`Op.w`).

An op's non-trainable state (`state_specs`: batch norm's running
statistics, the JAX package's `model.state`) is held as buffers of the
op, beside its weights, replicated on a mesh (`FFModel.state`). A
training walk, or one handed `model.state`, updates them in place
outside autograd (`Op.writes_state`), so a CUDA graph of training steps
updates them at every replay; other walks read them. The manual loop's
backward is a training walk that writes none (`LoweringContext.
write_state`): its forward already did.

`Op.weights` holds one graph `Tensor` a weight (the JAX package's
`Parameter` handles: `_weight_spec`, `owner_op`), through which
`FFModel.summary`, `Tensor.get_tensor` and `Tensor.set_tensor` reach
the weights. They are handles, not data: a plain list, outside the
module's parameter registry.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..ffconst import CompMode, DataType, OpType
from .tensor import ParallelTensorShape, Tensor

_op_guid = itertools.count(1)


def _freeze(v):
    """Hashable deep-freeze of op params (lists/dicts/arrays/callables),
    JAX `core/op.py _freeze`: the same params give the same repr in both
    packages, so an op-cost cache file keys alike in either."""
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    if isinstance(v, np.ndarray):
        return (v.shape, v.dtype.str, v.tobytes())
    if callable(v):
        return getattr(v, "__name__", repr(v))
    return v


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
        # KV-cache decoding: a 0-d int32 tensor chunk offset, or a (B,)
        # int32 tensor of per-row positions (ops/attention.py _decode_step)
        self.decode_pos = None
        # a full-sequence (prefill) walk that also writes its K/V rows into
        # the caches in `state` (ops/attention.py _full_sequence)
        self.fill_kv_cache = False
        # the cache rows a decode walk writes and their sources, made by the
        # first attention op of the walk and read by the others
        # (ops/attention.py _chunk_rows for a 0-d chunk offset, _slot_rows
        # for per-slot positions)
        self.chunk_rows = None
        # this process's core.machine.Mesh, None on one device
        self.mesh = None
        # on a mesh, the op being lowered: for each of its inputs, the
        # mesh axes its value is cut over ("data": the batch, "seq": the
        # positions, "attr": the H of NCHW; runtime/executor.py)
        self.in_cuts: List[frozenset] = []
        # a training walk's random stream (dropout masks): the executor's
        # torch.Generator on the walk's device; None outside training
        self.generator: Optional[torch.Generator] = None
        # the ops' auxiliary losses (the MoE load-balance loss), which a
        # training step adds to its loss (JAX `ctx.aux_losses`)
        self.aux_losses: List[torch.Tensor] = []
        # FFIterationConfig.seq_length (JAX `iter_seq_length`): ops with a
        # sequence dim compute on the first L positions and pad back
        self.iter_seq_length: Optional[int] = None
        # False: a training walk that leaves the ops' state as it is (the
        # manual loop's backward, whose forward wrote it)
        self.write_state = True


class Op(nn.Module):
    """Base operator. Subclasses implement shape inference and lowering."""

    op_type: OpType = OpType.INPUT
    # True: on a mesh the op gathers its inputs' `data` cut itself and its
    # outputs are whole (the MoE GroupBy's expert buffers)
    gathers_data = False

    def __init__(self, model, inputs: Sequence[Tensor], name: str = "",
                 **params):
        super().__init__()
        self.guid = next(_op_guid)
        # the model's config, which the cost model's measurement reads
        # (JAX `op.model.config`)
        self.model_config = model.config if model is not None else None
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
        # one handle a weight (JAX `Op.weights`): a plain list, so no
        # module registry sees them
        self.weights: List[Tensor] = []
        for ws in self.specs:
            t = Tensor(ws.dims, ws.dtype, name=f"{self.name}.{ws.name}",
                       owner_op=self)
            t._weight_spec = ws
            self.weights.append(t)
        self.state_vars: List[WeightSpec] = list(self.state_specs())
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
        self.whole_batch = False
        # the plan's other axes (FFModel._assign_strategy): computed on
        # this rank's positions (`seq`) or H rows (`attr`) of its inputs
        # (runtime/executor.py); a row-parallel linear (`tp_row`); and
        # whether this rank holds the op's weights (a pipeline stage's
        # ops are held by that stage's ranks alone)
        self.seq_local = False
        self.attr_local = False
        self.row_parallel = False
        self.held = True

    # -- subclass API -----------------------------------------------------
    def output_shapes(self) -> Tuple[List[Tuple[int, ...]], List[DataType]]:
        raise NotImplementedError

    def weight_specs(self) -> List[WeightSpec]:
        return []

    def state_specs(self) -> List[WeightSpec]:
        """Non-trainable per-op state (JAX `Op.state_specs`)."""
        return []

    # -- cost hooks (the simulator's, search/simulator.py) ----------------
    def flops(self) -> float:
        """Forward FLOPs (JAX `Op.flops`); 0 for an op its bytes bound."""
        return 0.0

    def bytes_accessed(self) -> float:
        """Bytes of every input, output and weight, once each (JAX
        `Op.bytes_accessed`)."""
        n = sum(t.num_elements() * t.dtype.itemsize for t in self.inputs)
        n += sum(t.num_elements() * t.dtype.itemsize for t in self.outputs)
        n += sum(w.num_elements() * w.dtype.itemsize for w in self.weights)
        return float(n)

    def param_key(self) -> Tuple:
        return (self.op_type, tuple(t.guid for t in self.inputs),
                _freeze(self.params))

    def cost_key(self) -> Tuple:
        """Shape-based identity for cost caching (JAX `Op.cost_key`):
        identical ops (the 12 layers of a BERT stack, the same op in a
        fresh compile) share one key."""
        return (self.op_type,
                tuple((t.dims, t.dtype) for t in self.inputs),
                _freeze(self.params))

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
        self._cast.clear()
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
        take gradients. An op this rank does not hold (`held`) draws its
        weights, so the stream stays the same on every rank, and keeps
        none."""
        for ws in self.specs:
            val = ws.initializer(generator, ws.dims, ws.dtype.torch_dtype)
            if not self.held:
                continue
            val = self.local_value(ws.name, val)
            self.register_parameter(
                ws.name, nn.Parameter(val.to(device).contiguous(),
                                      requires_grad=trainable))
        for sv in self.state_vars:
            self.register_buffer(sv.name, sv.initializer(
                generator, sv.dims, sv.dtype.torch_dtype).to(device))
        self._cast.clear()

    def set_weight(self, name: str, value: torch.Tensor) -> None:
        """Load the full weight `name` (this position keeps its piece;
        nothing where it does not hold the op)."""
        if not self.held:
            return
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

    def writes_state(self, ctx: LoweringContext) -> bool:
        """Whether this walk writes the op's state buffers: a training
        walk, or a walk handed `state` under this op's name (`model.state`,
        whose entries are these buffers: the JAX package keeps the updates
        of a walk given `model.state`), unless `ctx.write_state` is off
        (the manual backward). Eval, predict and the serving walks, which
        hold only KV caches, read them and write nothing."""
        if not ctx.write_state:
            return False
        return ctx.mode == CompMode.COMP_MODE_TRAINING or self.name in ctx.state

    def __repr__(self):
        """JAX `Op.__repr__` (what `FFModel.print_layers` prints)."""
        ins = ",".join(str(t.dims) for t in self.inputs)
        outs = ",".join(str(t.dims) for t in self.outputs)
        return f"{self.op_type.value}[{self.name}]({ins})->({outs})"


# registry: OpType -> Op subclass
OP_REGISTRY: Dict[OpType, type] = {}


def register_op(cls):
    OP_REGISTRY[cls.op_type] = cls
    return cls
