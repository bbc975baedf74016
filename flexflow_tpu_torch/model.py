"""FFModel: the layer API, compile with the strategy search and the plan
analysis, fit, eval, predict and the manual loop on one torch device or
on a mesh of torch.distributed ranks (flexflow_tpu/model.py), with the
hooks the elastic coordinator's loop drives (elastic/coordinator.py:
`_prep_step_batch`, `_next_rng`, `_elastic_step`, `_commit_step`).

Op names follow the JAX package's scheme (an explicit name, else
`<op type>_<n>` per model), so the same builder code gives the same op
and weight names in both packages and `params_from_jax` can carry a JAX
model's weights across.
"""
from __future__ import annotations

import logging
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import ops as _ops  # noqa: F401  (registers every op type)
from .parallel import parallel_ops as _parallel_ops
from .config import FFConfig
from .core.graph import Graph
from .core.machine import MachineView, Mesh, check_axes, make_mesh
from .core.op import OP_REGISTRY, Op
from .core.tensor import ParallelDim, ParallelTensorShape, Tensor
from .ffconst import (ActiMode, AggrMode, CompMode, DataType, LossType,
                      MetricsType, OpType, PoolType)
from .kernels.registry import KERNELS
from .obs.tracing import get_tracer
from .ops.elementwise import POINTWISE_TYPES
from .runtime.collectives import gather_shards
from .runtime.executor import Executor, MultiStep
from .runtime.losses import Loss
from .runtime.metrics import Metrics, PerfMetrics
from .runtime.optimizers import Optimizer, SGDOptimizer
from .search.simulator import AP_CAPABLE, TP_CAPABLE, TP_WEIGHT_SHARD_DIMS

_log = logging.getLogger("flexflow_tpu_torch.model")

# ops that compute each position of a (B, L, ...) value alone, so they run
# on a rank's positions of a `seq` axis (FFModel._assign_strategy); norms
# and softmax only over other dims than the positions
SEQ_LOCAL = POINTWISE_TYPES | {
    OpType.DROPOUT, OpType.LINEAR, OpType.EMBEDDING, OpType.LAYERNORM,
    OpType.RMSNORM, OpType.SOFTMAX, OpType.MULTIHEAD_ATTENTION}
# ops beside convolutions and pools that run on a rank's H rows of an
# `attr` axis
ATTR_LOCAL = POINTWISE_TYPES | {OpType.DROPOUT, OpType.BATCHNORM}


def _seq_local_type(op: Op) -> bool:
    """Whether `op` computes each position alone (see SEQ_LOCAL); attention
    does through the sequence-parallel kernels, where it has no
    dropout."""
    t = op.op_type
    if t == OpType.MULTIHEAD_ATTENTION:
        return not op.params.get("dropout", 0.0) > 0
    if t in (OpType.LAYERNORM, OpType.RMSNORM):
        rank = len(op.inputs[0].dims)
        return all(a % rank != 1 for a in op.params["axes"])
    if t == OpType.SOFTMAX:
        return op.params.get("axis", -1) % len(op.inputs[0].dims) != 1
    return t in SEQ_LOCAL


class FFModel:
    def __init__(self, config: Optional[FFConfig] = None):
        self.config = config or FFConfig()
        self.ops: List[Op] = []
        self.input_ops: List[Op] = []
        self.final_tensor: Optional[Tensor] = None
        self.graph: Optional[Graph] = None
        self.executor: Optional[Executor] = None
        self.optimizer: Optional[Optimizer] = None
        self.opt_state: Optional[dict] = None
        self.comp_mode: Optional[CompMode] = None
        self.mesh: Optional[Mesh] = None
        # the plan compile chose: the mesh axes, the per-op strategies by
        # op guid (None: every op at the mesh-wide default), the search's
        # result when it searched, and why this rank holds no position
        # (None on the mesh or on one device)
        self.parallel_axes: Dict[str, int] = {}
        self._op_strategies = None
        self.search_result = None
        # the rank that ran the search (the live ranks' leader), when one
        # ran under torch.distributed
        self.search_leader: Optional[int] = None
        self.outside_mesh: Optional[str] = None
        # the ranks compile ran on (`config.device_ids`, default the
        # world's; None without torch.distributed): a mesh-less model
        # compiled on several of them is a whole copy on each
        self.live_ranks: Optional[List[int]] = None
        # the last fit() call's StepStats (obs/stepstats.py, JAX
        # `step_stats`): a record per committed step or K-step dispatch,
        # with TFLOP/s and MFU against the machine spec's peak
        self.step_stats = None
        self._name_counts: Dict[OpType, int] = {}
        self._used_names: set = set()
        self.label_tensor: Optional[Tensor] = None
        self._dataloaders: list = []
        # fit(steps_per_execution=K)'s dispatch per K, and fit(accum_steps)'s
        # step; built at first use, dropped by compile()
        self._multi_steps: Dict[int, MultiStep] = {}
        self._accum_step = None
        # optimizer steps taken (a K-step dispatch counts K), which a
        # recompile trigger reads; the RecompileState fit consults before
        # each step or dispatch (runtime/recompile.py)
        self._step_count = 0
        self._recompile_state = None
        self.loss: Optional[Loss] = None
        self.metrics: Optional[Metrics] = None
        # fit's running PerfMetrics, reset at each epoch (JAX
        # `perf_metrics`)
        self.perf_metrics = PerfMetrics()
        # (op name, weight name, fn) terms of the training loss
        self.weight_regularizers: List[Tuple[str, str, object]] = []
        self._reg_fn = None
        # the manual loop's batch, prediction, generator states, gradients
        # and per-seq_length steps
        self._manual: Dict[str, object] = {}
        # why this model refuses to train (serving/optimize.py
        # fold_batchnorm sets it), None while it may
        self._inference_only: Optional[str] = None

    def add_weight_regularizer(self, op_name: str, weight_name: str,
                               fn) -> None:
        """Add fn(weight) to the training loss (JAX
        `add_weight_regularizer`; Keras' kernel_regularizer): `fn` maps
        the f32 master tensor to a 0-d tensor. Every dispatch of `fit`
        (eager, K-step graph, accumulation) adds it; eval's loss and the
        manual loop's backward do not, as in JAX. Call before compile."""
        self.weight_regularizers.append((op_name, weight_name, fn))

    @property
    def device(self) -> torch.device:
        """`config.device`; on a mesh, this rank's device (as
        runtime/distributed.py initialize chose it)."""
        if self.mesh is not None:
            return self.mesh.device
        return torch.device(self.config.device)

    # -- tensor & op creation ---------------------------------------------
    def create_tensor(self, dims: Sequence[int],
                      dtype: DataType = DataType.DT_FLOAT,
                      create_grad: bool = True, name: str = "") -> Tensor:
        """A graph input. `create_grad` is recorded on the tensor, as in
        JAX; inputs take no gradients in either package."""
        op = OP_REGISTRY[OpType.INPUT](
            self, [], name=name or f"input_{len(self.input_ops)}",
            dims=tuple(dims), dtype=dtype)
        self.ops.append(op)
        self.input_ops.append(op)
        t = op.outputs[0]
        t.create_gradients = create_grad
        return t

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

    def _unary(self, op_type, x, name="", **params) -> Tensor:
        return self._add_op(op_type, [x], name, **params).outputs[0]

    def _binary(self, op_type, x, y, name="") -> Tensor:
        return self._add_op(op_type, [x, y], name).outputs[0]

    # -- elementwise (flexflow_tpu/model.py exp ... gelu) -------------------
    def exp(self, x, name=""):
        return self._unary(OpType.EXP, x, name)

    def sin(self, x, name=""):
        return self._unary(OpType.SIN, x, name)

    def cos(self, x, name=""):
        return self._unary(OpType.COS, x, name)

    def pow(self, x, exponent, name=""):
        return self._unary(OpType.POW, x, name, exponent=exponent)

    def rsqrt(self, x, name=""):
        return self._unary(OpType.RSQRT, x, name)

    def add(self, x, y, name=""):
        return self._binary(OpType.EW_ADD, x, y, name)

    def subtract(self, x, y, name=""):
        return self._binary(OpType.EW_SUB, x, y, name)

    def multiply(self, x, y, name=""):
        return self._binary(OpType.EW_MUL, x, y, name)

    def divide(self, x, y, name=""):
        return self._binary(OpType.EW_DIV, x, y, name)

    def max(self, x, y, name=""):
        return self._binary(OpType.EW_MAX, x, y, name)

    def min(self, x, y, name=""):
        return self._binary(OpType.EW_MIN, x, y, name)

    def scalar_multiply(self, x, scalar, inplace=True, name=""):
        return self._unary(OpType.SCALAR_MULTIPLY, x, name, scalar=scalar)

    def scalar_add(self, x, scalar, inplace=True, name=""):
        return self._unary(OpType.SCALAR_ADD, x, name, scalar=scalar)

    def scalar_sub(self, x, scalar, inplace=True, name=""):
        return self._unary(OpType.SCALAR_SUB, x, name, scalar=scalar)

    def scalar_true_divide(self, x, scalar, inplace=True, name=""):
        return self._unary(OpType.SCALAR_TRUE_DIV, x, name, scalar=scalar)

    def relu(self, x, name=""):
        return self._unary(OpType.RELU, x, name)

    def identity(self, x, name=""):
        return self._unary(OpType.IDENTITY, x, name)

    def sigmoid(self, x, name=""):
        return self._unary(OpType.SIGMOID, x, name)

    def tanh(self, x, name=""):
        return self._unary(OpType.TANH, x, name)

    def elu(self, x, inplace=True, name=""):
        return self._unary(OpType.ELU, x, name)

    def gelu(self, x, name=""):
        return self._unary(OpType.GELU, x, name)

    def cast(self, input: Tensor, dtype: DataType, name: str = "") -> Tensor:
        return self._unary(OpType.CAST, input, name, dtype=dtype)

    # -- shape ops, reductions, TopK, BatchMatmul ---------------------------
    def concat(self, tensors: Sequence[Tensor], axis: int,
               name: str = "") -> Tensor:
        return self._add_op(OpType.CONCAT, list(tensors), name,
                            axis=axis).outputs[0]

    def split(self, input: Tensor, sizes, axis: int,
              name: str = "") -> List[Tensor]:
        if isinstance(sizes, int):
            if input.dims[axis] % sizes:
                raise ValueError(f"split: dim {axis} of {input.dims} is not "
                                 f"divisible by {sizes}")
            sizes = [input.dims[axis] // sizes] * sizes
        return self._add_op(OpType.SPLIT, [input], name, sizes=tuple(sizes),
                            axis=axis).outputs

    def reshape(self, input: Tensor, shape: Sequence[int],
                name: str = "") -> Tensor:
        return self._unary(OpType.RESHAPE, input, name, shape=tuple(shape))

    def transpose(self, input: Tensor, perm: Sequence[int],
                  name: str = "") -> Tensor:
        return self._unary(OpType.TRANSPOSE, input, name, perm=tuple(perm))

    def reverse(self, input: Tensor, axis: int, name: str = "") -> Tensor:
        return self._unary(OpType.REVERSE, input, name, axis=axis)

    def gather(self, input: Tensor, index: Tensor, dim: int = 0,
               name: str = "") -> Tensor:
        return self._add_op(OpType.GATHER, [input, index], name,
                            axis=dim).outputs[0]

    def reduce_sum(self, input: Tensor, axes: Sequence[int],
                   keepdims: bool = False, name: str = "") -> Tensor:
        return self._unary(OpType.REDUCE_SUM, input, name, axes=tuple(axes),
                           keepdims=keepdims)

    def mean(self, input: Tensor, dims: Sequence[int],
             keepdims: bool = False, name: str = "") -> Tensor:
        return self._unary(OpType.MEAN, input, name, axes=tuple(dims),
                           keepdims=keepdims)

    def batch_matmul(self, A: Tensor, B: Tensor, a_seq_length_dim: int = -1,
                     b_seq_length_dim: int = -1, name: str = "") -> Tensor:
        return self._add_op(
            OpType.BATCHMATMUL, [A, B], name,
            a_seq_length_dim=a_seq_length_dim,
            b_seq_length_dim=b_seq_length_dim).outputs[0]

    def top_k(self, input: Tensor, k: int, sorted: bool = False,
              name: str = "") -> Tuple[Tensor, Tensor]:
        outs = self._add_op(OpType.TOPK, [input], name, k=k,
                            sorted=sorted).outputs
        return outs[0], outs[1]

    # -- mixture of experts (ops/moe.py) -------------------------------------
    def group_by(self, input: Tensor, assign: Tensor, n: int,
                 alpha: float = 1.0, name: str = "") -> List[Tensor]:
        return self._add_op(OpType.GROUP_BY, [input, assign], name, n=n,
                            alpha=alpha).outputs

    def aggregate(self, gate_preds: Tensor, gate_assign: Tensor,
                  true_gate_assign: Tensor, full_gate_grads: Tensor,
                  exp_preds: Sequence[Tensor], n: int,
                  lambda_bal: float = 0.0, name: str = "") -> Tensor:
        ins = [gate_preds, gate_assign, true_gate_assign,
               full_gate_grads] + list(exp_preds)
        return self._add_op(OpType.AGGREGATE, ins, name, n=n,
                            lambda_bal=lambda_bal).outputs[0]

    def aggregate_spec(self, inputs: Sequence[Tensor], n: int,
                       lambda_bal: float = 0.0, name: str = "") -> Tensor:
        return self._add_op(OpType.AGGREGATE_SPEC, list(inputs), name, n=n,
                            lambda_bal=lambda_bal).outputs[0]

    def cache(self, input: Tensor, num_batches: int = 1,
              name: str = "") -> Tensor:
        return self._unary(OpType.CACHE, input, name,
                           num_batches=num_batches)

    def experts(self, input: Tensor, gate_preds: Tensor, assign: Tensor,
                num_exp: int, out_dim: int, alpha: float = 2.0,
                lambda_bal: float = 0.0, full_gate: Optional[Tensor] = None,
                activation: ActiMode = ActiMode.AC_MODE_RELU,
                kernel_initializer=None, name: str = "") -> Tensor:
        """The fused expert block (ops/moe.py ExpertsOp)."""
        ins = [input, gate_preds, assign]
        if full_gate is not None:
            ins.append(full_gate)
        return self._add_op(
            OpType.EXPERTS, ins, name, n=num_exp, out_dim=out_dim,
            alpha=alpha, lambda_bal=lambda_bal, activation=activation,
            kernel_initializer=kernel_initializer).outputs[0]

    def moe(self, input: Tensor, num_exp: int, num_select: int,
            expert_hidden_size: int, alpha: float = 2.0,
            lambda_bal: float = 0.0, fused: bool = False,
            name: str = "") -> Tensor:
        """MoE block (JAX `FFModel.moe`): gate dense, softmax, top_k, then
        the fused experts op, or group_by -> a dense per expert ->
        aggregate. The unfused path flattens an input of rank > 2 to
        tokens and restores it; the fused one keeps it (ExpertsOp flattens
        inside), so a serving walk at other leading dims runs it."""
        orig_dims = None
        if len(input.dims) > 2 and not fused:
            orig_dims = input.dims
            input = self.reshape(input, [int(np.prod(input.dims[:-1])),
                                         input.dims[-1]],
                                 name=f"{name}_tokens")
        gate = self.dense(input, num_exp, ActiMode.AC_MODE_NONE,
                          name=f"{name}_gate")
        gate = self.softmax(gate)
        topk_out, topk_idx = self.top_k(gate, num_select)
        if fused:
            out = self.experts(input, topk_out, topk_idx, num_exp,
                               expert_hidden_size, alpha, lambda_bal,
                               full_gate=gate, name=f"{name}_experts")
        else:
            grouped = self.group_by(input, topk_idx, num_exp, alpha)
            exp_preds = [self.dense(g, expert_hidden_size,
                                    ActiMode.AC_MODE_RELU,
                                    name=f"{name}_exp{i}")
                         for i, g in enumerate(grouped)]
            out = self.aggregate(topk_out, topk_idx, topk_idx, gate,
                                 exp_preds, num_exp, lambda_bal)
        if orig_dims is not None:
            out = self.reshape(out, list(orig_dims[:-1])
                               + [expert_hidden_size],
                               name=f"{name}_untokens")
        return out

    # -- explicit parallel ops (reference: src/parallel_ops/;
    # parallel/parallel_ops.py says what each does on a mesh rank) ---------
    def repartition(self, input: Tensor, dim: int, degree: int,
                    axis: Optional[str] = None, name: str = "") -> Tensor:
        return self._unary(OpType.REPARTITION, input, name, dim=dim,
                           degree=degree, axis=axis)

    def combine(self, input: Tensor, dim: int, degree: int = 1,
                name: str = "") -> Tensor:
        return self._unary(OpType.COMBINE, input, name, dim=dim,
                           degree=degree)

    def replicate(self, input: Tensor, degree: int = 1,
                  name: str = "") -> Tensor:
        return self._unary(OpType.REPLICATE, input, name, degree=degree)

    def reduction(self, input: Tensor, degree: int = 1,
                  name: str = "") -> Tensor:
        return self._unary(OpType.REDUCTION, input, name, degree=degree)

    def allreduce(self, input: Tensor, axis_name: str = "data",
                  name: str = "") -> Tensor:
        return self._unary(OpType.ALLREDUCE, input, name,
                           axis_name=axis_name)

    def fused_parallel(self, input: Tensor, descriptors: Sequence[dict],
                       name: str = "") -> Tensor:
        """Chain of parallel-op descriptors applied as ONE reshard
        (reference: src/parallel_ops/fused_parallel_op.cc). Each
        descriptor: {"type": "partition"|"combine"|"replicate", "dim": int,
        "degree": int, "axis": Optional[str]}."""
        return self._unary(OpType.FUSED_PARALLEL, input, name,
                           descriptors=list(descriptors))

    def create_constant(self, value, trainable: bool = False,
                        dtype: Optional[DataType] = None,
                        name: str = "") -> Tensor:
        """A fixed tensor value as a graph source; trainable=True makes it
        a weight ("value") that takes gradients."""
        value = np.asarray(value)
        if dtype is not None:
            value = value.astype(dtype.host_np_dtype)
        return self._add_op(OpType.WEIGHT, [], name, value=value,
                            trainable=trainable, dtype=dtype).outputs[0]

    def dense(self, input: Tensor, out_dim: int,
              activation: ActiMode = ActiMode.AC_MODE_NONE,
              use_bias: bool = True, datatype: Optional[DataType] = None,
              shared_op=None, kernel_initializer=None, bias_initializer=None,
              name: str = "") -> Tensor:
        """`shared_op` is accepted and ignored, as in JAX."""
        return self._add_op(
            OpType.LINEAR, [input], name, out_dim=out_dim,
            activation=activation, use_bias=use_bias, dtype=datatype,
            kernel_initializer=kernel_initializer,
            bias_initializer=bias_initializer).outputs[0]

    def conv2d(self, input: Tensor, out_channels: int, kernel_h: int,
               kernel_w: int, stride_h: int, stride_w: int, padding_h: int,
               padding_w: int, activation: ActiMode = ActiMode.AC_MODE_NONE,
               groups: int = 1, use_bias: bool = True, shared_op=None,
               kernel_initializer=None, bias_initializer=None,
               name: str = "") -> Tensor:
        return self._add_op(
            OpType.CONV2D, [input], name, out_channels=out_channels,
            kernel_h=kernel_h, kernel_w=kernel_w, stride_h=stride_h,
            stride_w=stride_w, padding_h=padding_h, padding_w=padding_w,
            activation=activation, groups=groups, use_bias=use_bias,
            kernel_initializer=kernel_initializer,
            bias_initializer=bias_initializer).outputs[0]

    def pool2d(self, input: Tensor, kernel_h: int, kernel_w: int,
               stride_h: int, stride_w: int, padding_h: int, padding_w: int,
               pool_type: PoolType = PoolType.POOL_MAX,
               activation: ActiMode = ActiMode.AC_MODE_NONE,
               name: str = "") -> Tensor:
        return self._add_op(
            OpType.POOL2D, [input], name, kernel_h=kernel_h,
            kernel_w=kernel_w, stride_h=stride_h, stride_w=stride_w,
            padding_h=padding_h, padding_w=padding_w, pool_type=pool_type,
            activation=activation).outputs[0]

    def batch_norm(self, input: Tensor, relu: bool = True,
                   name: str = "") -> Tensor:
        return self._unary(OpType.BATCHNORM, input, name, relu=relu)

    def flat(self, input: Tensor, name: str = "") -> Tensor:
        return self._unary(OpType.FLAT, input, name)

    def dropout(self, input: Tensor, rate: float = 0.5, seed: int = 0,
                name: str = "") -> Tensor:
        """Inverted dropout in training (ops/norm.py DropoutOp); `seed` is
        kept for the API, as in the JAX package: the masks come from the
        executor's generator, seeded from `config.seed`."""
        return self._unary(OpType.DROPOUT, input, name, rate=rate, seed=seed)

    def lstm(self, input: Tensor, hidden_size: int,
             return_sequences: bool = True, name: str = "") -> Tensor:
        return self._unary(OpType.LSTM, input, name, hidden_size=hidden_size,
                           return_sequences=return_sequences)

    def layer_norm(self, input: Tensor, axes: Sequence[int],
                   elementwise_affine: bool = True, eps: float = 1e-5,
                   name: str = "") -> Tensor:
        axes = [a if a >= 0 else input.num_dims + a for a in axes]
        return self._add_op(
            OpType.LAYERNORM, [input], name, axes=tuple(axes),
            elementwise_affine=elementwise_affine, eps=eps).outputs[0]

    def rms_norm(self, input: Tensor, axes: Sequence[int],
                 elementwise_affine: bool = True, eps: float = 1e-6,
                 name: str = "") -> Tensor:
        axes = [a if a >= 0 else input.num_dims + a for a in axes]
        return self._add_op(
            OpType.RMSNORM, [input], name, axes=tuple(axes),
            elementwise_affine=elementwise_affine, eps=eps).outputs[0]

    def softmax(self, input: Tensor, axis: int = -1,
                name: str = "") -> Tensor:
        return self._add_op(OpType.SOFTMAX, [input], name,
                            axis=axis).outputs[0]

    def embedding(self, input: Tensor, num_entries: int, out_dim: int,
                  aggr: AggrMode = AggrMode.AGGR_MODE_NONE,
                  dtype: DataType = DataType.DT_FLOAT, shared_op=None,
                  kernel_initializer=None, name: str = "") -> Tensor:
        """`shared_op` is accepted and ignored, as in JAX."""
        return self._add_op(
            OpType.EMBEDDING, [input], name, num_entries=num_entries,
            out_dim=out_dim, aggr=aggr, dtype=dtype,
            kernel_initializer=kernel_initializer).outputs[0]

    def multihead_attention(self, query: Tensor, key: Tensor, value: Tensor,
                            embed_dim: int, num_heads: int, kdim: int = 0,
                            vdim: int = 0, dropout: float = 0.0,
                            bias: bool = True, add_bias_kv: bool = False,
                            add_zero_attn: bool = False,
                            causal: bool = False,
                            sequence_parallel: bool = False,
                            sequence_parallel_mode: str = "ring",
                            use_flash: Optional[bool] = None,
                            kernel_initializer=None,
                            name: str = "") -> Tensor:
        """use_flash: True / False force the full-sequence path to the
        flash kernel / the einsum reference core; None leaves it to the
        kernel registry. dropout > 0 drops out the probabilities in
        training through the einsum core (ops/attention.py);
        sequence_parallel (with a `seq` mesh axis) runs ring attention,
        or Ulysses under sequence_parallel_mode "ulysses" / "all_to_all"
        (ops/attention.py). `add_bias_kv` and `add_zero_attn` are recorded
        in the op's params and change nothing, as in the JAX package's
        lowering, which reads neither."""
        return self._add_op(
            OpType.MULTIHEAD_ATTENTION, [query, key, value], name,
            embed_dim=embed_dim, num_heads=num_heads, kdim=kdim or None,
            vdim=vdim or None, dropout=dropout, bias=bias,
            add_bias_kv=add_bias_kv, add_zero_attn=add_zero_attn,
            causal=causal, sequence_parallel=sequence_parallel,
            sequence_parallel_mode=sequence_parallel_mode,
            use_flash=use_flash,
            kernel_initializer=kernel_initializer).outputs[0]

    # -- compile ----------------------------------------------------------
    def compile(self, optimizer: Optional[Optimizer] = None,
                loss_type: LossType =
                LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                metrics: Sequence[MetricsType] = (),
                comp_mode: CompMode = CompMode.COMP_MODE_TRAINING,
                parallel_axes: Optional[Dict[str, int]] = None,
                generator: Optional[torch.Generator] = None) -> None:
        """Build the graph, choose the plan, build the executor and draw
        every weight from `generator` (default: a CPU generator seeded 0)
        onto `config.device`, and the ops' state (`state`) from its
        initializers.

        The plan (JAX `_compile_inner`): `parallel_axes` when given; else
        `config.import_strategy_file`'s per-op strategies; else, on a
        machine of n > 1 devices (`config.total_devices`) with
        `search_budget` > 0 (or the MCMC search's budget), the Unity
        search's (search/unity.py; costs measured on the card by
        default, search/simulator.py OpCostCache), with its graph
        rewrites; else `{"data": n}` on a world of n > 1 ranks. Under
        torch.distributed the leader (the first rank of
        `config.device_ids`, default rank 0) searches and broadcasts the
        plan (the per-op strategies by op name, the mesh axes and the
        rewrites); the other ranks replay the rewrites and adopt it, so
        every rank holds the same plan. Rewrites run before any weight is drawn. The
        plan analysis (analysis/, `analyze_plan`) gates the plan under
        `config.plan_analysis` ("error": PlanAnalysisError on an error
        diagnostic); its findings go to `analysis_events`.

        A plan trains on a mesh of torch.distributed ranks, one process
        a position (runtime/distributed.py initialize, before compile, on
        every rank), over the first prod(axes) ranks of
        `config.device_ids` (default: the world's); a rank past the mesh
        holds no position (`outside_mesh` says so), and its fit, eval and
        predict raise. Each data rank takes its slice of the batch; an op
        whose plan dp is 1 computes the whole batch (runtime/executor.py);
        the TP-capable ops whose plan tp is the `model` degree shard their
        weights over it as the JAX package's `_assign_tp_weights` does
        (row-parallel for a `tp_row` linear), the others keep theirs
        whole; the `expert`, `attr`, `seq` and `stage` axes are assigned
        as `_assign_strategy` says. Every rank draws the whole model from
        the same generator and keeps its shards, so a mesh run starts
        from the one-device run's weights. In inference mode a mesh draws
        and shards the weights as training mode does, and the model
        serves on it (`predict`, serving/model.py `InferenceModel`,
        serving/generate.py `GenerativeSession`, every rank calling with
        the same inputs). In either mode the
        loss, the metrics, eval's step and the forward walks of `predict`
        and the manual loop are built (JAX builds them in every mode); in
        training mode (the default, as in the JAX package) the weights
        take gradients, `optimizer` defaults to SGD at
        `config.learning_rate`, and the train step and the optimizer
        state are built too; in inference mode neither is, on one device
        or a mesh, and `fit` raises. The whole pass is one `compile` span, with
        the search, the analysis and the step build inside it."""
        with get_tracer().span("compile", ops=len(self.ops)):
            self._compile_inner(optimizer, loss_type, metrics, comp_mode,
                                parallel_axes, generator)

    def _compile_inner(self, optimizer, loss_type, metrics, comp_mode,
                       parallel_axes, generator) -> None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        # the kernel tier: this model's --kernel-impl becomes the default
        # of the config-less consumers (the loss and metric reductions),
        # before the search, which prices the same selections
        KERNELS.configure(self.config)
        self.live_ranks = self._live_ranks()
        self.comp_mode = comp_mode
        training = comp_mode == CompMode.COMP_MODE_TRAINING
        if training:
            self.optimizer = optimizer or SGDOptimizer(
                self, lr=self.config.learning_rate)
        # the memory model's per-weight optimizer state, which the search
        # reads (JAX compile): Adam param + m + v, momentum SGD param + v,
        # plain SGD param
        from .runtime.optimizers import AdamOptimizer

        opt = self.optimizer if training else optimizer
        self.config.optimizer_state_factor = (
            3.0 if isinstance(opt, AdamOptimizer)
            else 2.0 if getattr(opt, "momentum", 0.0) else 1.0)
        self.graph = Graph(self.ops)
        order = self.graph.topo_order()
        self.final_tensor = self.final_tensor or order[-1].outputs[0]
        self.parallel_axes = self._choose_plan(parallel_axes)
        # rewrites may have removed, fused or created ops: follow the
        # tensor aliases and take the op list from the rewritten graph
        self.final_tensor = self.graph.resolve_tensor(self.final_tensor)
        order = self.graph.topo_order()
        # the op list in the graph's order, as JAX's compile leaves it
        # (summary, get_layers and get_layer_by_id read it)
        self.ops = list(order)
        axes = self._check_executable(self.parallel_axes)
        self.mesh, self.outside_mesh, mesh = None, None, None
        if axes:
            mesh = make_mesh(axes, self.live_ranks)
            if mesh.device.type != torch.device(self.config.device).type:
                raise ValueError(
                    f"config.device={self.config.device!r}, but this rank "
                    f"was initialized on {mesh.device}")
        self._plan_reductions()
        self._run_plan_analysis()
        self._plan_grad_sync(mesh)
        if mesh is not None:
            if not mesh.holds_position:
                self.outside_mesh = (
                    f"rank {mesh.rank} is past the plan's mesh {axes} "
                    f"(ranks {mesh.mesh_ranks}): it holds no "
                    "position and trains nothing")
                _log.warning("compile: %s", self.outside_mesh)
                self.executor = None
                return
            self.mesh = mesh
        self.executor = Executor(self.graph, self.config, self.mesh)
        self.executor.grad_sync_lowering = self._grad_sync
        self._multi_steps, self._accum_step = {}, None
        self._assign_strategy(order)
        for op in order:
            op.init_weights(generator, self.device, trainable=training)
        self.loss = Loss(loss_type)
        self.metrics = Metrics(loss_type, list(metrics))
        # the label mirrors the final tensor (JAX `_label_dims`)
        fd = self.final_tensor.dims
        self.label_tensor = Tensor(
            fd[:-1] + (1,) if loss_type ==
            LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY else fd,
            self._label_dtype(), name="label")
        self._reg_fn = self._make_reg_fn()
        self._build_steps()
        if training:
            self.opt_state = self.optimizer.init_state(
                self.executor.parameters())
        if self.config.export_strategy_computation_graph_file:
            self.graph.export_dot(
                self.config.export_strategy_computation_graph_file)
        if self.config.export_strategy_task_graph_file:
            self._export_task_graph(
                self.config.export_strategy_task_graph_file)

    # -- the plan ---------------------------------------------------------
    def _choose_plan(self, parallel_axes) -> Dict[str, int]:
        """The mesh axes, and the per-op strategies in `_op_strategies`
        (JAX `_compile_inner`'s strategy selection): explicit axes, an
        imported strategy file, the search, or the default."""
        from .runtime import distributed

        n_dev = self.config.total_devices
        # the default data axis needs the ranks to run it on
        ranks = n_dev if distributed.is_initialized() else 1
        self.search_result = None
        self._op_strategies = None
        if parallel_axes is None:
            cfg = self.config
            if cfg.import_strategy_file:
                from .search.unity import rewrite_and_import_strategy

                strategies, axes = rewrite_and_import_strategy(
                    self.graph, cfg, cfg.import_strategy_file)
                self._op_strategies = strategies
                parallel_axes = axes
            elif ((cfg.search_budget > 0
                   or (cfg.strategy_search == "mcmc"
                       and (cfg.mcmc_budget or 0) > 0))
                  and n_dev > 1 and not cfg.only_data_parallel):
                self.search_result = self._search(n_dev)
                self._op_strategies = self.search_result.strategies
                parallel_axes = self.search_result.mesh_axes
            else:
                parallel_axes = {"data": ranks} if ranks > 1 else {}
        if self.config.only_data_parallel:
            parallel_axes = {"data": ranks} if ranks > 1 else {}
        return dict(parallel_axes)

    def _live_ranks(self) -> Optional[List[int]]:
        """The ranks this model runs on: `config.device_ids`, else every
        rank of the world (None without torch.distributed). Raises on a
        rank outside them, which takes part in nothing."""
        import torch.distributed as dist

        from .runtime import distributed

        if not distributed.is_initialized():
            return None
        ids = self.config.device_ids
        ranks = (list(range(dist.get_world_size())) if ids is None
                 else [int(r) for r in ids])
        if dist.get_rank() not in ranks:
            raise ValueError(f"rank {dist.get_rank()} is not one of "
                             f"config.device_ids {ranks}")
        return ranks

    def _search(self, n_dev: int):
        """The search's result on every rank: the leader (the first of
        the live ranks, `live_ranks`) searches (unity or mcmc) and
        broadcasts the plan over their group before any mesh group is
        made; the other ranks replay its rewrites and adopt it
        (search/unity.py `result_from_dict`). A failed search raises on
        every rank."""
        import torch.distributed as dist

        from .runtime import distributed
        from .search.unity import export_strategy, result_from_dict, \
            result_to_dict

        ranks = self.live_ranks
        shared = ranks is not None and len(ranks) > 1
        leader = ranks[0] if shared else 0
        rank = dist.get_rank() if shared else 0
        group = distributed.group_of(ranks) if shared else None
        result, payload = None, None
        if rank == leader:
            try:
                result = self._search_here(n_dev)
                payload = {"plan": result_to_dict(result, self.graph),
                           "log": list(result.log)}
            except Exception as exc:
                if shared:  # the other ranks wait in the broadcast
                    dist.broadcast_object_list(
                        [{"error": f"{type(exc).__name__}: {exc}"}],
                        src=leader, group=group)
                raise
        if shared:
            box = [payload]
            dist.broadcast_object_list(box, src=leader, group=group)
            payload = box[0]
            if "error" in payload:
                raise RuntimeError(
                    f"rank {leader}'s strategy search failed: "
                    f"{payload['error']}")
            if rank != leader:
                result = result_from_dict(self.graph, self.config,
                                          payload["plan"], payload["log"])
        self.search_leader = leader
        if self.config.export_strategy_file and rank == leader:
            export_strategy(result, self.graph,
                            self.config.export_strategy_file)
        return result

    def _search_here(self, n_dev: int):
        from .search.machine_model import make_machine_model

        machine = make_machine_model(self.config, n_dev)
        if self.config.strategy_search == "mcmc":
            from .search.mcmc import mcmc_search

            return mcmc_search(self.graph, self.config, machine,
                               self.config.batch_size, n_dev)
        from .search.unity import unity_optimize

        return unity_optimize(self.graph, self.config, machine,
                              self.config.batch_size, n_dev)

    def _check_executable(self, axes: Dict[str, int]) -> Dict[str, int]:
        """The plan's axes of size > 1 (core/machine.py check_axes); raises
        for what the port's executor cannot run yet: an op degree between
        1 and its axis (JAX's menu offers only those two), and a `stage`
        axis beside any but `data`."""
        live = check_axes(axes)
        if live.get("stage", 1) > 1 and set(live) - {"data", "stage"}:
            raise NotImplementedError(
                f"parallel_axes={axes}: a stage axis beside "
                f"{sorted(set(live) - {'data', 'stage'})} is not ported yet "
                "(ROADMAP A8); it runs beside `data`")
        for op in self.graph.topo_order():
            s = (self._op_strategies or {}).get(op.guid)
            if s is None:
                continue
            for field, axis in (("dp", "data"), ("tp", "model"),
                                ("ep", "expert"), ("ap", "attr"),
                                ("sp", "seq")):
                size = live.get(axis, 1)
                if min(getattr(s, field), size) not in (1, size):
                    raise NotImplementedError(
                        f"{op.name}: {field}={getattr(s, field)} on the mesh "
                        f"{live}: an op degree between 1 and its axis is not "
                        "ported yet (ROADMAP A8)")
        return live

    def _plan_reductions(self) -> None:
        """The per-tier reduction decomposition of the chosen plan on a
        hierarchical machine (JAX compile): recorded for the analysis and
        the strategy export, and which the executor runs under
        `collective_lowering` (`_plan_grad_sync`), and the predicted grad-sync overlap split on
        the `ff_grad_sync_overlap_us` gauge."""
        self._reduction_plan = None
        self._sync_overlap = None
        self._grad_sync = None
        n_dev = self.config.total_devices
        sr = self.search_result
        if sr is not None and sr.reduction_strategies:
            self._reduction_plan = sr.reduction_strategies
            if sr.exposed_sync_us is not None:
                self._sync_overlap = {
                    "overlapped_sync_us": sr.overlapped_sync_us,
                    "exposed_sync_us": sr.exposed_sync_us,
                    "buckets": sr.sync_buckets}
        elif n_dev > 1:
            from .search.machine_model import make_machine_model

            machine = make_machine_model(self.config, n_dev)
            if hasattr(machine, "tier_path"):
                from .analysis.passes import default_strategies_for
                from .search.simulator import CostModel, Simulator

                strats = self._op_strategies or default_strategies_for(
                    self.graph, self.parallel_axes, self.config.batch_size)
                self._reduction_plan = CostModel(
                    machine, self.config).reduction_plan(self.graph, strats)
                if any(e.get("bucket") is not None
                       for e in self._reduction_plan.values()):
                    sim = Simulator(machine, self.config)
                    sim.simulate(self.graph, strats)
                    st = sim.last_sync_stats or {}
                    self._sync_overlap = {
                        "overlapped_sync_us": st.get("overlapped_sync_us"),
                        "exposed_sync_us": st.get("exposed_sync_us"),
                        "buckets": len(st.get("buckets") or [])}
        if self._sync_overlap is not None:
            from .obs.registry import REGISTRY

            g = REGISTRY.gauge(
                "ff_grad_sync_overlap_us",
                "Predicted grad-sync overlap split of the compiled plan",
                labels=("kind",))
            g.set(float(self._sync_overlap["overlapped_sync_us"] or 0.0),
                  kind="overlapped")
            g.set(float(self._sync_overlap["exposed_sync_us"] or 0.0),
                  kind="exposed")

    def _plan_grad_sync(self, mesh) -> None:
        """The data axis's gradient sync under
        `config.collective_lowering` (runtime/collectives.py
        plan_grad_sync_lowering, JAX `Executor.__init__`): the lowering,
        or None for the one flat bucket; `explicit` raises
        CollectiveLoweringError naming why a plan cannot be lowered.
        Every rank of the world makes the lowering's tier groups here, in
        one order, a rank past the mesh too. With a lowering, FFTA072 and
        FFTA090 check the executed schedule against the priced plan
        (`_verify_executed_reductions`)."""
        from .runtime.collectives import (CollectiveLoweringError,
                                          plan_grad_sync_lowering)

        # a stage axis runs the pipeline region (JAX's first reason)
        staged = mesh is not None and mesh.size("stage") > 1
        self._grad_sync, reasons = plan_grad_sync_lowering(
            self.config, self.graph, mesh, self._reduction_plan,
            pipeline_plan=True if staged else None)
        if self._grad_sync is None:
            if self.config.collective_lowering == "explicit":
                raise CollectiveLoweringError(
                    "collective_lowering='explicit' cannot lower this "
                    "plan: " + "; ".join(reasons))
            return
        self._grad_sync.make_groups(mesh)
        self._grad_sync.record()
        self._verify_executed_reductions()

    def _verify_executed_reductions(self) -> None:
        """The compile-time executed-schedule gate (JAX
        `_verify_executed_reductions`): under plan_analysis="error", fail
        if the lowering dropped or renamed a tensor the priced plan names
        (FFTA072), or if the executed schedule does not discharge every
        pending gradient of the graph and strategies (FFTA090)."""
        lowering = self._grad_sync
        mode = getattr(self.config, "plan_analysis", "error")
        if lowering is None or mode == "off" or not self._reduction_plan:
            return
        from .analysis import PlanAnalysisError, record_report
        from .analysis.diagnostics import DiagnosticReport
        from .analysis.interp import semantic_reduction_diagnostics
        from .analysis.passes import (AnalysisContext,
                                      check_executed_reductions)

        ctx = AnalysisContext(
            graph=self.graph,
            strategies=getattr(self, "_op_strategies", None),
            reduction_strategies=self._reduction_plan,
            executed_reductions=lowering.executed_plan(),
            executed_buckets=lowering.executed_buckets())
        report = DiagnosticReport(passes_run=["tiers", "flow"])
        report.extend(check_executed_reductions(ctx))
        report.extend(semantic_reduction_diagnostics(ctx))
        if not report.diagnostics:
            return
        record_report(report)
        for d in report.errors():
            _log.error("plan analysis: %s", d.format())
        if mode == "error" and report.errors():
            raise PlanAnalysisError(report)

    def analyze_plan(self, passes=None):
        """The plan analysis (analysis/) over this model's graph, chosen
        strategies and machine spec: the DiagnosticReport (never raises;
        JAX `analyze_plan`). Usable mid-compile and after compile()."""
        from .analysis import analyze_plan as _analyze
        from .search.machine_model import make_machine_model

        n_dev = self.config.total_devices
        final = (self.graph.resolve_tensor(self.final_tensor)
                 if self.final_tensor is not None else None)
        final_guid = (final.owner_op.guid
                      if final is not None and final.owner_op is not None
                      and final.owner_op.guid in self.graph.ops else None)
        # an active explicit lowering: the analysis compares the EXECUTED
        # schedule against the plan (FFTA072)
        lowering = getattr(self, "_grad_sync", None)
        return _analyze(
            self.graph,
            strategies=self._op_strategies,
            machine=make_machine_model(self.config, n_dev),
            config=self.config,
            batch_size=self.config.batch_size,
            n_devices=n_dev,
            mesh_axes=getattr(self, "parallel_axes", None),
            final_guid=final_guid,
            reduction_strategies=getattr(self, "_reduction_plan", None),
            executed_reductions=(lowering.executed_plan()
                                 if lowering is not None else None),
            executed_buckets=(lowering.executed_buckets()
                              if lowering is not None else None),
            passes=passes)

    def _run_plan_analysis(self) -> None:
        """compile()'s gate (JAX `_run_plan_analysis`):
        plan_analysis="error" raises PlanAnalysisError on an error
        diagnostic, "warn" only records, "off" skips. Every diagnostic
        lands in `analysis_events` (an elastic EventLog) and the
        process-wide per-code counters (`ff_plan_diagnostics_total`)."""
        mode = getattr(self.config, "plan_analysis", "error")
        if mode == "off":
            return
        from .analysis import PlanAnalysisError, record_report
        from .elastic.events import EventLog

        with get_tracer().span("compile.analysis"):
            report = self.analyze_plan()
        self._analysis_report = report
        record_report(report)
        if not hasattr(self, "analysis_events"):
            self.analysis_events = EventLog()
        for d in report.diagnostics:
            self.analysis_events.record(
                f"analysis.{d.severity.value}", code=d.code,
                op=d.op_name, message=d.message)
        for d in report.warnings():
            _log.warning("plan analysis: %s", d.format())
        for d in report.errors():
            _log.error("plan analysis: %s", d.format())
        if report.errors() and mode == "error":
            raise PlanAnalysisError(report)

    def _export_task_graph(self, path: str) -> None:
        """Cost-annotated task-graph dot (JAX `_export_task_graph`;
        reference: --export-strategy-task-graph-file with
        --include-costs-dot-graph): each node carries its strategy and the
        cost model's forward and backward estimates."""
        from .obs.calibration import op_strategies
        from .search.machine_model import make_machine_model
        from .search.simulator import CostModel, OpStrategy

        cost = CostModel(make_machine_model(
            self.config, self.config.total_devices), self.config)
        strategies = op_strategies(self)
        costs, labels = {}, {}
        for op in self.graph.ops.values():
            s = strategies.get(op.guid, OpStrategy(dp=1, tp=1))
            try:
                f = cost.forward_time_us(op, s)
                b = cost.backward_time_us(op, s)
            except Exception:
                f = b = 0.0
            costs[op.guid] = f + b
            labels[op.guid] = (f"dp={s.dp},tp={s.tp} fwd={f:.1f}us "
                               f"bwd={b:.1f}us")
        self.graph.export_dot(path, include_costs=True, costs=costs,
                              labels=labels)

    def _make_reg_fn(self):
        """The weight regularizers' sum over the parameters (JAX
        `reg_fn`), None without any. The term of a weight sharded over an
        axis (`model`, `expert`) is the sum of its shards' terms over that
        axis's group (`reduce_sum`: all-reduce forward, identity backward,
        since the loss is the same on every rank of those axes), which is
        JAX's term on the whole weight for the element-wise sums a
        regularizer computes."""
        if not self.weight_regularizers:
            return None
        from .runtime.collectives import reduce_sum

        by_name = {op.name: op for op in self.ops}
        regs = []
        for o, w, fn in self.weight_regularizers:
            if o in by_name and by_name[o].has_weight(w):
                pt = by_name[o].shards.get(w)
                axes = sorted({pt.dims[d].axis for d in pt.sharded_dims()}
                              if pt is not None else ())
                regs.append((o, w, fn, axes))
        mesh = self.mesh

        def reg_fn(params):
            total = 0.0
            for o, w, fn, axes in regs:
                term = fn(params[o][w])
                for axis in axes:
                    term = reduce_sum(term, mesh.group(axis))
                total = total + term
            return total

        return reg_fn

    def _build_steps(self) -> None:
        """The step functions (JAX `_build_step_functions`): train (in
        training mode), eval, predict's inference walk and the manual
        loop's forward (in the compile mode) and backward; the K-step and
        accumulation steps are built at first use."""
        with get_tracer().span("compile.build_steps"):
            ex, final = self.executor, self.final_tensor
            if self.comp_mode == CompMode.COMP_MODE_TRAINING:
                self._train_step = ex.build_train_step(
                    self.optimizer, self.loss.fn, self.metrics, final,
                    self._reg_fn)
                self._grad_step = ex.build_grad_step(self.loss.fn, final)
                self._elastic_dispatch = ex.build_elastic_step(
                    self.loss.fn, self.metrics, final, self._reg_fn)
            self._eval_step = ex.build_eval_step(self.loss.fn, self.metrics,
                                                 final)
            self._forward_fn = ex.build_forward(final, self.comp_mode)
            self._infer_fn = ex.build_forward(final)
            self._multi_steps, self._accum_step = {}, None
            self._manual.pop("seq_fns", None)

    def _assign_strategy(self, order: Sequence[Op]) -> None:
        """Each op's part of the plan (JAX `_assign_strategy`,
        `model.py:1028-1125`: `op_dp = min(s.dp, dp)`, and so each axis,
        the mesh-wide degree for an op the plan does not name):

        - a TP-capable op at tp > 1 shards its weights over `model`,
          column-parallel, or row-parallel for a `tp_row` linear (its
          kernel on the in-dim); a column-parallel linear whose every
          consumer is a row-parallel linear of its degree keeps its
          output sharded on the features (the Megatron pair);
        - an EXPERTS op at ep > 1 shards its stacked weights on dim 0 over
          `expert`;
        - an op whose position dim divides over `seq`
          (search/simulator.py `sp_shardable`) and which computes each
          position alone (SEQ_LOCAL) is `seq_local`; attention too,
          unless it has dropout (JAX keeps that unsharded), and then it
          runs the sequence-parallel kernels (`sequence_parallel`, as
          JAX sets it);
        - a convolution or pool whose H rows cut evenly over `attr`
          (ops/conv.py `attr_halo`) is `attr_local`, and so is a batch
          norm or element-wise op on NCHW values whose H divides;
        - an op at dp below the mesh's data degree computes the whole
          batch (`Op.whole_batch`);
        - on a `stage` axis, the ops of the pipelined region that other
          stages run are not `held` here.

        The batch is cut over `data` in `_batch`; the executor cuts and
        gathers the `seq` and `attr` dims (runtime/executor.py)."""
        from .ops.conv import attr_halo
        from .search.simulator import _dim1_is_channel, sp_shardable

        mesh = self.mesh

        def size(axis):
            return mesh.size(axis) if mesh is not None else 1

        dp, tp, ep = size("data"), size("model"), size("expert")
        ap, sp = size("attr"), size("seq")
        coords = mesh.coords if mesh is not None else {}
        strategies = self._op_strategies or {}
        stage = (mesh.index("stage") if mesh is not None
                 and self.executor.pipeline_plan is not None else None)
        view = mesh.view if mesh is not None else MachineView()
        for op in order:
            s = strategies.get(op.guid)
            op.machine_view = view

            def deg(field, axis_size):
                return min(getattr(s, field), axis_size) if s else axis_size

            op_tp, op_ep = deg("tp", tp), deg("ep", ep)
            op_ap, op_sp = deg("ap", ap), deg("sp", sp)
            shards, row = {}, False
            if op.op_type == OpType.EXPERTS and op_ep > 1:
                shards = self._assign_shards(op, op_ep, "expert",
                                             {ws.name: 0 for ws in op.specs})
            elif op_tp > 1 and op.op_type in TP_CAPABLE:
                row = bool(s and s.tp_row and op.op_type == OpType.LINEAR)
                shards = self._assign_tp_weights(op, op_tp, row=row)
            op.set_sharding(shards, coords)
            op.row_parallel = row and "kernel" in shards
            op.gather_out = True
            op.whole_batch = deg("dp", dp) < dp
            op.seq_local = (op_sp > 1 and sp_shardable(op, op_sp)
                            and _seq_local_type(op))
            if op.seq_local and op.op_type == OpType.MULTIHEAD_ATTENTION:
                op.params["sequence_parallel"] = True
            op.attr_local = op_ap > 1 and (
                attr_halo(op, op_ap) is not None
                if op.op_type in AP_CAPABLE else
                op.op_type in ATTR_LOCAL and len(op.outputs[0].dims) == 4
                and op.outputs[0].dims[2] % op_ap == 0
                and _dim1_is_channel(op))
            op.held = stage is None or self.executor.stage_of(op) in (
                None, stage)
            if op.op_type in _parallel_ops.PARALLEL_OP_TYPES:
                self._apply_parallel_shape(op, dict(mesh.shape)
                                           if mesh is not None else {})
        self._pair_megatron(order)

    @staticmethod
    def _apply_parallel_shape(op: Op, axes: Dict[str, int]) -> None:
        """An explicit parallel op's output parallel shape (JAX
        `_assign_strategy`, `model.py:1134-1148`); a repartition's axis
        resolved over the mesh's axes."""
        if op.op_type == OpType.REPARTITION:
            axis = _parallel_ops.resolve_partition_axis(
                op.name, op.params["dim"], op.params["degree"], axes,
                axis=op.params.get("axis"))
            if axis is not None:
                op.apply_parallel_shape(axis)
        elif op.op_type in (OpType.COMBINE, OpType.REPLICATE):
            op.apply_parallel_shape()
        elif op.op_type == OpType.FUSED_PARALLEL:
            op.apply_parallel_shape(axes)

    def _pair_megatron(self, order: Sequence[Op]) -> None:
        """Keep a column-parallel linear's output sharded where every
        consumer is a row-parallel linear of its degree (JAX `model.py:
        1116-1127`: the producer's output then never gathers)."""
        consumers: Dict[int, List[Op]] = {}
        for op in order:
            for t in op.inputs:
                consumers.setdefault(t.guid, []).append(op)
        for op in order:
            if (op.op_type != OpType.LINEAR or op.row_parallel
                    or op.tp_degree == 1 or "kernel" not in op.shards
                    or op.outputs[0] is self.final_tensor):
                continue
            users = consumers.get(op.outputs[0].guid, [])
            if users and all(u.op_type == OpType.LINEAR and u.row_parallel
                             and u.tp_degree == op.tp_degree
                             for u in users):
                op.gather_out = False

    @staticmethod
    def _assign_shards(op: Op, degree: int, axis: str,
                       shard_dim: Dict[str, int]
                       ) -> Dict[str, ParallelTensorShape]:
        """The parallel shape of each of `op`'s weights that `shard_dim`
        names, sharded on that dim over `axis` where `degree` divides
        it."""
        out = {}
        for ws in op.specs:
            if ws.name not in shard_dim:
                continue
            d = shard_dim[ws.name] % len(ws.dims)
            if ws.dims[d] % degree:
                continue
            dims = [ParallelDim(s) for s in ws.dims]
            dims[d] = ParallelDim(ws.dims[d], degree, axis)
            out[ws.name] = ParallelTensorShape(dims, ws.dtype)
        return out

    @classmethod
    def _assign_tp_weights(cls, op: Op, tp: int, row: bool = False
                           ) -> Dict[str, ParallelTensorShape]:
        """The parallel shape of each of `op`'s weights that shards over
        `model` (JAX `_assign_tp_weights`): the dim TP_WEIGHT_SHARD_DIMS
        names (column-parallel), or the kernel's in-dim with the bias
        whole for a row-parallel linear, where tp divides it."""
        return cls._assign_shards(
            op, tp, "model", {"kernel": 0} if row
            else TP_WEIGHT_SHARD_DIMS.get(op.op_type, {}))

    # -- training -----------------------------------------------------------
    def _label_dtype(self) -> DataType:
        """int class ids for the sparse-categorical loss, float targets
        for every other (JAX `_label_dtype`)."""
        return (DataType.DT_INT32 if self.loss.loss_type ==
                LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY
                else DataType.DT_FLOAT)

    def _host_batch(self, x: Sequence[np.ndarray], y: np.ndarray, lo: int,
                    hi: int) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        """Host (inputs, label) of samples [lo, hi), each input in its
        staging dtype (`DataType.host_np_dtype`), the label in the loss's;
        on a mesh with a `data` axis, this rank's equal slice of them (the
        whole batch, replicated, when it does not divide, as JAX's
        shard_batch replicates)."""
        lo, hi = self._data_slice(lo, hi)
        inputs = {op.name: np.ascontiguousarray(arr[lo:hi]).astype(
            op.outputs[0].dtype.host_np_dtype)
            for op, arr in zip(self.input_ops, x)}
        label = np.ascontiguousarray(y[lo:hi]).astype(
            self._label_dtype().np_dtype)
        return inputs, label

    def _data_slice(self, lo: int, hi: int) -> Tuple[int, int]:
        """This rank's equal part of samples [lo, hi) on a `data` axis that
        divides them; all of them otherwise. The executor's next walks
        take the decision with it (`Executor.batch_cut`): an op that
        computes the whole batch gathers only inputs that were cut."""
        dp = self.mesh.size("data") if self.mesh is not None else 1
        cut = dp > 1 and (hi - lo) % dp == 0
        if self.executor is not None:
            self.executor.batch_cut = cut
        if cut:
            n = (hi - lo) // dp
            lo += self.mesh.index("data") * n
            hi = lo + n
        return lo, hi

    def _batch(self, x: Sequence[np.ndarray], y, lo: int, hi: int):
        """(inputs, label) of samples [lo, hi) on this rank's device
        (`_host_batch`'s arrays, each input cast to its dtype)."""
        return self.executor.device_batch(*self._host_batch(x, y, lo, hi))

    # -- the elastic coordinator's step (elastic/coordinator.py) -----------
    def _prep_step_batch(self, x: Sequence[np.ndarray], y: np.ndarray,
                         lo: int, hi: int):
        """Device (inputs, label) of samples [lo, hi) for one step, this
        rank's slice on a `data` axis (JAX `_prep_step_batch`: the batch
        rule fit and the coordinator's loop share)."""
        return self._batch(x, y, lo, hi)

    def _next_rng(self, advance: int = 1) -> torch.Generator:
        """Advance the optimizer step count by `advance` and return the
        training walk's random stream (JAX `_next_rng`, whose dropout key
        the count derives; here the executor's generator, which every
        training walk draws its masks from)."""
        self._step_count += advance
        return self.executor.generator

    def _elastic_step(self, inputs, label):
        """One step into temporaries (JAX's coordinator step): (the
        gradients, the metric values) of (inputs, label), dispatched under
        `config.elastic_step_wrapper` (runtime/executor.py
        build_elastic_step); nothing is applied. `_commit_step` applies
        it; dropping it leaves the weights, the optimizer state and the
        step count as they were (a walk's writes of op state, batch norm's
        statistics, are the caller's to take back)."""
        self._require_training("the elastic step")
        return self._elastic_dispatch(inputs, label)

    def _commit_step(self, grads) -> None:
        """Apply an `_elastic_step`'s gradients: the optimizer's update of
        the weights and of `opt_state`, in place, and one optimizer step
        on the count (`_next_rng`)."""
        self.optimizer.update(self.executor.parameters(), grads,
                              self.opt_state, self.config)
        self._next_rng()

    def _require_position(self, what: str) -> None:
        """A rank past the plan's mesh runs nothing (compile's
        `outside_mesh`): it would train a copy alone."""
        if self.outside_mesh:
            raise RuntimeError(f"{what}: {self.outside_mesh}")

    def _require_training(self, what: str) -> None:
        self._require_position(what)
        if self.comp_mode != CompMode.COMP_MODE_TRAINING:
            raise RuntimeError(f"{what} needs compile() in training mode")

    def _assert_trainable(self) -> None:
        """JAX `_assert_trainable`: a model rewritten for inference
        (serving/optimize.py `fold_batchnorm`) refuses to train."""
        if self._inference_only:
            raise RuntimeError(
                f"model was optimized for inference "
                f"({self._inference_only}); training is no longer valid — "
                "rebuild and compile a fresh model to train")

    def _require_compiled(self, what: str) -> None:
        self._require_position(what)
        if self.executor is None:
            raise RuntimeError(f"{what} needs compile()")

    def _attach_dataloader(self, dl) -> None:
        self._dataloaders.append(dl)

    def _dataloader_handles(self):
        """fit() without x and y: the attached SingleDataLoaders ordered by
        input op, and the label's loader (None if none is attached)."""
        if not self._dataloaders:
            raise RuntimeError("fit() without x/y requires attached "
                               "dataloaders")
        by_tensor = {dl.input_tensor.guid: dl for dl in self._dataloaders}
        xs = []
        for op in self.input_ops:
            dl = by_tensor.get(op.outputs[0].guid)
            if dl is None:
                raise RuntimeError(
                    f"no dataloader attached for input {op.name!r}")
            xs.append(dl)
        y_dl = None
        if self.label_tensor is not None:
            y_dl = by_tensor.get(self.label_tensor.guid)
        return xs, y_dl

    def fit(self, x: Union[np.ndarray, Sequence[np.ndarray], None] = None,
            y: Optional[np.ndarray] = None, batch_size: Optional[int] = None,
            epochs: Optional[int] = None, accum_steps: int = 1,
            steps_per_execution: int = 1,
            verbose: bool = False, watchdog=None,
            drift_detector=None) -> List[Dict[str, float]]:
        """Train on (x, y) for `epochs` passes of n // batch_size steps; with
        no x and y, on batches pulled from the attached dataloaders
        (runtime/dataloader.py), whose num_samples is n.

        Returns the JAX package's history: one `PerfMetrics.summary()` per
        epoch (samples, accuracy, loss, cce, sparse_cce, mse, rmse, mae)
        with its `epoch` and `throughput` (samples per second over the
        epoch's wall). The call's per-step records are `step_stats`'
        (below).

        accum_steps > 1: each optimizer update averages the gradients of
        `accum_steps` consecutive microbatches of `batch_size`; its record
        holds the microbatches' mean metrics. steps_per_execution = K > 1:
        n // (batch_size * K) dispatches of K steps each (one CUDA graph
        on the card, runtime/executor.py MultiStep), the trailing n mod
        (batch_size * K) samples through the single step, so an epoch
        takes the n // batch_size updates of plain fit; a dispatch's
        metrics are read after the next one is queued. The two are
        mutually exclusive, as in the JAX package. `perf_metrics` holds
        the current epoch's running metrics; `verbose` prints JAX's line
        an epoch.

        watchdog: an elastic.TrainingWatchdog (JAX `fit(watchdog=)`). Every
        committed loss is health-checked (NaN/Inf, EMA spike) where fit
        reads it anyway: each step's, each accumulated update's, and each
        K-step dispatch's mean loss, read after the next dispatch is
        queued; so the guard adds no device sync. Bad steps are flagged
        in the watchdog's event log, and after max_consecutive_bad of
        them in a row fit raises the typed NumericBlowup (this loop
        cannot undo an update).

        `step_stats` (obs/stepstats.py StepStats, JAX's, made anew by every
        call) takes a record per committed step, accumulated update or
        K-step dispatch: its loss (a dispatch's the mean over its K
        steps, as JAX's), samples, steps, wall (a dispatch's read where
        its metrics are, so no device sync is added), samples/s, TFLOP/s
        and MFU against the machine spec's peak (the H100's on the
        card).
        With `config.profiling` it prints a samples/s line every
        `print_freq` steps and its summary at the end.

        drift_detector: an obs.DriftDetector. Each record's per-step wall
        feeds its measured-vs-predicted EMA (`ff_calibration_drift`,
        `ff_drift_breaches_total`); a breach marks an `obs.drift` trace
        instant: this loop cannot re-plan (JAX's contract)."""
        self._require_training("fit()")
        self._assert_trainable()
        if steps_per_execution > 1 and accum_steps > 1:
            raise ValueError(
                "steps_per_execution and accum_steps are mutually exclusive "
                "(one batches optimizer steps per dispatch, the other "
                "microbatches per optimizer step)")
        bs = batch_size or self.config.batch_size
        epochs = epochs or self.config.epochs
        dls = y_dl = None
        if x is None:
            dls, y_dl = self._dataloader_handles()
            if y_dl is None:
                raise RuntimeError(
                    "fit() without x/y requires a dataloader attached to the "
                    "label tensor")
            if bs != dls[0].batch_size:
                raise ValueError(
                    f"fit(batch_size={bs}) differs from the attached "
                    f"dataloaders' batch size {dls[0].batch_size}")
            sizes = {dl.num_samples for dl in dls + [y_dl]}
            if len(sizes) > 1:
                raise ValueError(
                    f"attached dataloaders disagree on num_samples: {sizes}")
            n = sizes.pop()
        else:
            if isinstance(x, np.ndarray):
                x = [x]
            n = x[0].shape[0]
        if n < bs * accum_steps:
            raise ValueError(
                f"dataset has {n} samples but batch_size*accum_steps is "
                f"{bs * accum_steps}; fit needs at least one full update")
        if n < bs * steps_per_execution:
            raise ValueError(
                f"dataset has {n} samples but batch_size*steps_per_execution "
                f"is {bs * steps_per_execution}; fit needs at least one full "
                "dispatch")

        def load_host(it: int):
            """Step `it`'s host batch: sequential pulls on the dataloader
            branch, once per batch index in order."""
            if dls is not None:
                return self._host_batch([dl.next_batch() for dl in dls],
                                        y_dl.next_batch(), 0, bs)
            return self._host_batch(x, y, it * bs, (it + 1) * bs)

        from .obs.stepstats import (StepStats, model_peak_tflops,
                                    model_train_flops_per_step)

        stats = StepStats(
            flops_per_step=model_train_flops_per_step(self),
            peak_tflops=model_peak_tflops(self),
            print_freq=(max(1, self.config.print_freq)
                        if self.config.profiling else 0))
        self.step_stats = stats

        def guard(rec: Dict[str, float]) -> None:
            # the record just committed: StepStats, the drift detector on
            # its per-step wall (JAX `_drift_guard`), then the watchdog
            # (JAX `_wd_guard`)
            srec = stats.record_step(rec["samples"], loss=rec["loss"],
                                     steps=rec["steps"], wall_s=rec["wall_s"])
            if drift_detector is not None and srec["step_ms"] > 0 \
                    and drift_detector.observe(srec["step_ms"] * 1e3):
                get_tracer().instant("obs.drift", step=self._step_count,
                                     drift=drift_detector.drift)
            if watchdog is not None:
                watchdog.guard(self._step_count, rec["loss"])

        k = steps_per_execution
        history: List[Dict[str, float]] = []
        for epoch in range(epochs):
            self.reset_metrics()
            perf = self.perf_metrics
            t_epoch = time.time()
            if k > 1:
                chunks = n // (bs * k)
                pending, t_last = None, time.perf_counter()
                for chunk in range(chunks):
                    self._before_step(k)
                    # re-resolved every dispatch: a recompile trigger's
                    # alter drops the captured steps mid-epoch
                    queued = self._multi_step(k)(
                        [load_host(chunk * k + j) for j in range(k)],
                        self.opt_state)
                    # one-deep pipeline: the previous dispatch's metrics
                    # are read after this one is queued
                    if pending is not None:
                        t_last, rec = self._absorb(perf, pending, bs, k,
                                                   t_last)
                        guard(rec)
                    pending = queued
                if pending is not None:
                    guard(self._absorb(perf, pending, bs, k, t_last)[1])
                first_single, updates, micro = chunks * k, n // bs, 1
            else:
                first_single, updates = 0, n // (bs * accum_steps)
                micro = accum_steps
            for step_i in range(first_single, updates):
                # a K-step fit's trailing steps skip the hook, as JAX's do
                self._before_step(1, hook=k == 1)
                t0 = time.perf_counter()
                if micro > 1:
                    msum, _ = self._get_accum_step()(
                        (self.executor.device_batch(
                            *load_host(step_i * micro + j))
                         for j in range(micro)), self.opt_state)
                    rec = {key: float(v) / micro for key, v in msum.items()}
                else:
                    mvals = self._train_step(
                        *self.executor.device_batch(*load_host(step_i)),
                        self.opt_state)
                    rec = {key: float(v) for key, v in mvals.items()}
                guard(self._record(perf, rec, bs * micro, 1,
                                   time.perf_counter() - t0))
            summ = perf.summary()
            summ["epoch"] = epoch
            summ["throughput"] = updates * bs * micro / (time.time() - t_epoch)
            history.append(summ)
            self._publish_moe_metrics()
            if verbose:
                loss = stats.last()["loss"] if len(stats) else 0
                print(f"epoch {epoch}: loss={loss:.4f} "
                      f"acc={summ['accuracy']:.4f} "
                      f"{summ['throughput']:.1f} samples/s")
        # the fit-end step summary, off the history records (JAX's)
        if len(stats) and self.config.profiling:
            print(stats.format_summary())
        return history

    def _before_step(self, steps: int, hook: bool = True) -> None:
        """Before each optimizer step (or dispatch of `steps`): the
        recompile hook, then the step count (JAX `_next_rng` advances it
        after the hook)."""
        if hook and self._recompile_state is not None:
            self._recompile_state.step(self)
        self._step_count += steps

    def _publish_moe_metrics(self) -> None:
        """Once an epoch: every EXPERTS op's router state into the ff_moe_*
        families (obs/moe.py); nothing for a graph without one."""
        if any(op.op_type == OpType.EXPERTS for op in self.ops):
            from .obs.moe import publish_moe_metrics

            publish_moe_metrics(self)

    # -- recompile hook (JAX `recompile_on_condition`) ---------------------
    def recompile_on_condition(self, recompile_state) -> None:
        """Install a trigger / alter hook that fit checks before every
        optimizer step (runtime/recompile.py RecompileState)."""
        self._recompile_state = recompile_state

    def get_cache_score(self, cache_tensor: Tensor) -> float:
        return float(self.state[cache_tensor.owner_op.name]["score"])

    def invalidate_compiled_steps(self) -> None:
        """Rebuild the step functions after an op-param or graph change
        (the recompile alter): the eager steps read the ops' params at
        every walk, and the captured K-step graphs and the accumulation
        step are dropped, so the next dispatch captures the new dataflow.
        Weights and optimizer state carry over."""
        if self.executor is None:
            return
        self._build_steps()

    @staticmethod
    def _record(perf: PerfMetrics, rec: Dict[str, float], samples: int,
                steps: int, dt: float) -> Dict[str, float]:
        """Fold one committed record's metrics into the epoch's; returns
        what StepStats takes of it."""
        perf.update(samples, rec)
        return {"loss": rec["loss"], "samples": samples, "steps": steps,
                "wall_s": dt}

    def _absorb(self, perf: PerfMetrics, queued: torch.Tensor, bs: int,
                k: int, t_last: float):
        """Record a dispatch's (keys, K) metrics: each key's mean over its K
        steps, weighted by the K * bs samples; returns the time it was
        read, which ends its interval, and `_record`'s record."""
        vals = queued.cpu().numpy()
        t = time.perf_counter()
        keys = self._multi_step(k).keys
        rec = {key: float(vals[i].mean()) for i, key in enumerate(keys)}
        return t, self._record(perf, rec, k * bs, k, t - t_last)

    def _multi_step(self, k: int) -> MultiStep:
        if k not in self._multi_steps:
            self._multi_steps[k] = self.executor.build_multi_step(
                self.optimizer, self.loss.fn, self.metrics,
                self.final_tensor, k, self._reg_fn)
        return self._multi_steps[k]

    def _get_accum_step(self):
        if self._accum_step is None:
            self._accum_step = self.executor.build_accum_step(
                self.optimizer, self.loss.fn, self.metrics,
                self.final_tensor, self._reg_fn)
        return self._accum_step

    def eval(self, x, y, batch_size: Optional[int] = None
             ) -> Dict[str, float]:
        """The JAX package's `eval`: `PerfMetrics.summary()` over (x, y),
        the tail batch included (samples, accuracy as round(accuracy x
        batch) correct samples a batch, loss, cce, sparse_cce, mse, rmse,
        mae); batch i's metrics are read after batch i + 1 is queued.
        Either compile mode."""
        self._require_compiled("eval()")
        if isinstance(x, np.ndarray):
            x = [x]
        bs = batch_size or self.config.batch_size
        n = x[0].shape[0]
        pm = PerfMetrics()
        pending = None
        for lo in range(0, n, bs):
            hi = min(lo + bs, n)
            mvals, _ = self._eval_step(*self._batch(x, y, lo, hi))
            if pending is not None:
                pm.update(pending[0], {k: float(v)
                                       for k, v in pending[1].items()})
            pending = (hi - lo, mvals)
        if pending is not None:
            pm.update(pending[0], {k: float(v) for k, v in pending[1].items()})
        return pm.summary()

    # -- manual loop (JAX `set_iteration_batch` ... `update`) ---------------
    def set_iteration_batch(self, inputs: Sequence[np.ndarray],
                            label: np.ndarray) -> None:
        """The batch the manual loop's forward and backward run on (this
        rank's part of it on a `data` axis)."""
        inputs = list(inputs)
        n = inputs[0].shape[0]
        self._manual["inputs"], self._manual["label"] = \
            self._batch(inputs, np.asarray(label), 0, n)

    def _seq_fn(self, kind: str, seq_length: Optional[int]):
        """The forward ("fwd") or backward ("grad") step at an iteration
        seq_length (JAX `_seq_fn`): the compiled ones for None, else one
        built a length and kept until the steps are rebuilt."""
        if seq_length is None:
            return self._forward_fn if kind == "fwd" else self._grad_step
        cache = self._manual.setdefault("seq_fns", {})
        key = (kind, int(seq_length))
        if key not in cache:
            if kind == "fwd":
                cache[key] = self.executor.build_forward(
                    self.final_tensor, self.comp_mode, seq_length=key[1])
            else:
                cache[key] = self.executor.build_grad_step(
                    self.loss.fn, self.final_tensor, seq_length=key[1])
        return cache[key]

    def forward(self, seq_length: Optional[int] = None) -> torch.Tensor:
        """One walk of the iteration batch in the compile mode (JAX
        `forward`); returns the final tensor's value, detached. In a
        training compile it is a training walk (dropout, batch
        statistics) that updates the ops' state, as JAX's keeps its new
        state, and it saves the dropout generator's state, which
        `backward` replays, so the backward's walk draws this forward's
        masks. Autograd records nothing here: the backward walks again,
        as JAX's grad step does, so no graph is held between the two.
        Advances the step count, as JAX's `_next_rng` does."""
        self._require_compiled("forward()")
        self._step_count += 1
        training = self.comp_mode == CompMode.COMP_MODE_TRAINING
        gen = self.executor.generator if training else None
        if gen is not None:
            self._manual["rng"] = gen.get_state()
        pred = self._seq_fn("fwd", seq_length)(self._manual["inputs"])
        self._manual["pred"] = pred
        return pred

    def zero_gradients(self) -> None:
        self._manual.pop("grads", None)

    def backward(self, seq_length: Optional[int] = None) -> None:
        """The gradients of the loss (with the auxiliary losses, without
        the regularizers, as JAX's grad step) at the iteration batch:
        a training walk from the generator state the last `forward` saved
        (the same dropout masks), which writes no op state; the generator
        is then put back where the forward left it. Without a forward
        before it, the walk draws new masks."""
        self._require_training("backward()")
        self._assert_trainable()
        gen = self.executor.generator
        saved = self._manual.pop("rng", None)
        after = gen.get_state()
        if saved is not None:
            gen.set_state(saved)
        try:
            self._manual["grads"] = self._seq_fn("grad", seq_length)(
                self._manual["inputs"], self._manual["label"])
        finally:
            if saved is not None:
                gen.set_state(after)

    def update(self) -> None:
        """One optimizer update from `backward`'s gradients: one call of
        the fused update, as a `fit` step makes."""
        self._require_training("update()")
        self._assert_trainable()
        grads = self._manual.get("grads")
        if grads is None:
            raise RuntimeError("update() needs backward() first")
        self.optimizer.update(self.executor.parameters(), grads,
                              self.opt_state, self.config)

    # -- batched inference --------------------------------------------------
    def predict(self, x, batch_size: Optional[int] = None) -> np.ndarray:
        """The final tensor's values over x, f32 numpy (a bf16 output
        widened, as JAX's `fetch`), batch by batch with the tail batch:
        an inference walk a batch that reads the ops' state and writes
        none (batch norm uses its running statistics); batch i's output is
        read after batch i + 1 is queued. Either compile mode. On a mesh
        each rank walks its part of a batch that the `data` axis divides
        (all of it otherwise) and every rank returns the whole output."""
        self._require_compiled("predict()")
        if isinstance(x, np.ndarray):
            x = [x]
        bs = batch_size or self.config.batch_size
        n = x[0].shape[0]
        outs: List[np.ndarray] = []
        pending = None
        for lo in range(0, n, bs):
            hi = min(lo + bs, n)
            a, b = self._data_slice(lo, hi)
            inputs = {op.name: torch.from_numpy(np.ascontiguousarray(
                arr[a:b]).astype(op.outputs[0].dtype.host_np_dtype)).to(
                    self.device) for op, arr in zip(self.input_ops, x)}
            pred = self._infer_fn(self.executor.cast_inputs(inputs))
            if b - a < hi - lo:
                pred = gather_shards(pred, 0, self.mesh.group("data"),
                                     self.mesh.size("data"))
            if pending is not None:
                outs.append(pending.float().cpu().numpy())
            pending = pred
        if pending is not None:
            outs.append(pending.float().cpu().numpy())
        return np.concatenate(outs, axis=0)

    def reset_metrics(self) -> None:
        self.perf_metrics = PerfMetrics()

    def get_perf_metrics(self) -> PerfMetrics:
        return self.perf_metrics

    def set_learning_rate(self, lr: float) -> None:
        """Change the learning rate in place (`opt_state["lr"]`): the next
        step, eager or a replay of a captured dispatch, uses it."""
        self._require_training("set_learning_rate()")
        self.optimizer.set_lr(self.opt_state, lr)

    def load_opt_state(self, state: Mapping[str, object]) -> None:
        """Load an optimizer state — {"step", "lr", and the optimizer's
        moment trees ("v" for momentum SGD, "m" and "v" for Adam) of op
        name -> weight name -> array} — into this model's, checking every
        name and shape; values keep this state's dtypes and device, step
        and lr written into its device scalars. The moments are given
        whole; on a mesh each rank keeps its shards."""
        self._require_training("load_opt_state()")
        mine = self.opt_state
        by_name = {op.name: op for op in self.ops}
        if set(state) != set(mine):
            raise KeyError(f"optimizer state keys {sorted(state)}, expected "
                           f"{sorted(mine)}")
        staged = []
        for key, tree in mine.items():
            if not isinstance(tree, dict):
                continue
            given = state[key]
            if {op: set(ws) for op, ws in given.items()} != \
                    {op: set(ws) for op, ws in tree.items()}:
                raise KeyError(f"optimizer state {key!r}: names differ from "
                               "the model's weights")
            for op, ws in tree.items():
                for w, t in ws.items():
                    val = given[op][w]
                    if not torch.is_tensor(val):
                        val = torch.from_numpy(np.array(val, np.float32))
                    full = next(ws.dims for ws in by_name[op].specs
                                if ws.name == w)
                    if tuple(val.shape) != tuple(full):
                        raise ValueError(
                            f"optimizer state {key!r} {op}/{w}: shape "
                            f"{tuple(val.shape)}, expected {tuple(full)}")
                    staged.append((t, by_name[op].local_value(w, val)))
        with torch.no_grad():
            for t, val in staged:
                t.copy_(val)
            mine["step"].fill_(int(np.asarray(state["step"])))
            mine["lr"].fill_(float(np.asarray(state["lr"])))

    # -- tensor values and layer queries (JAX `model.py:1676-1850`) --------
    def _whole_weight(self, op: Op, name: str) -> np.ndarray:
        """Weight `name` of `op` whole, as f32 numpy (gathered over its
        shards' axes on a mesh, and from its stage's ranks on a `stage`
        axis: every rank of the mesh calls it)."""
        t = op.w(name).detach() if op.held else None
        return self._whole(op, name, t).float().cpu().numpy()

    def _whole(self, op: Op, name: str, t: Optional[torch.Tensor]
               ) -> torch.Tensor:
        """The whole of this rank's piece `t` of `op`'s weight `name` (or
        of a tree shaped like the weights): gathered over each axis its
        shards are cut over, and broadcast from the stage that holds it on
        a `stage` axis (`t` None where this rank holds no piece). Every
        rank of the mesh calls it."""
        if self.mesh is None:
            return t
        from .runtime.collectives import broadcast_from

        ex = self.executor
        owner = ex.stage_of(op) if ex is not None else None
        pt = op.shards.get(name)
        if t is not None and pt is not None:
            for d in pt.sharded_dims():
                axis = pt.dims[d].axis
                t = gather_shards(t, d, self.mesh.group(axis),
                                  self.mesh.size(axis))
        if owner is not None:
            ws = next(w for w in op.specs if w.name == name)
            t = (torch.empty(ws.dims, dtype=ws.dtype.torch_dtype,
                             device=self.device) if t is None
                 else t.to(ws.dtype.torch_dtype))
            with torch.no_grad():
                t = broadcast_from(t, self.mesh, "stage", owner)
        return t

    def _weight_of(self, tensor: Tensor):
        """(op, weight name) of a weight handle with compiled weights;
        None for any other tensor or before compile; a handle whose op is
        not in this model raises (stale after a graph change)."""
        ws = getattr(tensor, "_weight_spec", None)
        op = tensor.owner_op
        if ws is None or op is None:
            return None
        if not any(o is op for o in self.ops):
            raise KeyError(f"no compiled parameters for op {op.name!r} "
                           "(stale tensor handle after a graph rewrite?)")
        return (op, ws.name) if op.has_weight(ws.name) else None

    def _get_tensor_value(self, tensor: Tensor) -> Optional[np.ndarray]:
        loc = self._weight_of(tensor)
        return None if loc is None else self._whole_weight(*loc)

    def _set_tensor_value(self, tensor: Tensor, value: np.ndarray) -> None:
        loc = self._weight_of(tensor)
        if loc is not None:
            loc[0].set_weight(loc[1], torch.from_numpy(np.asarray(value)))

    def get_parameter_by_id(self, op_name: str,
                            weight_name: str) -> np.ndarray:
        """A weight's whole value by op and weight name, f32 numpy (a bf16
        weight widened)."""
        for op in self.ops:
            if op.name == op_name and op.has_weight(weight_name):
                return self._whole_weight(op, weight_name)
        raise KeyError(f"no parameters for op {op_name!r}")

    def summary(self, print_fn=print) -> str:
        """Keras-style model summary, character for character the JAX
        package's: one row per op with its output shape and parameter
        count."""
        rows = [("Op (type)", "Output shape", "Params")]
        total = 0
        for op in self.ops:
            if op.op_type == OpType.INPUT:
                shape = str(tuple(op.outputs[0].dims))
                rows.append((f"{op.name} (input)", shape, "0"))
                continue
            n = sum(w.num_elements() for w in op.weights)
            total += n
            shape = str(tuple(op.outputs[0].dims)) if op.outputs else "-"
            rows.append((f"{op.name} ({op.op_type.value})", shape, f"{n:,}"))
        w0 = max(len(r[0]) for r in rows) + 2
        w1 = max(len(r[1]) for r in rows) + 2
        lines = [f"{r[0]:<{w0}}{r[1]:<{w1}}{r[2]:>10}" for r in rows]
        sep = "=" * (w0 + w1 + 10)
        out = "\n".join(
            [sep, lines[0], sep] + lines[1:]
            + [sep, f"Total params: {total:,}", sep])
        if print_fn is not None:
            print_fn(out)
        return out

    def get_layers(self) -> List[Op]:
        return list(self.ops)

    def get_layer_by_id(self, layer_id: int) -> Op:
        return self.ops[layer_id]

    def get_layer_by_name(self, name: str) -> Op:
        for op in self.ops:
            if op.name == name:
                return op
        raise KeyError(f"no layer named {name!r}")

    def print_layers(self, id: int = -1) -> None:
        for op in self.ops:
            print(op)

    # -- weights ----------------------------------------------------------
    @property
    def params(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """op name -> weight name -> tensor, the JAX `model.params` tree;
        each tensor shares the master's storage, outside autograd. On a
        mesh: this rank's shards (`gather_params` gives the whole)."""
        return {op.name: {ws.name: op.w(ws.name).detach() for ws in op.specs}
                for op in self.ops if op.specs and op.held}

    def gather_params(self, tree: Optional[Mapping] = None
                      ) -> Dict[str, Dict[str, torch.Tensor]]:
        """The whole of `tree` (default: the weights; or any tree shaped
        like them, such as gradients or moments) on every rank, gathered
        from the shards over their axes and, on a `stage` axis, from the
        stage that holds each op. Every rank of the mesh calls it. On one
        device it is the tree itself."""
        tree = self.params if tree is None else tree
        if self.mesh is None:
            return {op: dict(ws) for op, ws in tree.items()}
        ex = self.executor
        out = {}
        for op in self.ops:
            staged = ex is not None and ex.stage_of(op) is not None
            if op.name not in tree and not (staged and op.specs):
                continue
            mine = tree.get(op.name, {})
            names = [ws.name for ws in op.specs] if staged else list(mine)
            out[op.name] = {w: self._whole(op, w, mine.get(w))
                            for w in names}
        return out

    @property
    def state(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """op name -> state variable -> tensor, the JAX `model.state` tree
        (batch norm's running statistics, the MoE router's and the cache's
        state): the ops' buffers themselves, which a training step updates
        in place."""
        return {op.name: {sv.name: op._buffers[sv.name]
                          for sv in op.state_vars}
                for op in self.ops if op.state_vars}

    def load_state(self, state: Mapping[str, Mapping[str, object]]) -> None:
        """Load every state variable by op name and variable name, as
        `load_params` loads weights: exactly this model's names and
        shapes, each value (a tensor, or an array such as the JAX
        package's `model.state` holds) converted to the variable's dtype
        and device."""
        mine = self.state
        if {op: set(vs) for op, vs in state.items()} != \
                {op: set(vs) for op, vs in mine.items()}:
            raise KeyError(f"state tree does not match the model: expected "
                           f"{ {op: sorted(vs) for op, vs in mine.items()} }")
        staged = []
        for op, vs in mine.items():
            for name, t in vs.items():
                val = state[op][name]
                if not torch.is_tensor(val):
                    val = torch.from_numpy(np.array(val, dtype=np.float32))
                if tuple(val.shape) != tuple(t.shape):
                    raise ValueError(f"op {op!r} state {name!r}: shape "
                                     f"{tuple(val.shape)}, expected "
                                     f"{tuple(t.shape)}")
                staged.append((t, val))
        with torch.no_grad():
            for t, val in staged:
                t.copy_(val)

    def adopt_params_from(self, other: "FFModel") -> None:
        """Copy a sequentially-compiled model's weights into this one, by
        op and weight name (JAX `adopt_params_from`, `model.py:1735`):
        on a mesh each rank keeps its pieces, on a `stage` axis each stage
        its ops'. `other` must not be pipeline-parallel. The optimizer
        state is initialized anew for the adopted weights."""
        if getattr(other.executor, "pipeline_plan", None) is not None:
            raise ValueError("adopt_params_from needs a sequential source "
                             "model (the stacked stage tree is not "
                             "unstacked in this direction)")
        src = other.gather_params()
        for op in self.ops:
            if op.specs and op.name not in src:
                raise KeyError(
                    f"adopt_params_from: op {op.name!r} has no counterpart "
                    "in the source model (same-graph models only)")
        self.load_params({op.name: src[op.name] for op in self.ops
                          if op.specs})
        if self.comp_mode == CompMode.COMP_MODE_TRAINING:
            self.opt_state = self.optimizer.init_state(
                self.executor.parameters())

    def load_params(self, params: Mapping[str, Mapping[str, object]]) -> None:
        """Load every weight by op name and weight name. The tree must name
        exactly this model's weights with their (whole) shapes; each value
        (numpy array or tensor) is converted to the weight's dtype and
        device, and on a mesh each rank keeps its shards."""
        self._require_position("load_params()")
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
    name -> array, whole or sharded: numpy gathers them) into the port's
    `model`, checking every name and shape; on a mesh each rank keeps its
    shards. The layouts are the same in both packages, so nothing is
    transposed. A pipeline-parallel JAX model's stacked `__pipeline__`
    tree (JAX `executor.py _init_pipeline_params`: key seg{j}_op{r}_{name}
    of the stage-0 template op, leading dim the stage) is unstacked into
    the ops of every stage."""
    tree = {op: {w: np.asarray(v) for w, v in ws.items()}
            for op, ws in params.items() if op != "__pipeline__"}
    stacked = params.get("__pipeline__") or {}
    if stacked:
        from .parallel.pipeline_plan import find_pipeline_plan

        plan = getattr(model.executor, "pipeline_plan", None)
        if plan is None:
            leaf = next(iter(next(iter(stacked.values())).values()))
            plan = find_pipeline_plan(model.graph, np.asarray(leaf).shape[0])
        k = plan.segs_per_stage
        for j in range(k):
            for r, template in enumerate(plan.segments[j]):
                entry = stacked.get(f"seg{j}_op{r}_{template.name}")
                for w, stack in (entry or {}).items():
                    stack = np.asarray(stack)
                    for st in range(plan.n_stages):
                        op_s = plan.segments[st * k + j][r]
                        tree.setdefault(op_s.name, {})[w] = stack[st]
    model.load_params(tree)


def opt_state_from_jax(model: FFModel, opt_state) -> None:
    """Carry a JAX FFModel's optimizer state (`model.opt_state`) into the
    port's `model`, by op name and weight name; bf16 moments cross as f32,
    which holds every bf16 value exactly. On a mesh each rank keeps its
    shards."""
    def host(v):
        if isinstance(v, dict):
            return {k: host(x) for k, x in v.items()}
        return np.asarray(v, np.float32) if np.ndim(v) else np.asarray(v)

    model.load_opt_state(host(dict(opt_state)))
