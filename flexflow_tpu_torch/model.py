"""FFModel: the layer API, compile, fit and eval on one torch device or
on a data x model mesh of torch.distributed ranks (the subset of
flexflow_tpu/model.py the ported slices use).

Op names follow the JAX package's scheme (an explicit name, else
`<op type>_<n>` per model), so the same builder code gives the same op
and weight names in both packages and `params_from_jax` can carry a JAX
model's weights across.
"""
from __future__ import annotations

import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import ops as _ops  # noqa: F401  (registers every op type)
from .config import FFConfig
from .core.graph import Graph
from .core.machine import Mesh, check_axes, make_mesh
from .core.op import OP_REGISTRY, Op
from .core.tensor import ParallelDim, ParallelTensorShape, Tensor
from .ffconst import (ActiMode, AggrMode, CompMode, DataType, LossType,
                      MetricsType, OpType)
from .kernels.registry import KERNELS
from .runtime.collectives import gather_shards
from .runtime.executor import Executor, MultiStep
from .runtime.losses import Loss
from .runtime.metrics import Metrics, PerfMetrics
from .runtime.optimizers import Optimizer, SGDOptimizer
from .search.simulator import TP_CAPABLE, TP_WEIGHT_SHARD_DIMS


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
        # one record per optimizer step of the last fit() call (epoch,
        # step, loss, metrics, step_ms, samples_per_s): it stands in for
        # the JAX package's `step_stats` (a StepStats ring,
        # flexflow_tpu/model.py fit) until ROADMAP A9 ports
        # obs/stepstats.py
        self.step_records: List[Dict[str, float]] = []
        self._name_counts: Dict[OpType, int] = {}
        self._used_names: set = set()
        self.label_tensor: Optional[Tensor] = None
        self._dataloaders: list = []
        # fit(steps_per_execution=K)'s dispatch per K, and fit(accum_steps)'s
        # step; built at first use, dropped by compile()
        self._multi_steps: Dict[int, MultiStep] = {}
        self._accum_step = None

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
                  dtype: DataType = DataType.DT_FLOAT,
                  kernel_initializer=None, name: str = "") -> Tensor:
        return self._add_op(
            OpType.EMBEDDING, [input], name, num_entries=num_entries,
            out_dim=out_dim, aggr=aggr, dtype=dtype,
            kernel_initializer=kernel_initializer).outputs[0]

    def multihead_attention(self, query: Tensor, key: Tensor, value: Tensor,
                            embed_dim: int, num_heads: int, kdim: int = 0,
                            vdim: int = 0, dropout: float = 0.0,
                            bias: bool = True, causal: bool = False,
                            sequence_parallel: bool = False,
                            use_flash: Optional[bool] = None,
                            kernel_initializer=None,
                            name: str = "") -> Tensor:
        """use_flash: True / False force the full-sequence path to the
        flash kernel / the einsum reference core; None leaves it to the
        kernel registry. dropout > 0 and sequence_parallel raise: neither
        is ported."""
        return self._add_op(
            OpType.MULTIHEAD_ATTENTION, [query, key, value], name,
            embed_dim=embed_dim, num_heads=num_heads, kdim=kdim or None,
            vdim=vdim or None, dropout=dropout, bias=bias, causal=causal,
            sequence_parallel=sequence_parallel, use_flash=use_flash,
            kernel_initializer=kernel_initializer).outputs[0]

    # -- compile ----------------------------------------------------------
    def compile(self, optimizer: Optional[Optimizer] = None,
                loss_type: LossType =
                LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                metrics: Sequence[MetricsType] = (),
                comp_mode: CompMode = CompMode.COMP_MODE_TRAINING,
                parallel_axes: Optional[Dict[str, int]] = None,
                generator: Optional[torch.Generator] = None) -> None:
        """Build the graph and executor and draw every weight from
        `generator` (default: a CPU generator seeded 0) onto
        `config.device`.

        The strategy search is a stub that returns the one-device plan
        (ROADMAP A7). `parallel_axes={"data": dp, "model": tp}` trains on
        a mesh of dp * tp torch.distributed ranks, one process each
        (runtime/distributed.py initialize, before compile, on every
        rank): each data rank takes its slice of the batch, and the
        TP-capable ops shard their weights over `model` as the JAX
        package's `_assign_tp_weights` does. Every rank draws the whole
        model from the same generator and keeps its shards, so a mesh run
        starts from the one-device run's weights. The other axes, strategy
        import, row-parallel pairs and sharded serving raise (A8). In
        training mode (the default, as in the JAX package) the weights
        take gradients, `optimizer` defaults to SGD at
        `config.learning_rate`, and the train and eval steps are built;
        COMP_MODE_INFERENCE builds the executor only (the serving
        path)."""
        axes = check_axes(parallel_axes or {})
        self.mesh = None
        if axes:
            if comp_mode != CompMode.COMP_MODE_TRAINING:
                raise NotImplementedError(
                    f"parallel_axes={parallel_axes}: sharded serving "
                    "(inference on a mesh) is not ported yet (ROADMAP A8)")
            mesh = make_mesh(axes)
            if mesh.device.type != torch.device(self.config.device).type:
                raise ValueError(
                    f"config.device={self.config.device!r}, but this rank "
                    f"was initialized on {mesh.device}")
            self.mesh = mesh
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        # the kernel tier: this model's --kernel-impl becomes the default
        # of the config-less consumers (the loss and metric reductions)
        KERNELS.configure(self.config)
        self.comp_mode = comp_mode
        training = comp_mode == CompMode.COMP_MODE_TRAINING
        self.graph = Graph(self.ops)
        order = self.graph.topo_order()
        self.final_tensor = self.final_tensor or order[-1].outputs[0]
        self.executor = Executor(self.graph, self.config, self.mesh)
        self._multi_steps, self._accum_step = {}, None
        self._assign_strategy(order)
        for op in order:
            op.init_weights(generator, self.device, trainable=training)
        if not training:
            return
        self.optimizer = optimizer or SGDOptimizer(
            self, lr=self.config.learning_rate)
        self.loss = Loss(loss_type)
        self.metrics = Metrics(loss_type, list(metrics))
        # the label mirrors the final tensor (JAX `_label_dims`)
        fd = self.final_tensor.dims
        self.label_tensor = Tensor(
            fd[:-1] + (1,) if loss_type ==
            LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY else fd,
            self._label_dtype(), name="label")
        self._train_step = self.executor.build_train_step(
            self.optimizer, self.loss.fn, self.metrics, self.final_tensor)
        self._eval_step = self.executor.build_eval_step(
            self.loss.fn, self.metrics, self.final_tensor)
        self.opt_state = self.optimizer.init_state(self.executor.parameters())

    def _assign_strategy(self, order: Sequence[Op]) -> None:
        """The mesh-wide strategy (JAX `_assign_strategy`, its data and
        model dims): every TP-capable op shards its weights over `model`;
        the others keep theirs whole. The batch is cut over `data` in
        `_batch`, the activations stay replicated."""
        tp = self.mesh.size("model") if self.mesh is not None else 1
        coords = self.mesh.coords if self.mesh is not None else {}
        for op in order:
            shards = {}
            if tp > 1 and op.op_type in TP_CAPABLE:
                shards = self._assign_tp_weights(op, tp)
            op.set_sharding(shards, coords)

    @staticmethod
    def _assign_tp_weights(op: Op, tp: int) -> Dict[str, ParallelTensorShape]:
        """The parallel shape of each of `op`'s weights that shards over
        `model` (JAX `_assign_tp_weights`, column-parallel): the dim
        TP_WEIGHT_SHARD_DIMS names, where tp divides it. Row-parallel
        (`tp_row`) pairs come only from an imported strategy, which waits
        for ROADMAP A7."""
        shard_dim = TP_WEIGHT_SHARD_DIMS.get(op.op_type, {})
        out = {}
        for ws in op.specs:
            if ws.name not in shard_dim:
                continue
            d = shard_dim[ws.name] % len(ws.dims)
            if ws.dims[d] % tp:
                continue
            dims = [ParallelDim(s) for s in ws.dims]
            dims[d] = ParallelDim(ws.dims[d], tp, "model")
            out[ws.name] = ParallelTensorShape(dims, ws.dtype)
        return out

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
        dp = self.mesh.size("data") if self.mesh is not None else 1
        if dp > 1 and (hi - lo) % dp == 0:
            n = (hi - lo) // dp
            lo += self.mesh.index("data") * n
            hi = lo + n
        inputs = {op.name: np.ascontiguousarray(arr[lo:hi]).astype(
            op.outputs[0].dtype.host_np_dtype)
            for op, arr in zip(self.input_ops, x)}
        label = np.ascontiguousarray(y[lo:hi]).astype(
            self._label_dtype().np_dtype)
        return inputs, label

    def _batch(self, x: Sequence[np.ndarray], y, lo: int, hi: int):
        """(inputs, label) of samples [lo, hi) on this rank's device
        (`_host_batch`'s arrays, each input cast to its dtype)."""
        return self.executor.device_batch(*self._host_batch(x, y, lo, hi))

    def _require_training(self, what: str) -> None:
        if self.comp_mode != CompMode.COMP_MODE_TRAINING:
            raise RuntimeError(f"{what} needs compile() in training mode")

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
            steps_per_execution: int = 1) -> List[Dict[str, float]]:
        """Train on (x, y) for `epochs` passes of n // batch_size steps; with
        no x and y, on batches pulled from the attached dataloaders
        (runtime/dataloader.py), whose num_samples is n.

        Returns the JAX package's history: one `PerfMetrics.summary()` per
        epoch (samples, accuracy, loss, cce, sparse_cce, mse, rmse, mae)
        with its `epoch` and `throughput` (samples per second over the
        epoch's wall). Each record of `step_records` (emptied at the start
        of every call) is one optimizer step, or one dispatch of
        `steps_per_execution` steps: its epoch, step (the optimizer steps
        of this call before it), steps, loss and the compiled metrics
        (means over its steps), step_ms (host wall per optimizer step) and
        samples/s; a dispatch's record also holds `losses`, each step's.

        accum_steps > 1: each optimizer update averages the gradients of
        `accum_steps` consecutive microbatches of `batch_size`; its record
        holds the microbatches' mean metrics. steps_per_execution = K > 1:
        n // (batch_size * K) dispatches of K steps each (one CUDA graph
        on the card, runtime/executor.py MultiStep), the trailing n mod
        (batch_size * K) samples through the single step, so an epoch
        takes the n // batch_size updates of plain fit; a dispatch's
        metrics are read after the next one is queued. The two are
        mutually exclusive, as in the JAX package."""
        self._require_training("fit()")
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

        k = steps_per_execution
        multi = self._multi_step(k) if k > 1 else None
        self.step_records = []
        history: List[Dict[str, float]] = []
        for epoch in range(epochs):
            perf = PerfMetrics()
            t_epoch = time.time()
            if k > 1:
                chunks = n // (bs * k)
                pending, t_last = None, time.perf_counter()
                for chunk in range(chunks):
                    queued = multi([load_host(chunk * k + j)
                                    for j in range(k)], self.opt_state)
                    # one-deep pipeline: the previous dispatch's metrics
                    # are read after this one is queued
                    if pending is not None:
                        t_last = self._absorb(perf, pending, epoch, bs, k,
                                              t_last)
                    pending = queued
                if pending is not None:
                    self._absorb(perf, pending, epoch, bs, k, t_last)
                first_single, updates, micro = chunks * k, n // bs, 1
            else:
                first_single, updates = 0, n // (bs * accum_steps)
                micro = accum_steps
            for step_i in range(first_single, updates):
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
                self._record(perf, rec, epoch, bs * micro, 1,
                             time.perf_counter() - t0)
            summ = perf.summary()
            summ["epoch"] = epoch
            summ["throughput"] = updates * bs * micro / (time.time() - t_epoch)
            history.append(summ)
        return history

    def _record(self, perf: PerfMetrics, rec: Dict[str, float], epoch: int,
                samples: int, steps: int, dt: float) -> None:
        perf.update(samples, rec)
        last = self.step_records[-1] if self.step_records else None
        done = last["step"] + last["steps"] if last else 0
        rec.update(epoch=epoch, step=done, steps=steps,
                   step_ms=dt * 1e3 / steps, samples_per_s=samples / dt)
        self.step_records.append(rec)

    def _absorb(self, perf: PerfMetrics, queued: torch.Tensor, epoch: int,
                bs: int, k: int, t_last: float) -> float:
        """Record a dispatch's (keys, K) metrics: each key's mean over its K
        steps, weighted by the K * bs samples; returns the time it was
        read, which ends its interval."""
        vals = queued.cpu().numpy()
        t = time.perf_counter()
        keys = self._multi_step(k).keys
        rec = {key: float(vals[i].mean()) for i, key in enumerate(keys)}
        self._record(perf, rec, epoch, k * bs, k, t - t_last)
        rec["losses"] = [float(v) for v in vals[keys.index("loss")]]
        return t

    def _multi_step(self, k: int) -> MultiStep:
        if k not in self._multi_steps:
            self._multi_steps[k] = self.executor.build_multi_step(
                self.optimizer, self.loss.fn, self.metrics,
                self.final_tensor, k)
        return self._multi_steps[k]

    def _get_accum_step(self):
        if self._accum_step is None:
            self._accum_step = self.executor.build_accum_step(
                self.optimizer, self.loss.fn, self.metrics,
                self.final_tensor)
        return self._accum_step

    def eval(self, x, y, batch_size: Optional[int] = None
             ) -> Dict[str, float]:
        """The JAX package's `eval`: `PerfMetrics.summary()` over (x, y),
        the tail batch included (samples, accuracy as round(accuracy x
        batch) correct samples a batch, loss, cce, sparse_cce, mse, rmse,
        mae); batch i's metrics are read after batch i + 1 is queued."""
        self._require_training("eval()")
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

    # -- weights ----------------------------------------------------------
    @property
    def params(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """op name -> weight name -> tensor, the JAX `model.params` tree;
        each tensor shares the master's storage, outside autograd. On a
        mesh: this rank's shards (`gather_params` gives the whole)."""
        return {op.name: {ws.name: op.w(ws.name).detach() for ws in op.specs}
                for op in self.ops if op.specs}

    def gather_params(self, tree: Optional[Mapping] = None
                      ) -> Dict[str, Dict[str, torch.Tensor]]:
        """The whole of `tree` (default: the weights; or any tree shaped
        like them, such as gradients or moments) on every rank, gathered
        from the shards over `model`. Every rank of the mesh calls it. On
        one device it is the tree itself."""
        tree = self.params if tree is None else tree
        if self.mesh is None:
            return {op: dict(ws) for op, ws in tree.items()}
        group = self.mesh.group("model")
        size = self.mesh.size("model")
        out = {}
        for op in self.ops:
            if op.name not in tree:
                continue
            out[op.name] = {}
            for w, t in tree[op.name].items():
                pt = op.shards.get(w)
                if pt is not None:
                    (d,) = pt.sharded_dims()
                    t = gather_shards(t, d, group, size)
                out[op.name][w] = t
        return out

    def load_params(self, params: Mapping[str, Mapping[str, object]]) -> None:
        """Load every weight by op name and weight name. The tree must name
        exactly this model's weights with their (whole) shapes; each value
        (numpy array or tensor) is converted to the weight's dtype and
        device, and on a mesh each rank keeps its shards."""
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
    transposed."""
    model.load_params({op: {w: np.asarray(v) for w, v in ws.items()}
                       for op, ws in params.items()})


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
