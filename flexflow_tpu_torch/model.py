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
from typing import Dict, List, Mapping, Optional, Sequence, Union

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
from .runtime.executor import Executor
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
        self._assign_strategy(order)
        for op in order:
            op.init_weights(generator, self.device, trainable=training)
        if not training:
            return
        self.optimizer = optimizer or SGDOptimizer(
            self, lr=self.config.learning_rate)
        self.loss = Loss(loss_type)
        self.metrics = Metrics(loss_type, list(metrics))
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
    def _batch(self, x: List[np.ndarray], y, lo: int, hi: int):
        """(inputs, label) of samples [lo, hi) on this rank's device; on a
        mesh with a `data` axis, this rank's equal slice of them (the whole
        batch, replicated, when it does not divide, as JAX's shard_batch
        replicates)."""
        dp = self.mesh.size("data") if self.mesh is not None else 1
        if dp > 1 and (hi - lo) % dp == 0:
            n = (hi - lo) // dp
            lo += self.mesh.index("data") * n
            hi = lo + n
        inputs = {op.name: torch.from_numpy(np.ascontiguousarray(
            arr[lo:hi]).astype(op.outputs[0].dtype.np_dtype)).to(self.device)
            for op, arr in zip(self.input_ops, x)}
        label = torch.from_numpy(np.ascontiguousarray(y[lo:hi]).astype(
            np.int32)).to(self.device)
        return inputs, label

    def _require_training(self, what: str) -> None:
        if self.comp_mode != CompMode.COMP_MODE_TRAINING:
            raise RuntimeError(f"{what} needs compile() in training mode")

    def fit(self, x: Union[np.ndarray, Sequence[np.ndarray]],
            y: np.ndarray, batch_size: Optional[int] = None,
            epochs: Optional[int] = None, accum_steps: int = 1,
            steps_per_execution: int = 1) -> List[Dict[str, float]]:
        """Train on (x, y) for `epochs` passes of n // batch_size steps.

        Returns the JAX package's history: one `PerfMetrics.summary()` per
        epoch (samples, accuracy, loss, cce, sparse_cce, mse, rmse, mae)
        with its `epoch` and `throughput` (samples per second over the
        epoch's wall). Each optimizer step also appends a record to
        `step_records` (emptied at the start of every call): its epoch,
        step, loss, the compiled metrics, host wall ms (from the batch's
        copy to the device until its loss reaches the host) and
        samples/s. Gradient accumulation and several steps per dispatch
        are not ported."""
        self._require_training("fit()")
        if accum_steps != 1:
            raise NotImplementedError(
                "fit(accum_steps > 1): gradient accumulation is not ported "
                "yet (ROADMAP A2)")
        if steps_per_execution != 1:
            raise NotImplementedError(
                "fit(steps_per_execution > 1): several optimizer steps per "
                "dispatch are not ported yet (ROADMAP A2, a CUDA graph of "
                "the step)")
        if isinstance(x, np.ndarray):
            x = [x]
        bs = batch_size or self.config.batch_size
        epochs = epochs or self.config.epochs
        n = x[0].shape[0]
        if n < bs:
            raise ValueError(f"dataset has {n} samples but batch_size is "
                             f"{bs}; fit needs at least one full step")
        self.step_records = []
        history: List[Dict[str, float]] = []
        for epoch in range(epochs):
            perf = PerfMetrics()
            t_epoch = time.time()
            for step in range(n // bs):
                t0 = time.perf_counter()
                inputs, label = self._batch(x, y, step * bs, (step + 1) * bs)
                mvals = self._train_step(inputs, label, self.opt_state)
                rec = {k: float(v) for k, v in mvals.items()}
                dt = time.perf_counter() - t0
                perf.update(bs, rec)
                rec.update(epoch=epoch, step=len(self.step_records),
                           step_ms=dt * 1e3, samples_per_s=bs / dt)
                self.step_records.append(rec)
            summ = perf.summary()
            summ["epoch"] = epoch
            summ["throughput"] = (n // bs) * bs / (time.time() - t_epoch)
            history.append(summ)
        return history

    def eval(self, x, y, batch_size: Optional[int] = None
             ) -> Dict[str, float]:
        """Metrics and loss over (x, y), the tail batch included, weighted
        by batch size."""
        self._require_training("eval()")
        if isinstance(x, np.ndarray):
            x = [x]
        bs = batch_size or self.config.batch_size
        n = x[0].shape[0]
        sums: Dict[str, float] = {}
        for lo in range(0, n, bs):
            hi = min(lo + bs, n)
            inputs, label = self._batch(x, y, lo, hi)
            mvals, _ = self._eval_step(inputs, label)
            for k, v in mvals.items():
                sums[k] = sums.get(k, 0.0) + float(v) * (hi - lo)
        out = {k: v / max(1, n) for k, v in sums.items()}
        out["samples"] = n
        return out

    def load_opt_state(self, state: Mapping[str, object]) -> None:
        """Load an optimizer state — {"step", "lr", and the optimizer's
        moment trees ("v" for momentum SGD, "m" and "v" for Adam) of op
        name -> weight name -> array} — into this model's, checking every
        name and shape; values keep this state's dtypes and device. The
        moments are given whole; on a mesh each rank keeps its shards."""
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
        mine["step"] = int(np.asarray(state["step"]))
        mine["lr"] = float(np.asarray(state["lr"]))

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
