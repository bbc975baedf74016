"""Executor: walks the graph eagerly on one torch device (counterpart of
flexflow_tpu/runtime/executor.py `forward_values` and the step builders).

The JAX executor traces the walk into one jitted program; here each op
runs as it is reached. Every op output is cast to its boundary storage
dtype (`emit_dtype`: bf16 under mixed precision), exactly where the JAX
executor casts. Inference runs under `torch.no_grad()`; training runs the
same walk under autograd, and its step functions update the parameters
in place. Parameters stay f32, so their gradients arrive in f32, as
`jax.value_and_grad` gives them.

On a mesh (core/machine.py) each process walks the graph on its slice of
the batch with its shards of the weights; the ops restore replicated
activations themselves (runtime/collectives.py). An op the plan keeps
below the mesh's data degree (`Op.whole_batch`, the strategy search's
dp = 1) computes the whole batch: the walk gathers its batch-cut inputs
over `data` before it and cuts its outputs back after it
(collectives.gather_batch / cut_batch; `batch_cut` says whether this
walk's inputs were cut, FFModel._data_slice sets it). After the
backward, the gradients and the reported metrics are averaged over the
`data` axis, so every rank's optimizer sees the gradient of the global
batch's loss, as `jax.grad` under GSPMD gives it.

The other mesh axes cut activations too (core/machine.py). Each value
of a walk carries the axes it is cut over (`data`: the batch, dim 0;
`seq`: the positions, dim 1; `attr`: the H of NCHW, dim 2), and each op
says whether it computes on cut values (`Op.seq_local`,
`Op.attr_local`, FFModel._assign_strategy). Before an op that does not,
the walk gathers its inputs' cut dims (collectives.gather_dim); before
one that does, it cuts its whole inputs of the same positions (or H)
to this rank's slice (a slice: convolutions and pools cut their own,
halo included, ops/conv.py). The op sees its inputs' axes in
`LoweringContext.in_cuts`; its outputs are cut where an input was. The
final tensor is gathered over `seq` and `attr` before the loss. After
the backward the gradients are averaged over `seq` and `attr` as over
`data`: each rank's loss is the whole loss, and every collective
between those ranks gives in its backward the sum of the ranks'
gradients (runtime/collectives.py), so the average is the global
gradient.

An explicit parallel op (parallel/parallel_ops.py) changes its value's
cuts itself (`Op.reshard`): a Combine or Replicate of a data-cut value
makes it whole, and the ops after it compute on the whole batch until a
Repartition cuts it again; an op meeting such a value beside a data-cut
one cuts it to the rank's samples, and so does the loss (`whole_value`).
Over `data` the gradients are averaged in one flat bucket, or, under an
explicit grad-sync lowering (`grad_sync_lowering`,
runtime/collectives.py GradSyncLowering), by the reduction plan's
per-tensor strategies and fused buckets.

On a `stage` axis (JAX `executor.py:55-64, 100-140`) the graph's
repeated-block region (parallel/pipeline_plan.py `find_pipeline_plan`)
runs through the GPipe schedule (kernels/pipeline.py): this rank walks
its stage's segments of the region with its own ops' weights, on
`config.pipeline_microbatches` microbatches; the ops outside the region
run replicated on every stage.

Several optimizer steps a dispatch (`build_multi_step`, the JAX
package's jitted `lax.scan` of K steps) run on the card as one CUDA
graph of K captured steps, and on the CPU as K eager steps. On a mesh of
CUDA ranks they run as K eager steps in one host dispatch, uncaptured:
runtime/distributed.py `graph_capture` decides it where it decides the
backend, and `MultiStep.stats()` says so. Gradient
accumulation (`build_accum_step`) sums the microbatches' gradients in
place and runs one optimizer update on their mean.

A training walk draws its dropout masks from one `torch.Generator` on
the executor's device, seeded from `config.seed` (the JAX package seeds
its per-step keys from the same field, `FFModel._next_rng`). The stream
is not JAX's: each draw moves the generator on, so every step (and every
microbatch of an accumulated step) draws new masks. K steps a dispatch
draw what K eager steps draw from the same generator state, to the bit:
the generator is registered with the CUDA graph, whose replays read its
offset and advance it by the K steps' draws. JAX instead splits one key
per K-step chunk (`flexflow_tpu/model.py` fit), so its K-step stream
differs from its single steps'; the port's does not. Ops' state (batch
norm's running statistics, core/op.py) is updated in place by each
training walk, inside a graph too.

The manual loop's pieces (JAX `build_forward`, `build_grad_step`):
`build_forward` walks in a given mode without recording for autograd
and returns the final tensor's value; `build_grad_step` is the training
walk and backward of one batch with the auxiliary losses and no
regularizer (JAX's `grad_step` adds none), writing no op state (the
forward before it did). Both take an iteration seq_length
(`LoweringContext.iter_seq_length`). A regularization term (`reg_fn`,
the model's weight regularizers over the f32 masters) joins the
training loss of the single step, the K-step dispatch and gradient
accumulation, as JAX passes `reg_fn`; eval's loss has none.

Dispatch spans (obs/tracing.py `traced_dispatch`, JAX's names): one
`executor.train_step` an eager step, one `executor.multi_step` a K-step
dispatch (its inner steps emit none), `executor.eval_step` and
`executor.forward`. While tracing is off each costs one attribute
check.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.graph import Graph
from ..core.op import LoweringContext
from ..ffconst import CompMode, OpType
from ..obs.tracing import get_tracer, traced_dispatch
from ..ops.common import emit_dtype
from ..search.simulator import AP_CAPABLE
from .collectives import (CUT_DIMS, cut_batch, cut_dim, gather_batch,
                          gather_dim, mean_)
from .graphs import CapturedCall, Staging, graph_counts

Tree = Dict[str, Dict[str, torch.Tensor]]


class Executor:
    def __init__(self, graph: Graph, config, mesh=None):
        self.graph = graph
        self.config = config
        self.mesh = mesh
        self.topo = graph.topo_order()
        self._generator: Optional[torch.Generator] = None
        # whether the walks' inputs are this rank's slice of the batch
        # over `data` (FFModel._data_slice decides it a batch)
        self.batch_cut = True
        # the last walk's cut axes by tensor guid, and the values a
        # parallel op made whole of the batch (forward_values)
        self.last_cuts: Dict[int, frozenset] = {}
        self.last_made_whole: set = set()
        # the data axis's explicit gradient sync (FFModel.compile sets it
        # under collective_lowering; None: the one flat bucket)
        self.grad_sync_lowering = None
        # a `stage` axis: the pipelined region and its microbatches
        self.pipeline_plan = None
        if mesh is not None and mesh.size("stage") > 1:
            from ..parallel.pipeline_plan import find_pipeline_plan

            plan = self.pipeline_plan = find_pipeline_plan(
                graph, mesh.size("stage"))
            self.pipeline_microbatches = max(
                1, int(getattr(config, "pipeline_microbatches", 4)))
            # op guid -> the stage whose ranks hold the op
            self._stages = {op.guid: g // plan.segs_per_stage
                            for g, group in enumerate(plan.segments)
                            for op in group}

    @property
    def device(self) -> torch.device:
        return self.mesh.device if self.mesh is not None \
            else torch.device(self.config.device)

    @property
    def generator(self) -> torch.Generator:
        """The training walks' random stream on this executor's device,
        seeded from `config.seed` at first use."""
        if self._generator is None:
            self._generator = torch.Generator(
                device=self.device).manual_seed(int(self.config.seed))
        return self._generator

    def device_batch(self, inputs: Dict[str, np.ndarray], label: np.ndarray
                     ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """One step's host arrays on this executor's device, each input
        cast there to its declared dtype (a bf16 input arrives as f32:
        numpy has no bf16)."""
        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        return self.cast_inputs({k: dev(v) for k, v in inputs.items()}), \
            dev(label)

    def cast_inputs(self, inputs: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """Each input in its declared dtype (no copy where it has it)."""
        dtypes = {op.name: op.outputs[0].dtype.torch_dtype
                  for op in self.topo if op.op_type == OpType.INPUT}
        return {k: v.to(dtypes[k]) for k, v in inputs.items()}

    def parameters(self) -> Tree:
        """op name -> weight name -> the op's parameter (the master)."""
        return {op.name: {ws.name: op._parameters[ws.name]
                          for ws in op.specs}
                for op in self.topo if op.specs and op.held}

    # -- the pipelined region (a `stage` axis) -------------------------------
    def stage_of(self, op) -> Optional[int]:
        """The stage whose ranks hold `op`'s weights; None outside the
        pipelined region."""
        if self.pipeline_plan is None:
            return None
        return self._stages.get(op.guid)

    def _run_pipeline(self, x: torch.Tensor, ctx) -> torch.Tensor:
        """The region's output from its input: GPipe over `stage`, this
        rank's stage walking its own segments' ops on each microbatch."""
        from ..kernels.pipeline import gpipe

        plan = self.pipeline_plan
        k = plan.segs_per_stage
        s = self.mesh.index("stage")
        groups = plan.segments[s * k:(s + 1) * k]
        entry, last = plan.entries[s * k], groups[-1][-1].outputs[0]
        sub = LoweringContext(self.config, ctx.mode)
        sub.generator = ctx.generator
        sub.aux_losses = ctx.aux_losses
        sub.iter_seq_length = ctx.iter_seq_length
        sub.write_state = ctx.write_state

        def stage_fn(x_in):
            values = {entry.guid: x_in}
            for group in groups:
                for op in group:
                    outs = op.lower(sub, [values[t.guid] for t in op.inputs])
                    for t, v in zip(op.outputs, outs):
                        values[t.guid] = v.to(emit_dtype(self.config,
                                                         t.dtype))
            return values[last.guid]

        return gpipe(stage_fn, x, self.mesh, "stage",
                     self.pipeline_microbatches)

    # -- cut activations (the module docstring) ------------------------------
    def _prepare(self, op, ins, in_cuts, axis: str, local: bool,
                 min_rank: int):
        """`op`'s inputs over `axis`: gathered where the op does not
        compute on cut values; where it does, its whole inputs of rank >=
        min_rank with the output's size on the axis's dim cut (not for a
        convolution or pool, which cut their own rows)."""
        dim = CUT_DIMS[axis]
        ins, in_cuts = list(ins), list(in_cuts)
        out = op.outputs[0].dims
        for i, (t, v, c) in enumerate(zip(op.inputs, ins, in_cuts)):
            if axis in c and not local:
                ins[i] = gather_dim(v, self.mesh, axis, dim)
                in_cuts[i] = c - {axis}
            elif (local and axis not in c and op.op_type not in AP_CAPABLE
                  and len(t.dims) >= min_rank and len(out) > dim
                  and t.dims[dim] == out[dim] and v.dim() == len(t.dims)):
                ins[i] = cut_dim(v, self.mesh, axis, dim)
                in_cuts[i] = c | {axis}
        return ins, in_cuts

    def _cut_whole_batch(self, op, ins, in_cuts, made_whole):
        """Beside a data-cut input, a whole input of the same batch that
        a parallel op made whole (`made_whole`) cut to this rank's slice:
        the op computes on the rank's samples alone."""
        if not made_whole:
            return ins, in_cuts
        batch = next(t.dims[0] for t, c in zip(op.inputs, in_cuts)
                     if "data" in c)
        ins, in_cuts = list(ins), list(in_cuts)
        for i, (t, v, c) in enumerate(zip(op.inputs, ins, in_cuts)):
            if (t.guid in made_whole and t.dims[0] == batch
                    and v.shape[0] == batch):
                ins[i] = cut_dim(v, self.mesh, "data", 0)
                in_cuts[i] = c | {"data"}
        return ins, in_cuts

    def _whole(self, v: torch.Tensor, cuts) -> torch.Tensor:
        """v gathered over `seq` and `attr` where `cuts` names them (its
        `data` cut stays)."""
        for axis in ("seq", "attr"):
            if axis in cuts:
                v = gather_dim(v, self.mesh, axis, CUT_DIMS[axis])
        return v

    def whole_value(self, values: Dict[int, torch.Tensor], tensor
                    ) -> torch.Tensor:
        """`tensor`'s value of the last walk, whole over `seq` and
        `attr`, and cut over `data` as the walk's inputs were (a value a
        parallel op made whole is cut to the rank's samples, which its
        label holds)."""
        cuts = self.last_cuts.get(tensor.guid, frozenset())
        v = self._whole(values[tensor.guid], cuts)
        mesh = self.mesh
        if (tensor.guid in self.last_made_whole
                and tensor.dims[0] % mesh.size("data") == 0):
            v = cut_dim(v, mesh, "data", 0)
        return v

    def forward_values(
        self,
        input_values: Dict[str, torch.Tensor],
        state: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
        decode_pos=None,
        mode: CompMode = CompMode.COMP_MODE_INFERENCE,
        fill_kv_cache: bool = False,
        aux_losses: Optional[List[torch.Tensor]] = None,
        seq_length: Optional[int] = None,
        write_state: bool = True,
        record: Optional[bool] = None,
    ) -> Dict[int, torch.Tensor]:
        """Returns tensor guid -> value. state: op name -> {var: tensor},
        e.g. each attention op's "k_cache"/"v_cache", updated in place.
        decode_pos: an int chunk offset, a 0-d int32 tensor offset, or a
        (B,) int32 tensor of per-row positions (ops/attention.py).
        fill_kv_cache: a full-sequence (prefill) walk that also writes the
        prompt's K/V rows into the caches in `state`. COMP_MODE_TRAINING
        records the walk for autograd and takes no caches. aux_losses: a
        list that receives the ops' auxiliary losses (the MoE load-balance
        loss). seq_length: the iteration's sequence length (ops with a
        sequence dim compute on its first positions). write_state=False:
        a training walk that writes no op state. record: whether autograd
        records the walk (default: a training walk does).

        Ops' own state (batch norm's running statistics, the MoE router's
        and the cache's; core/op.py `Op.writes_state`): a training walk
        updates it, and so does a walk handed `state` under an op's name
        (`model.state`); other walks (eval, predict, and the serving
        walks, which hold only KV caches, as the JAX batcher's) read it
        and leave it."""
        training = mode == CompMode.COMP_MODE_TRAINING
        if training and (state or decode_pos is not None or fill_kv_cache):
            raise ValueError("a training walk takes no KV caches and no "
                             "decode position")
        if fill_kv_cache and decode_pos is not None:
            raise ValueError("fill_kv_cache is a full-sequence walk: it "
                             "takes no decode position")
        if isinstance(decode_pos, (int, np.integer)):
            # one chunk-offset entry: a host offset becomes the 0-d device
            # tensor a captured chunk passes
            decode_pos = torch.tensor(int(decode_pos), dtype=torch.int32,
                                      device=self.device)
        ctx = LoweringContext(self.config, mode)
        ctx.mesh = self.mesh
        ctx.decode_pos = decode_pos
        ctx.fill_kv_cache = bool(fill_kv_cache)
        ctx.state = state if state is not None else {}
        if aux_losses is not None:
            ctx.aux_losses = aux_losses
        ctx.iter_seq_length = seq_length
        ctx.write_state = write_state
        if training:
            ctx.generator = self.generator
        mesh = self.mesh
        dp, sp, ap = ((mesh.size("data"), mesh.size("seq"), mesh.size("attr"))
                      if mesh is not None else (1, 1, 1))
        # tensor guid -> the mesh axes its value is cut over
        cuts: Dict[int, frozenset] = {}
        inputs_cut = frozenset({"data"} if dp > 1 and self.batch_cut
                               else ())
        # values of the whole batch a parallel op made from data-cut ones,
        # and what ops compute from them alone
        made_whole: set = set()
        plan = self.pipeline_plan
        with torch.set_grad_enabled(training if record is None
                                    else record):
            for op in self.topo:
                if plan is not None and op.guid in plan.region_guids:
                    if op.guid == plan.first_op_guid:
                        t_in, t_out = plan.region_input, plan.region_output
                        c = cuts.get(t_in.guid, frozenset())
                        out = self._run_pipeline(
                            self._whole(ctx.values[t_in.guid], c), ctx)
                        ctx.values[t_out.guid] = out.to(
                            emit_dtype(self.config, t_out.dtype))
                        if "data" in c:
                            cuts[t_out.guid] = frozenset({"data"})
                    continue
                if op.op_type == OpType.INPUT:
                    ctx.values[op.outputs[0].guid] = input_values[op.name]
                    if inputs_cut:
                        cuts[op.outputs[0].guid] = inputs_cut
                    continue
                ins = [ctx.values[t.guid] for t in op.inputs]
                in_cuts = [cuts.get(t.guid, frozenset()) for t in op.inputs]
                if mesh is not None and hasattr(op, "reshard"):
                    # an explicit parallel op (parallel/parallel_ops.py)
                    v, c = op.reshard(mesh, ins[0], in_cuts[0])
                    t = op.outputs[0]
                    # a gather's or a cut's view, laid out for the kernels
                    ctx.values[t.guid] = v.to(emit_dtype(
                        self.config, t.dtype)).contiguous()
                    if c:
                        cuts[t.guid] = frozenset(c)
                    elif inputs_cut and t.dims and v.dim() \
                            and v.shape[0] == t.dims[0]:
                        made_whole.add(t.guid)
                    continue
                fed_cut = any("data" in c for c in in_cuts)
                whole = fed_cut and op.whole_batch
                if fed_cut and not whole:
                    ins, in_cuts = self._cut_whole_batch(op, ins, in_cuts,
                                                         made_whole)
                elif not fed_cut and any(t.guid in made_whole
                                         for t in op.inputs):
                    made_whole.update(t.guid for t in op.outputs)
                if whole:
                    group, at = mesh.group("data"), mesh.index("data")
                    ins = [gather_batch(v, group, at, dp) if "data" in c
                           else v for v, c in zip(ins, in_cuts)]
                    in_cuts = [c - {"data"} for c in in_cuts]
                if sp > 1:
                    ins, in_cuts = self._prepare(op, ins, in_cuts, "seq",
                                                 op.seq_local, 3)
                if ap > 1:
                    ins, in_cuts = self._prepare(op, ins, in_cuts, "attr",
                                                 op.attr_local, 4)
                ctx.in_cuts = in_cuts
                outs = op.lower(ctx, ins)
                axes = set()
                if fed_cut and not op.gathers_data:
                    axes.add("data")
                if op.seq_local and any("seq" in c for c in in_cuts):
                    axes.add("seq")
                if op.attr_local and (op.op_type in AP_CAPABLE or any(
                        "attr" in c for c in in_cuts)):
                    axes.add("attr")
                for t, v in zip(op.outputs, outs):
                    v = v.to(emit_dtype(self.config, t.dtype))
                    t_axes = set(axes)
                    if whole:
                        part = cut_batch(v, at, dp)
                        if part is v:  # no batch dim: whole
                            t_axes.discard("data")
                        v = part
                    ctx.values[t.guid] = v
                    if t_axes:
                        cuts[t.guid] = frozenset(t_axes)
        self.last_cuts = cuts
        self.last_made_whole = made_whole
        return ctx.values

    # -- step builders -----------------------------------------------------
    def build_grad_metrics_step(self, loss_fn, metrics, final_tensor,
                                reg_fn=None, seq_length: Optional[int] = None,
                                write_state: bool = True):
        """(inputs, label) -> (grads, metric values incl. loss): one
        training-mode walk, the loss (with the ops' auxiliary losses added,
        as the JAX step adds `ctx.aux_losses`, and `reg_fn(parameters)`
        when given), and its backward. Gradients are returned as a tree
        like the parameters' (zeros where a weight got none, as jax.grad
        gives); on a mesh with a `data` axis, gradients and metrics are
        the means over it. `metrics` None computes the loss alone."""
        params = self.parameters()
        flat = [(op, w, p) for op, ws in params.items()
                for w, p in ws.items()]

        def gstep(inputs, label):
            aux: List[torch.Tensor] = []
            values = self.forward_values(inputs,
                                         mode=CompMode.COMP_MODE_TRAINING,
                                         aux_losses=aux,
                                         seq_length=seq_length,
                                         write_state=write_state)
            pred = self.whole_value(values, final_tensor)
            loss = loss_fn(pred, label)
            if aux:
                loss = loss + sum(aux[1:], aux[0])
            if reg_fn is not None:
                loss = loss + reg_fn(params)
            with torch.no_grad():
                mvals = metrics.compute(pred, label) if metrics else {}
            got = torch.autograd.grad(loss, [p for _, _, p in flat],
                                      allow_unused=True)
            grads: Tree = {op: {} for op in params}
            for (op, w, p), g in zip(flat, got):
                grads[op][w] = torch.zeros_like(p) if g is None else g
            mvals["loss"] = loss.detach()
            self._data_mean([grads[op][w] for op, w, _ in flat], mvals,
                            grads)
            return grads, mvals

        return gstep

    def _data_mean(self, grads, mvals, tree: Optional[Tree] = None) -> None:
        """Average gradients (one bucket an axis) over the mesh's `data`,
        `seq` and `attr` axes, and the metric values over `data` (they are
        the same on every rank of the other two), in place; nothing
        without those axes. Over `data`, an explicit grad-sync lowering
        (`grad_sync_lowering`, runtime/collectives.py GradSyncLowering)
        runs the plan's per-tensor strategies and fused buckets over the
        gradient `tree` instead of the one flat bucket."""
        if self.mesh is None:
            return
        with torch.no_grad():
            for axis in ("seq", "attr"):
                size = self.mesh.size(axis)
                if size > 1:
                    mean_(grads, self.mesh.group(axis), size)
            size = self.mesh.size("data")
            if size == 1:
                return
            group = self.mesh.group("data")
            if self.grad_sync_lowering is not None and tree is not None:
                self.grad_sync_lowering.sync_tree(tree)
            else:
                mean_(grads, group, size)
            keys = sorted(mvals)
            vals = torch.stack([mvals[k].float() for k in keys])
            mean_([vals], group, size)
        mvals.update(zip(keys, vals.unbind()))

    def build_train_step(self, optimizer, loss_fn, metrics, final_tensor,
                         reg_fn=None):
        """(inputs, label, opt_state) -> metric values: forward, loss,
        backward, then the optimizer's in-place update of the parameters
        and of `opt_state`; each call an `executor.train_step` span (the
        untraced step is the result's `__wrapped__`, which MultiStep
        runs)."""
        gstep = self.build_grad_metrics_step(loss_fn, metrics, final_tensor,
                                             reg_fn)
        params = self.parameters()

        def train_step(inputs, label, opt_state):
            grads, mvals = gstep(inputs, label)
            optimizer.update(params, grads, opt_state, self.config)
            return mvals

        return traced_dispatch(train_step, "executor.train_step")

    def build_elastic_step(self, loss_fn, metrics, final_tensor,
                           reg_fn=None):
        """(inputs, label) -> (gradients, metric values), nothing applied:
        the elastic coordinator's step (JAX's coordinator computes each
        step into temporaries, so that a watchdog SKIP never commits;
        FFModel `_commit_step` applies the update). The dispatch runs
        under `config.elastic_step_wrapper` when set (JAX
        `Executor.step_wrapper`: fault injection, classification and
        retry), inside one `executor.train_step` span, so retries are
        inside it."""
        fn = self.build_grad_metrics_step(loss_fn, metrics, final_tensor,
                                          reg_fn)
        wrapper = getattr(self.config, "elastic_step_wrapper", None)
        if wrapper is not None:
            fn = wrapper(fn)
        return traced_dispatch(fn, "executor.train_step")

    def build_accum_step(self, optimizer, loss_fn, metrics, final_tensor,
                         reg_fn=None):
        """(batches, opt_state) -> (summed metric values, k): the gradients
        of k microbatches (an iterable of device (inputs, label)) summed
        in place, divided by k, then one optimizer update (JAX
        `_build_accum_fns`, `reg_fn` in each microbatch's loss). The
        metric values are sums over the k microbatches; the caller divides
        (on the host, as JAX does)."""
        gstep = self.build_grad_metrics_step(loss_fn, metrics, final_tensor,
                                             reg_fn)
        params = self.parameters()

        def accum_step(batches, opt_state):
            acc, msum, k = None, None, 0
            for inputs, label in batches:
                grads, mvals = gstep(inputs, label)
                k += 1
                with torch.no_grad():
                    if acc is None:
                        # autograd may hand one tensor to two weights (the
                        # gradient of a sum): own each accumulator
                        seen: set = set()
                        acc = {op: {} for op in grads}
                        for op, ws in grads.items():
                            for w, g in ws.items():
                                if g.data_ptr() in seen:
                                    g = g.clone()
                                seen.add(g.data_ptr())
                                acc[op][w] = g
                        msum = dict(mvals)
                        continue
                    for op, ws in grads.items():
                        for w, g in ws.items():
                            acc[op][w].add_(g)
                    msum = {key: msum[key] + mvals[key] for key in msum}
            with torch.no_grad():
                for ws in acc.values():
                    for g in ws.values():
                        g.div_(float(k))
            optimizer.update(params, acc, opt_state, self.config)
            return msum, k

        return accum_step

    def build_multi_step(self, optimizer, loss_fn, metrics, final_tensor,
                         steps: int, reg_fn=None) -> "MultiStep":
        """K = `steps` training steps a dispatch (JAX `build_multi_step`):
        see MultiStep."""
        return MultiStep(self, self.build_train_step(
            optimizer, loss_fn, metrics, final_tensor, reg_fn).__wrapped__,
            metrics.keys() + ["loss"], steps)

    def build_eval_step(self, loss_fn, metrics, final_tensor):
        """(inputs, label) -> (metric values incl. loss, pred), inference
        mode, no gradients."""

        def eval_step(inputs, label):
            values = self.forward_values(inputs)
            pred = self.whole_value(values, final_tensor)
            with torch.no_grad():
                mvals = metrics.compute(pred, label) if metrics else {}
                mvals["loss"] = loss_fn(pred, label)
            self._data_mean([], mvals)
            return mvals, pred

        return traced_dispatch(eval_step, "executor.eval_step")

    def build_forward(self, final_tensor,
                      mode: CompMode = CompMode.COMP_MODE_INFERENCE,
                      seq_length: Optional[int] = None):
        """inputs -> the final tensor's value, one walk in `mode` that
        autograd does not record (JAX `build_forward`): an inference walk
        (predict) reads the ops' state, a training walk (the manual loop's
        forward in a training compile: dropout on, batch statistics) writes
        it, as JAX's forward keeps its new state."""

        def fwd(inputs):
            values = self.forward_values(inputs, mode=mode,
                                         seq_length=seq_length, record=False)
            return self.whole_value(values, final_tensor)

        return traced_dispatch(fwd, "executor.forward")

    def build_grad_step(self, loss_fn, final_tensor,
                        seq_length: Optional[int] = None):
        """(inputs, label) -> gradients: the manual loop's backward (JAX
        `build_grad_step`): a training walk that writes no op state, the
        loss with the auxiliary losses and no regularizer, its backward;
        on a `data` axis the gradients' means."""
        gstep = self.build_grad_metrics_step(loss_fn, None, final_tensor,
                                             seq_length=seq_length,
                                             write_state=False)

        def grad_step(inputs, label):
            return gstep(inputs, label)[0]

        return grad_step


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict (an optimizer state)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return []


class MultiStep:
    """K training steps a dispatch. Called with K host batches (a list of
    (inputs, label) numpy arrays), it runs them in order and returns a
    (len(keys), K) f32 tensor on the device: row i is metric keys[i]
    (the compiled metrics, then "loss") of each step. On the card the
    result is queued, not waited for: reading it to the host waits.

    On the CPU the K steps run eagerly, one after another, and so they
    do on a mesh of CUDA ranks (runtime/distributed.py `graph_capture`:
    gloo's host-staged collectives cannot be captured, ranks sharing one
    card cannot use NCCL, and capturing NCCL is untried), the metrics
    written into a device tensor, so the dispatch queues and reading it
    waits, as a replay's. On one card
    they are one CUDA graph (runtime/graphs.py `CapturedCall`): the steps
    read their batches from static stacked (K, batch, ...) buffers,
    packed into one byte buffer that a dispatch fills by ONE copy from
    pinned host memory (`Staging`), then the graph replays. The first
    dispatch runs its K steps eagerly on a side stream (the warm-up that
    capture needs: cuBLAS workspaces, kernel attributes, the autograd
    engine's streams), then captures the K steps; later dispatches
    replay. A launch counter counts the first dispatch's K eager steps
    and the capture's K, and nothing for a replay. A failed capture or
    replay raises: there is no eager fallback on the card. The graph's
    private memory pool holds one step's activations and gradients for
    the graph's lifetime. The graph writes the weights itself, so it is
    captured with no weights to watch; a replay writes the weights and
    the optimizer state behind autograd's back, so each replay bumps
    their version counters, as an in-place op would: what caches a
    weight by its version (core/op.py `Op.w`) sees the change. The
    executor's generator is registered with the graph, so each replay
    draws new dropout masks, those K eager steps would draw. A dispatch
    is one `executor.multi_step` span; its steps emit none."""

    _ALIGN = 16

    def __init__(self, executor: Executor, train_step, keys: List[str],
                 steps: int):
        self.executor = executor
        self.train_step = train_step
        self.keys = list(keys)
        self.steps = int(steps)
        self.device = executor.device
        self.call: Optional[CapturedCall] = None
        self.counts = graph_counts()
        self.layout = None
        from .distributed import graph_capture

        self.captured, self.reason = graph_capture(self.device,
                                                   executor.mesh)

    def stats(self) -> Dict[str, object]:
        """Whether the K steps are one captured CUDA graph (and, if not,
        why), with the graph's warm-up / capture / replay counts."""
        return {"steps": self.steps, "captured": self.captured,
                "reason": self.reason, **self.counts}

    def __call__(self, batches: Sequence[Tuple[Dict[str, np.ndarray],
                                               np.ndarray]], opt_state):
        with get_tracer().span("executor.multi_step", steps=self.steps):
            return self._dispatch(batches, opt_state)

    def _dispatch(self, batches, opt_state):
        if len(batches) != self.steps:
            raise ValueError(f"MultiStep of {self.steps} steps given "
                             f"{len(batches)} batches")
        if not self.captured:
            out = torch.empty((len(self.keys), self.steps),
                              dtype=torch.float32, device=self.device)
            for j, (inputs, label) in enumerate(batches):
                mvals = self.train_step(
                    *self.executor.device_batch(inputs, label), opt_state)
                for i, k in enumerate(self.keys):
                    out[i, j] = mvals[k]
            return out
        layout = self._layout(batches[0])
        if self.layout is None:
            self._allocate(layout)
        elif layout != self.layout:
            raise ValueError(f"MultiStep: batch layout {layout} differs "
                             f"from the captured {self.layout}")
        self._stage(batches)
        if self.call is None:
            self.call = CapturedCall(lambda: self._steps(opt_state),
                                     self.device, [], self.counts,
                                     generators=[self.executor.generator])
            self.call()
            self.written = [p for ws in self.executor.parameters().values()
                            for p in ws.values()] + _leaves(opt_state)
        else:
            self.call()
            torch.autograd.graph.increment_version(self.written)
        return self.out.clone()

    # -- the card ---------------------------------------------------------
    def _layout(self, batch):
        inputs, label = batch
        arrays = [*sorted(inputs.items()), ("", label)]
        return tuple((k, tuple(a.shape), np.dtype(a.dtype).str)
                     for k, a in arrays)

    def _allocate(self, layout) -> None:
        """The static byte buffer on the card, its staging, and each
        (K, batch, ...) array's view into it (16-byte aligned)."""
        self.layout = layout
        spans, off = [], 0
        for name, shape, dt in layout:
            nbytes = self.steps * int(np.prod(shape)) * np.dtype(dt).itemsize
            spans.append((name, off, nbytes, shape, np.dtype(dt)))
            off += -(-nbytes // self._ALIGN) * self._ALIGN
        self.staging = Staging(max(off, 1), self.device, torch.uint8)
        self.spans = spans
        self.views = {}
        for name, start, nbytes, shape, dt in spans:
            seg = self.staging.buf[start:start + nbytes]
            tdt = torch.from_numpy(np.empty(0, dt)).dtype
            self.views[name] = seg.view(tdt).view(self.steps, *shape)
        self.out = torch.zeros((len(self.keys), self.steps),
                               dtype=torch.float32, device=self.device)

    def _stage(self, batches) -> None:
        host = self.staging.host()
        for name, start, nbytes, shape, dt in self.spans:
            dst = host[start:start + nbytes].view(dt).reshape(
                self.steps, *shape)
            for j, (inputs, label) in enumerate(batches):
                dst[j] = label if name == "" else inputs[name]
        self.staging.send()

    def _steps(self, opt_state) -> None:
        """The K steps from the static buffers, each writing its metrics
        into column j of `out`."""
        label_k = self.views[""]
        inputs_k = {k: v for k, v in self.views.items() if k}
        for j in range(self.steps):
            inputs = self.executor.cast_inputs(
                {k: v[j] for k, v in inputs_k.items()})
            mvals = self.train_step(inputs, label_k[j], opt_state)
            for i, k in enumerate(self.keys):
                self.out[i, j].copy_(mvals[k])
