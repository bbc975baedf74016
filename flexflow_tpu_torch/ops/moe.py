"""Mixture-of-Experts ops: GroupBy, Aggregate, AggregateSpec, Experts and
Cache (counterpart of flexflow_tpu/ops/moe.py).

The capacity formulation is the JAX package's: each expert takes a
fixed-capacity buffer (capacity = ceil(alpha * k * tokens / n), clamped
to >= k), a token's assignments are placed row-major over (token, j) at
the position given by a running count of its expert in token order, and
the assignments past capacity are dropped.

The JAX package dispatches and combines through one-hot contractions,
O(tokens * k * n * capacity * features) operations. Here the plan is two
index maps made on the device from an int32 running count: (token, j) ->
flat slot of the (n * capacity) buffer, or the sentinel past its end for
a dropped assignment; and slot -> (token, j), or the sentinel for an
empty slot. Dispatch and combine are gathers through those maps, each
an autograd Function whose backward is gathers too (dx[t] = the sum over
j, in j order, of dbuf[slot(t, j)]; dh[slot] = g * dout[token]; dg =
<dout[t], h[slot(t, j)]>), so no gradient depends on the order of atomic
adds and a CUDA graph of training steps repeats the eager steps' bits.
The plan reads no value back to the host and makes no shape from data:
it runs inside the captured decode, chunk and K-step graphs.

The expert FFN is one batched `torch.matmul` over (n, capacity, F) x
(n, F, H) (cuBLAS on the card; the JAX package leaves it to XLA), in
`matmul_dtype` with f32 accumulation; the bias is added in f32, then the
activation, then the cast to the compute dtype. Under mixed precision
the product is rounded to bf16 once before the bias (torch's bf16 GEMM
returns bf16), where XLA adds the bias to the f32 accumulator. Empty
slots compute act(bias) and are never combined; a dropped assignment
adds 0.

Router state (ExpertsOp `dropped`, `load`) and the cache's (`cached`,
`score`) are op buffers (core/op.py `Op.writes_state`): a training walk
and a walk handed `model.state` write them; eval and predict read them
and write none; the serving walks, handed only KV caches, neither read
nor write them.

On a mesh (JAX `ops/moe.py:9-12, 54-60`, the expert block under GSPMD):
capacity, and each assignment's position in its expert, come from the
global batch. Where a walk's inputs are cut over `data`, the ops gather
the tokens, the gate's weights and assignments (and the full gate) over
`data` first (runtime/collectives.py `gather_dim`, whose backward sums
the ranks' gradients of each rank's rows), so every slot is the
one-device slot; GroupBy's buffers are then whole on every rank, and
Aggregate's and ExpertsOp's outputs are cut back to the rank's rows. On
an `expert` axis of ep ranks the stacked kernel and bias are sharded on
dim 0 (FFModel._assign_strategy): each rank runs its n / ep experts on
their buffers, combines their share of every token's output, and the
shares are summed over the expert group (`reduce_sum`); the tokens and
gate weights enter through `enter_tp`, which sums their gradients over
the group. The load-balance loss, `dropped` and `load` are the global
ones, and every rank holds the same router state.
"""
from __future__ import annotations

import math
from typing import List

import torch

from ..core.op import Op, WeightSpec, register_op
from ..ffconst import ActiMode, DataType, OpType
from ..runtime.collectives import cut_dim, enter_tp, gather_dim, reduce_sum
from ..runtime.initializers import DefaultInitializer, ZeroInitializer
from .common import apply_activation, emit_dtype, matmul_dtype


def _data_cut(ctx, i: int = 0) -> bool:
    """Whether input i of the op being lowered is cut over `data`."""
    return (ctx.mesh is not None and len(ctx.in_cuts) > i
            and "data" in ctx.in_cuts[i])


def _whole(ctx, t: torch.Tensor, i: int) -> torch.Tensor:
    """Input i whole over `data` (gathered where it is cut)."""
    return gather_dim(t, ctx.mesh, "data", 0) if _data_cut(ctx, i) else t


def moe_capacity(batch: int, k: int, n: int, alpha: float) -> int:
    """Per-expert token capacity: ceil(alpha * k * batch / n), clamped to
    >= k (JAX `moe_capacity`: a capacity under k cannot hold one token's
    k assignments when the router concentrates)."""
    return max(int(k), int(math.ceil(alpha * k * batch / n)))


def moe_capacity_degenerate(batch: int, k: int, n: int,
                            alpha: float) -> bool:
    """True when the unclamped capacity rounds below k (the configuration
    the JAX package's FFTA080 warning names)."""
    return int(math.ceil(alpha * k * batch / n)) < int(k)


def moe_tokens(dims) -> int:
    """Token count of an ExpertsOp input: the product of the leading dims
    (rank 2: tokens; rank 3: batch x seq)."""
    t = 1
    for d in dims[:-1]:
        t *= int(d)
    return t


class DispatchPlan:
    """The dispatch of `assign` (T, k) expert ids into n buffers of
    `capacity` rows, as device index maps (T * k assignments, S = n *
    capacity slots):

    - slot (T, k) int64: the flat slot of assignment (t, j), S if dropped;
    - token (S,) int64: the token a slot holds, T if empty;
    - assignment (S,) int64: the flat assignment t * k + j a slot holds,
      T * k if empty;
    - onehot (n, T * k) int32 (expert-major: the running count is a scan
      along rows, which the card runs far faster than one down columns),
      and kept (T * k,) bool (not dropped)."""

    def __init__(self, assign: torch.Tensor, n: int, capacity: int):
        t, k = assign.shape
        flat = assign.reshape(-1).long()
        self.n, self.capacity = n, capacity
        self.onehot = (torch.arange(n, device=flat.device)[:, None]
                       == flat[None, :]).to(torch.int32)
        # position of each assignment within its expert, in token order
        pos = torch.cumsum(self.onehot, dim=1, dtype=torch.int32)
        pos = pos.gather(0, flat[None, :])[0].long() - 1
        self.kept = pos < capacity
        s = n * capacity
        sentinel = torch.full_like(pos, s)
        self.slot = torch.where(self.kept, flat * capacity + pos,
                                sentinel).view(t, k)
        # the inverse map: each real slot is written once; every dropped
        # assignment lands on the sentinel row S, which is cut off
        asg = torch.full((s + 1,), t * k, dtype=torch.long,
                         device=assign.device)
        asg.scatter_(0, self.slot.reshape(-1),
                     torch.arange(t * k, device=assign.device))
        self.assignment = asg[:s]
        self.token = torch.div(self.assignment, k, rounding_mode="floor")

    def dropped(self) -> torch.Tensor:
        """f32 count of the dropped assignments (0-d, on the device)."""
        return (~self.kept).sum().to(torch.float32)

    def load(self) -> torch.Tensor:
        """Each expert's share of the assignments, (n,) f32: the count
        times the f32 reciprocal of the assignments, as XLA lowers JAX's
        mean."""
        return self.onehot.sum(dim=1).to(torch.float32) * (
            1.0 / self.onehot.shape[1])


def _pad_row(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])


class _Dispatch(torch.autograd.Function):
    """x (T, F) -> buffers (S, F): slot s holds x[token(s)], zeros if
    empty. Backward: dx[t] = sum_j dbuf[slot(t, j)], in j order."""

    @staticmethod
    def forward(ctx, x, token, slot):
        ctx.save_for_backward(slot)
        return _pad_row(x)[token]

    @staticmethod
    def backward(ctx, dbuf):
        (slot,) = ctx.saved_tensors
        dpad = _pad_row(dbuf)
        dx = dpad[slot[:, 0]]
        for j in range(1, slot.shape[1]):
            dx = dx + dpad[slot[:, j]]
        return dx, None, None


class _Combine(torch.autograd.Function):
    """h (S, H), g (T, k) -> out (T, H) f32: out[t] = sum_j g(t, j) *
    h[slot(t, j)], in f32 and j order (a dropped assignment adds 0).
    Backward: dh[s] = g(assignment(s)) * dout[token(s)] (0 if empty), dg(t,
    j) = <dout[t], h[slot(t, j)]> (0 if dropped), in f32."""

    @staticmethod
    def forward(ctx, h, g, slot, token, assignment):
        ctx.save_for_backward(h, g, slot, token, assignment)
        hp = _pad_row(h)
        gf = g.float()
        out = gf[:, 0, None] * hp[slot[:, 0]].float()
        for j in range(1, slot.shape[1]):
            out = out + gf[:, j, None] * hp[slot[:, j]].float()
        return out

    @staticmethod
    def backward(ctx, dout):
        h, g, slot, token, assignment = ctx.saved_tensors
        dout = dout.float()
        gpad = _pad_row(g.float().reshape(-1))
        dh = gpad[assignment, None] * _pad_row(dout)[token]
        hp = _pad_row(h)
        dg = torch.stack([(dout * hp[slot[:, j]].float()).sum(-1)
                          for j in range(slot.shape[1])], dim=1)
        return dh.to(h.dtype), dg.to(g.dtype), None, None, None


def dispatch(x: torch.Tensor, plan: DispatchPlan) -> torch.Tensor:
    """(T, F) -> (n, capacity, F) buffers through `plan`."""
    buf = _Dispatch.apply(x, plan.token, plan.slot)
    return buf.view(plan.n, plan.capacity, x.shape[-1])


def combine(h: torch.Tensor, gate: torch.Tensor,
            plan: DispatchPlan) -> torch.Tensor:
    """(n, capacity, H) expert outputs and (T, k) gate weights -> (T, H)
    f32, the gate-weighted sum of each token's k assignments."""
    return _Combine.apply(h.reshape(-1, h.shape[-1]), gate, plan.slot,
                          plan.token, plan.assignment)


def load_balance_loss(full_gate: torch.Tensor, plan: DispatchPlan,
                      lambda_bal: float) -> torch.Tensor:
    """The Switch load-balance loss (JAX `_load_balance_loss`): lambda_bal
    x n x sum_e(importance_e x load_e), importance the mean gate
    probability of expert e, load its share of the assignments."""
    importance = full_gate.float().sum(dim=0) * (1.0 / full_gate.shape[0])
    return lambda_bal * plan.n * torch.sum(importance * plan.load())


@register_op
class GroupByOp(Op):
    """inputs: (features (B, F), assign (B, k)); outputs: n buffers (cap,
    F)."""

    op_type = OpType.GROUP_BY
    gathers_data = True

    def output_shapes(self):
        x, assign = self.inputs
        n = self.params["n"]
        cap = moe_capacity(x.dims[0], assign.dims[1], n,
                           self.params.get("alpha", 1.0))
        return [(cap, x.dims[1])] * n, [x.dtype] * n

    def lower(self, ctx, inputs):
        x, assign = (_whole(ctx, t, i) for i, t in enumerate(inputs))
        n = self.params["n"]
        cap = moe_capacity(x.shape[0], assign.shape[1], n,
                           self.params.get("alpha", 1.0))
        plan = DispatchPlan(assign, n, cap)
        return list(dispatch(x, plan).unbind(0))


@register_op
class AggregateOp(Op):
    """inputs: gate_preds (B, k), gate_assign (B, k), true_gate_assign
    (B, k), full_gate_grads (B, n), exp_preds[n] (cap, out_dim) -> output
    (B, out_dim), the reference's input signature; with lambda_bal the
    load-balance loss joins the walk's aux losses."""

    op_type = OpType.AGGREGATE

    def output_shapes(self):
        exp0 = self.inputs[4]
        return [(self.inputs[0].dims[0], exp0.dims[1])], [exp0.dtype]

    def lower(self, ctx, inputs):
        cut = _data_cut(ctx)
        inputs = [_whole(ctx, t, i) if i < 4 else t
                  for i, t in enumerate(inputs)]
        gate_preds, gate_assign = inputs[0], inputs[1]
        n = self.params["n"]
        exp_preds = inputs[4:4 + n]
        plan = DispatchPlan(gate_assign, n, exp_preds[0].shape[0])
        lambda_bal = self.params.get("lambda_bal", 0.0)
        if lambda_bal:
            ctx.aux_losses.append(
                load_balance_loss(inputs[3], plan, lambda_bal))
        out = combine(torch.stack(exp_preds), gate_preds, plan)
        out = out.to(exp_preds[0].dtype)
        return [cut_dim(out, ctx.mesh, "data", 0) if cut else out]


@register_op
class AggregateSpecOp(AggregateOp):
    """The speculative-expert variant (aggregate_spec.cc): the same
    dataflow, a distinct type as in the JAX package."""

    op_type = OpType.AGGREGATE_SPEC


@register_op
class ExpertsOp(Op):
    """The fused MoE expert block: dispatch -> batched per-expert FFN ->
    combine (see the module docstring).

    inputs: x (B, F) or (B, S, F), gate_preds (.., k) top-k gate weights,
    assign (.., k) expert ids, and optionally full_gate (.., n) for the
    load-balance loss. weights: kernel (n, F, H), bias (n, H). state:
    dropped () (capacity-overflow assignments, summed over walks) and
    load (n,) (the last walk's assignment shares)."""

    op_type = OpType.EXPERTS

    def _shape(self):
        x, _, assign = self.inputs[:3]
        n = self.params["n"]
        cap = moe_capacity(moe_tokens(x.dims), assign.dims[-1], n,
                           self.params.get("alpha", 1.0))
        return x, n, cap, self.params["out_dim"]

    def output_shapes(self):
        x, _, _, out_dim = self._shape()
        return [tuple(x.dims[:-1]) + (out_dim,)], [x.dtype]

    def weight_specs(self) -> List[WeightSpec]:
        x, n, _, out_dim = self._shape()
        f = x.dims[-1]
        init = self.params.get("kernel_initializer") or DefaultInitializer(
            fan_in=f, fan_out=out_dim)
        return [WeightSpec("kernel", (n, f, out_dim), x.dtype, init),
                WeightSpec("bias", (n, out_dim), x.dtype, ZeroInitializer())]

    def state_specs(self) -> List[WeightSpec]:
        return [WeightSpec("dropped", (), DataType.DT_FLOAT,
                           ZeroInitializer()),
                WeightSpec("load", (self.params["n"],), DataType.DT_FLOAT,
                           ZeroInitializer())]

    def lower(self, ctx, inputs):
        cut = _data_cut(ctx)
        inputs = [_whole(ctx, t, i) for i, t in enumerate(inputs)]
        x, gate_preds, assign = inputs[:3]
        n = self.params["n"]
        lead = x.shape[:-1]
        x = x.reshape(-1, x.shape[-1])
        gate_preds = gate_preds.reshape(-1, gate_preds.shape[-1])
        assign = assign.reshape(-1, assign.shape[-1])
        cap = moe_capacity(x.shape[0], assign.shape[1], n,
                           self.params.get("alpha", 1.0))
        plan = DispatchPlan(assign, n, cap)
        lambda_bal = self.params.get("lambda_bal", 0.0)
        if lambda_bal:
            if len(inputs) <= 3:
                raise ValueError(
                    f"experts op {self.name}: lambda_bal={lambda_bal} needs "
                    "the full gate distribution (pass full_gate=)")
            full_gate = inputs[3].reshape(-1, inputs[3].shape[-1])
            ctx.aux_losses.append(
                load_balance_loss(full_gate, plan, lambda_bal))
        if self.writes_state(ctx):
            with torch.no_grad():
                self.dropped.add_(plan.dropped())
                self.load.copy_(plan.load())
        cdt = matmul_dtype(ctx.config, torch.float32)
        local = self._parameters["kernel"].shape[0]
        group = ctx.mesh.group("expert") if local < n else None
        if group is not None:  # this rank's experts (the module docstring)
            x, gate_preds = enter_tp(x, group), enter_tp(gate_preds, group)
        buf = dispatch(x.to(cdt), plan)
        if group is not None:
            first = ctx.mesh.index("expert") * local
            buf = buf[first:first + local]
        h = torch.matmul(buf, self.w("kernel", cdt)).float() \
            + self.w("bias", torch.float32)[:, None, :]
        h = apply_activation(h, self.params.get(
            "activation", ActiMode.AC_MODE_RELU)).to(cdt)
        if group is not None:  # the other experts' slots combine to 0
            h = torch.cat([h.new_zeros((first,) + h.shape[1:]), h,
                           h.new_zeros((n - first - local,) + h.shape[1:])])
        out = combine(h, gate_preds.to(cdt), plan)
        if group is not None:
            out = reduce_sum(out, group)
        out = out.to(emit_dtype(ctx.config, self.outputs[0].dtype))
        out = out.view(*lead, out.shape[-1])
        return [cut_dim(out, ctx.mesh, "data", 0) if cut else out]

    def ffn_flops(self) -> float:
        """The forward FLOPs the port performs: the batched expert FFN
        (dispatch and combine are gathers)."""
        x, n, cap, out_dim = self._shape()
        return 2.0 * n * cap * x.dims[-1] * out_dim

    def flops(self) -> float:
        """JAX `ExpertsOp.flops`: the one-hot dispatch and combine
        contractions the JAX package runs, and the FFN (the cost model and
        the strategy search price it)."""
        x, n, cap, out_dim = self._shape()
        t = moe_tokens(x.dims) * self.inputs[2].dims[-1]
        f = x.dims[-1]
        return (2.0 * t * n * cap * f + 2.0 * n * cap * f * out_dim
                + 2.0 * t * n * cap * out_dim)


@register_op
class CacheOp(Op):
    """A cached tensor with a staleness score (reference cache.cc): the
    last seen input in `cached`, and `score`, the mean L1 divergence of
    the input from it, which `FFModel.get_cache_score` and the recompile
    trigger read. With params["use_cached"] the op serves the cached
    tensor (as it was before this walk) instead of its input."""

    op_type = OpType.CACHE

    def output_shapes(self):
        return [self.inputs[0].dims], [self.inputs[0].dtype]

    def state_specs(self) -> List[WeightSpec]:
        return [WeightSpec("cached", self.inputs[0].dims,
                           self.inputs[0].dtype, ZeroInitializer()),
                WeightSpec("score", (), DataType.DT_FLOAT,
                           ZeroInitializer())]

    def lower(self, ctx, inputs):
        x = inputs[0]
        if ctx.state and self.name not in ctx.state:
            # a serving walk, handed only KV caches: no cache state (JAX)
            return [x]
        cached = self.cached
        out = x
        if self.params.get("use_cached", False):
            out = cached.clone().to(x.dtype)
        if self.writes_state(ctx):
            with torch.no_grad():
                self.score.copy_(torch.mean(torch.abs(
                    x.float() - cached.float())))
                cached.copy_(x)
        return [out]
