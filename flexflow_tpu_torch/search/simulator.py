"""Cost simulator: per-op costs and whole-graph strategy cost
(counterpart of flexflow_tpu/search/simulator.py: everything but
resharding, which is ROADMAP A8).

Reference: src/runtime/simulator.{cc,cu} — per-op cost comes from *measuring*
real kernels (measure_operator_cost, simulator.cc:489; cudaEvent timing
model.cu:38-75, cached by op-params hash simulator.h:750-752); transfer cost
is bytes/bandwidth along the machine model's comm path; full-graph
simulate_runtime (simulator.cc:815+) builds a fwd/bwd/update task graph with
comm tasks on region intersections and runs an event-driven simulation.

As in the JAX package:
- Per-op cost: analytic roofline from the machine model by default (flops
  vs memory bytes), or *measured* (OpCostCache): the op's own lowering run
  eagerly on its device at the sharded local shapes, timed with CUDA
  events on the card, cached by cost key.
- Transfer cost: reshard collectives between producer/consumer shardings
  (all_gather / all_to_all / slice), priced by the machine model.
- Whole-graph cost: one program a step, so the graph cost is the event-
  driven schedule of per-op fwd+bwd on one compute stream and the
  collectives on per-axis comm streams, with the gradient syncs overlapping
  the backward (config.search_overlap_backward_update).

TP_CAPABLE (the ops whose weights can shard over the `model` mesh axis)
and TP_WEIGHT_SHARD_DIMS (per op type, the weight dim each shards on) are
read by FFModel._assign_tp_weights to shard the weights, and the ops read
the same shards in their lowering; OpCostCache measures with the same
maps.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import logging
import time
from typing import Any, Dict, List, Optional, Tuple

from ..core.graph import Graph
from ..core.op import Op
from ..ffconst import OpType
from .machine_model import MachineModel

_log = logging.getLogger("flexflow_tpu_torch.search")


@dataclasses.dataclass(frozen=True)
class OpStrategy:
    """Parallelization of one op: batch-dim degree (dp), channel/heads degree
    (tp), expert degree (ep, EXPERTS ops only), and attribute/spatial degree
    (ap: conv/pool H sharding, reference create_mapping_xfers<Conv2D/Pool2D>,
    substitution.cc:1795-1797). The reference expresses the same thing as a
    MachineView + per-dim degrees on the op's ParallelTensors."""

    dp: int = 1
    tp: int = 1
    ep: int = 1
    ap: int = 1
    # sequence/context parallelism (NEW vs the reference, which has no SP —
    # SURVEY §5): the activations' position dim shards over a 'seq' mesh
    # axis; attention runs the ring kernel whose K/V rotation the cost
    # model prices (sp_collective_time_us). Uniform across the graph per
    # factorization — per-op sp flips would reshard at every edge.
    sp: int = 1
    # reduction/"parameter" parallelism (LINEAR only): the kernel shards on
    # the INPUT-feature dim; the output is a partial sum all-reduced by
    # GSPMD — the Megatron row-parallel half, paired with a column-parallel
    # producer whose sharded output it consumes for free (reference:
    # --enable-parameter-parallel + ReductionOp, src/parallel_ops/reduction.cc)
    tp_row: bool = False

    @property
    def degree(self) -> int:
        return self.dp * self.tp * self.ep * self.ap * self.sp



# ops whose weights/channels can shard over the model axis (reference:
# substitution generators partition_linear/attention/embedding,
# substitution.cc:1755-1770)
TP_CAPABLE = {
    OpType.LINEAR,
    OpType.MULTIHEAD_ATTENTION,
    OpType.EMBEDDING,
    OpType.BATCHMATMUL,
}

# ops whose spatial (H) dim can shard over the 'attr' mesh axis — GSPMD
# inserts the halo exchanges (reference: attribute parallelism via
# create_mapping_xfers<Conv2D/Pool2D/Flat>, substitution.cc:1795-1797,
# gated by --enable-attribute-parallel, config.h:136)
AP_CAPABLE = {
    OpType.CONV2D,
    OpType.POOL2D,
}

# weight dims that shard over 'model' per op type — the single source of
# truth used both to ASSIGN tp shardings (FFModel._assign_tp_weights) and to
# MEASURE tp-sharded op costs (OpCostCache), so measured shapes always match
# executed shapes
TP_WEIGHT_SHARD_DIMS = {
    OpType.LINEAR: {"kernel": -1, "bias": 0},
    OpType.EMBEDDING: {"weight": -1},
    OpType.MULTIHEAD_ATTENTION: {
        "wq": 1, "wk": 1, "wv": 1, "wo": 0,
        "bq": 0, "bk": 0, "bv": 0,
    },
}

_MEMORY_BOUND_BWD_FACTOR = 2.0  # bwd ≈ 2x fwd cost (two grad GEMMs per GEMM)


# ops that DEFINE an NCHW output layout (dim 1 = channels)
_SPATIAL_LAYOUT = AP_CAPABLE | {OpType.BATCHNORM, OpType.FLAT}
# ops that DEFINE a token layout (dim 1 = position) or re-lay-out their
# input, breaking NCHW propagation (reshape/transpose are how a vision
# graph turns NCHW activations into (B, L, D) tokens)
_LAYOUT_SOURCES = {
    OpType.MULTIHEAD_ATTENTION, OpType.LINEAR, OpType.EMBEDDING,
    OpType.RESHAPE, OpType.TRANSPOSE,
}


def _dim1_is_channel(op: Op) -> bool:
    """True when op's 4D output is NCHW-laid-out (dim 1 = channels, not a
    position dim): it is a spatial op, a raw 4D graph input (images), or a
    layout-preserving op (elementwise/dropout/concat/...) inheriting NCHW
    from a 4D producer. Memoized on the op (layout never changes)."""
    cached = getattr(op, "_dim1_channel", None)
    if cached is not None:
        return cached
    t = op.outputs[0]
    if len(t.dims) != 4:
        r = False
    elif op.op_type in _SPATIAL_LAYOUT:
        r = True
    elif op.op_type in (OpType.INPUT, OpType.WEIGHT):
        r = True  # raw 4D sources are NCHW images in this framework
    elif op.op_type in _LAYOUT_SOURCES:
        r = False
    else:
        r = any(
            t_in.owner_op is not None and len(t_in.dims) == 4
            and _dim1_is_channel(t_in.owner_op)
            for t_in in op.inputs)
    op._dim1_channel = r
    return r


def sp_capability(op: Op) -> bool:
    """The sp-independent half of sp_shardable: dim 1 is a genuine position
    dim (ndim >= 3, size > 1, not EXPERTS, not an NCHW channel dim). Shared
    with the native core's graph serialization (native/__init__.py) so both
    cost models stay in lockstep."""
    if not op.outputs or op.op_type == OpType.EXPERTS:
        return False
    t = op.outputs[0]
    if len(t.dims) < 3 or t.dims[1] <= 1:
        return False
    return not _dim1_is_channel(op)


def attn_kv_bytes(op: Op, dtype_bytes: int) -> float:
    """Full (undivided) K+V bytes an attention op would rotate under ring
    SP: 2 * B * L_k * heads * kdim * dtype_bytes. 0 for non-attention.
    The per-chip block is this / (dp * sp). Shared with the native core."""
    if (op.op_type != OpType.MULTIHEAD_ATTENTION or not op.inputs
            or len(op.inputs[0].dims) < 3):
        return 0.0
    k_in = op.inputs[1] if len(op.inputs) > 1 else op.inputs[0]
    heads = op.params.get("num_heads", 1)
    kdim = op.params.get("kdim") or op.params["embed_dim"] // heads
    return 2.0 * k_in.dims[0] * k_in.dims[1] * heads * kdim * dtype_bytes


def attn_q_bytes(op: Op, dtype_bytes: int) -> float:
    """One q (or out) tensor's full bytes under Ulysses SP:
    B * L_q * heads * kdim * dtype_bytes. L_q != L_kv for cross-attention.
    Shared with the native core."""
    if (op.op_type != OpType.MULTIHEAD_ATTENTION or not op.inputs
            or len(op.inputs[0].dims) < 3):
        return 0.0
    q_in = op.inputs[0]
    heads = op.params.get("num_heads", 1)
    kdim = op.params.get("kdim") or op.params["embed_dim"] // heads
    return float(q_in.dims[0] * q_in.dims[1] * heads * kdim * dtype_bytes)


def attn_sp_ulysses(op: Op) -> bool:
    """True when the attention op requests the all_to_all (Ulysses) SP
    kernel rather than the ring. Shared with the native core's node
    serialization so the two cost models cannot drift."""
    return (op.op_type == OpType.MULTIHEAD_ATTENTION
            and op.params.get("sequence_parallel_mode") in ("ulysses",
                                                            "all_to_all"))


def ap_halo_elems(op: Op) -> float:
    """Full (undivided) ELEMENT count of one spatial-sharding halo
    exchange: b * c * max(0, kernel_h - stride_h) * w over the NCHW input.
    0 when the op has no 4D input or no kernel overlap (1x1 convs,
    non-overlapping pools). Shared with the native core's serialization so
    the two cost models cannot drift."""
    if not op.inputs or len(op.inputs[0].dims) != 4:
        return 0.0
    kh = op.params.get("kernel_h", 1)
    stride = max(1, op.params.get("stride_h", 1))
    halo_rows = max(0, kh - stride)
    if halo_rows == 0:
        return 0.0
    b, c, _, w = op.inputs[0].dims
    return float(b) * c * halo_rows * w


def sp_shardable(op: Op, sp: int) -> bool:
    """Sequence sharding applies to ops whose output carries a position dim
    at index 1 (ndim >= 3, dim 1 divisible). EXPERTS excluded: its
    expert-axis shard_map owns the token layout; NCHW-layout outputs
    excluded (layout propagated from producers): their dim 1 is channels —
    GSPMD would stay correct, but the cost model would wrongly divide their
    time by sp and the annotation would shard channels over 'seq' in hybrid
    attention+conv graphs."""
    if sp <= 1 or not sp_capability(op):
        return False
    return op.outputs[0].dims[1] % sp == 0


def plan_sync_buckets(items: List[Tuple[Op, "OpStrategy", Tuple, float]],
                      bucket_bytes: float) -> List[Dict[str, Any]]:
    """Greedy size-targeted bucketing of grad-sync tensors in issue
    order (docs/machine.md "Overlap"): tensors share a bucket only when
    their sync `key` (degree, inner stride, comm channels) matches; a
    bucket closes once it reaches `bucket_bytes` (a single tensor larger
    than the target gets a bucket of its own). Returns
    [{key, ops: [(op, strategy)], bytes}] in issue order — bucket ids
    are list positions. Deterministic and timing-free, so the simulator,
    the reduction plan, and the runtime lowering derive the SAME
    schedule from the same items."""
    buckets: List[Dict[str, Any]] = []
    pending: Dict[Tuple, Dict[str, Any]] = {}
    for op, s, key, bytes_ in items:
        cur = pending.get(key)
        if cur is None:
            cur = pending[key] = {"key": key, "ops": [], "bytes": 0.0}
            buckets.append(cur)
        cur["ops"].append((op, s))
        cur["bytes"] += bytes_
        if cur["bytes"] >= bucket_bytes:
            del pending[key]  # full: the next same-key tensor opens anew
    return buckets


class CostModel:
    """Analytic per-op + per-edge costs under a strategy."""

    def op_dtype_bytes(self, op: Op) -> int:
        if self.config is not None and self.config.allow_mixed_precision:
            return 2
        if op.outputs:
            return op.outputs[0].dtype.itemsize
        return 4

    def forward_time_us(self, op: Op, s: OpStrategy) -> float:
        if op.op_type in (OpType.INPUT, OpType.NOOP, OpType.WEIGHT):
            return 0.0
        shards = s.dp * (s.tp if op.op_type in TP_CAPABLE else 1)
        if op.op_type == OpType.EXPERTS:
            shards *= s.ep
        if op.op_type in AP_CAPABLE:
            shards *= s.ap
        if sp_shardable(op, s.sp):
            # position-wise compute divides by sp; the attention core's
            # L x L work also divides (each chip attends its L/sp queries
            # against the full rotated K/V)
            shards *= s.sp
        flops = op.flops() / max(1, shards)
        bytes_ = op.bytes_accessed() / max(1, shards)
        t = self.machine.compute_time_us(flops, bytes_,
                                         self.op_dtype_bytes(op))
        return t * self.kernel_time_factor(op, s)

    def kernel_time_factor(self, op: Op, s: OpStrategy) -> float:
        """Fused-kernel tier pricing (docs/kernels.md): ops whose family
        the KernelRegistry would select pallas for cost PALLAS_COST_GAIN
        of their roofline estimate, so the Unity search ranks strategies
        against the kernels the lowering will actually emit. The
        structural gates mirror the lowerings exactly — a norm/softmax
        the op would NOT fuse (non-trailing axes) is never discounted.
        1.0 for reference selections and non-tier ops — on CPU
        (reference everywhere by default) this is an exact no-op."""
        from ..kernels.registry import (KERNELS, OPTYPE_FAMILY,
                                        flash_crossover)

        family = OPTYPE_FAMILY.get(op.op_type)
        if family is None:
            return 1.0
        # memoized per selection-relevant key: the registry resolves the
        # fitted profile's residuals per call (an os.stat for freshness),
        # and this sits on the search's per-op-per-strategy hot path.
        # Assumes selection policy is stable for this CostModel's
        # lifetime — construct a fresh Simulator after changing the
        # config knob or entering a KERNELS.override
        memo = getattr(self, "_kernel_factor_memo", None)
        if memo is None:
            memo = self._kernel_factor_memo = {}
        nd = len(op.inputs[0].dims) if op.inputs else 0
        if family in ("layernorm", "rmsnorm", "softmax"):
            if family == "softmax":
                # ops/norm.py gates: fused only on the trailing axis
                if op.params.get("axis", -1) not in (-1, nd - 1):
                    return 1.0
            elif tuple(op.params.get("axes", ())) != (nd - 1,):
                return 1.0
            hit = memo.get(family)
            if hit is None:
                hit = memo[family] = KERNELS.cost_factor(
                    family, config=self.config)
            return hit

        # the lowering's structural flash gates (ops/attention.py):
        # attention-prob dropout, kdim != vdim, and the sequence-parallel
        # ring all keep the einsum core regardless of selection
        heads = op.params.get("num_heads", 1)
        kdim = op.params.get("kdim") or op.params.get("embed_dim", 0) // heads
        vdim = op.params.get("vdim") or op.params.get("embed_dim", 0) // heads
        if (op.params.get("dropout", 0.0) > 0 or kdim != vdim
                or (op.params.get("sequence_parallel") and s.sp > 1)):
            return 1.0

        # the attention lowering's measured score-bytes policy (the
        # SHARED registry helper) at this STRATEGY's data-parallel
        # degree (ops/attention.py _use_flash consults the live mesh;
        # costing has s.dp)
        q, k = op.inputs[0], op.inputs[1]
        param = op.params.get("use_flash")
        key = ("attention", param,
               flash_crossover(q.dims[0], op.params["num_heads"],
                               q.dims[1], k.dims[1], s.dp))
        hit = memo.get(key)
        if hit is None:
            hit = memo[key] = KERNELS.cost_factor(
                "attention", param=param, config=self.config,
                heuristic=lambda: key[2])
        return hit

    def decode_step_time_us(self, op: Op, batch: int, cache_len: int,
                            c_queries: int = 1) -> float:
        """Price ONE continuous-batching decode dispatch of attention op
        `op`: `c_queries` query tokens per slot against a `cache_len`-row
        paged KV cache — the serving hot path, which never appears as a
        graph op so `forward_time_us` cannot see it. Kernel-tier priced
        like the rest of the Pallas tier: the registry's selection for
        `attention_decode` (C = 1) / `attention_decode_mq` (C > 1,
        chunked prefill and the speculative verify) multiplies the
        roofline by PALLAS_COST_GAIN, so serving-rate predictions
        (serve-bench's predicted speculative win, fleet sizing) rank
        against the kernels the batcher will actually dispatch."""
        from ..kernels.registry import KERNELS

        heads = op.params.get("num_heads", 1)
        embed = op.params.get("embed_dim", op.inputs[0].dims[-1])
        kdim = op.params.get("kdim") or embed // heads
        vdim = op.params.get("vdim") or embed // heads
        b = max(1, int(batch))
        m = max(1, int(cache_len))
        c = max(1, int(c_queries))
        e = op.inputs[0].dims[-1]
        # q/k/v/out projections of the C new tokens + the attention core
        # streaming the cache
        proj = 2.0 * b * c * heads * (2 * e * kdim + e * vdim
                                      + vdim * embed)
        core = 2.0 * b * c * heads * m * (kdim + vdim)
        dt_bytes = self.op_dtype_bytes(op)
        # HBM traffic is the cache stream (the decode bottleneck); the
        # reference path additionally round-trips the (b, h, c, m)
        # logits+probs, which is exactly what the fused kernels save —
        # modeled by the family's PALLAS_COST_GAIN, not double-counted
        bytes_ = float(b) * m * heads * (kdim + vdim) * dt_bytes
        t = self.machine.compute_time_us(proj + core, bytes_, dt_bytes)
        fam = "attention_decode_mq" if c > 1 else "attention_decode"
        return t * KERNELS.cost_factor(fam, config=self.config)

    def backward_time_us(self, op: Op, s: OpStrategy) -> float:
        if op.op_type in (OpType.INPUT, OpType.NOOP, OpType.WEIGHT):
            return 0.0
        return _MEMORY_BOUND_BWD_FACTOR * self.forward_time_us(op, s)

    # -- tier-aware collective plumbing -----------------------------------
    # Mesh axes are row-major (core/machine.make_mesh reshapes the device
    # list over mesh_axes_for's order: data, model, expert, attr, seq), so
    # the LAST axis varies fastest: seq is innermost, then attr, expert,
    # model, and data outermost. `_axis_inner` is the device stride of an
    # axis — what a hierarchical machine needs to know which tiers the
    # axis's collectives actually cross (a tp group stays inside the pod
    # while the dp group, nested outside everything, spans the DCN).
    #
    # The stride comes from the MESH degrees, not the op's own strategy:
    # an op replicated over the model axis (tp=1 on a tp=2 mesh) still
    # has its dp groups strided across it — its "in-pod" sync really
    # spans both pods. `set_mesh_context`/`set_mesh_degrees` install the
    # realized mesh before pricing; (1, 1, 1, 1) — the flat default —
    # reproduces op-local nesting.
    def set_mesh_degrees(self, tp: int = 1, sp: int = 1, ep: int = 1,
                         ap: int = 1) -> None:
        """Install a candidate factorization's (tp, sp, ep, ap) as the
        mesh context (the Unity search calls this per candidate; only
        tiered machines price with it)."""
        if self.tiered:
            self._mesh_ctx = (max(1, tp), max(1, sp), max(1, ep),
                              max(1, ap))

    def set_mesh_context(self, strategies: Dict[int, "OpStrategy"]) -> None:
        """Derive the realized mesh degrees from a strategy dict (an axis
        exists at the largest degree any op shards over it — the same
        convention as unity.mesh_axes_for)."""
        if not self.tiered:
            return
        tp_m = sp_m = ep_m = ap_m = 1
        for s in strategies.values():
            tp_m = max(tp_m, s.tp)
            sp_m = max(sp_m, s.sp)
            ep_m = max(ep_m, s.ep)
            ap_m = max(ap_m, s.ap)
        self._mesh_ctx = (tp_m, sp_m, ep_m, ap_m)

    def _axis_inner(self, s: OpStrategy, axis: str) -> int:
        tp_m, sp_m, ep_m, ap_m = self._mesh_ctx
        if axis == "sp":
            return 1
        if axis == "ap":
            return sp_m
        if axis == "ep":
            return sp_m * ap_m
        if axis == "tp":
            return sp_m * ap_m * ep_m
        return tp_m * sp_m * ep_m * ap_m  # dp, the outermost axis

    def _sync_inner(self, op: Op, s: OpStrategy) -> int:
        """Device stride of the gradient-sync group (dp, plus ap when
        this op actually shards spatially — when ap is NOT part of the
        group, including a spatial-capable op that could not shard
        (s.ap == 1) on an ap mesh, the attr axis sits inside the dp
        stride like every other inner axis)."""
        tp_m, sp_m, ep_m, ap_m = self._mesh_ctx
        inner = tp_m * sp_m * ep_m
        if not (op.op_type in AP_CAPABLE and s.ap > 1):
            inner *= ap_m
        return max(1, inner)

    def _allreduce_us(self, bytes_: float, n: int, inner: int,
                      strategy: str = "auto") -> float:
        if self.tiered:
            return self.machine.allreduce_time_us(bytes_, n, inner=inner,
                                                  strategy=strategy)
        return self.machine.allreduce_time_us(bytes_, n)

    def _allgather_us(self, bytes_per_shard: float, n: int,
                      inner: int) -> float:
        if self.tiered:
            return self.machine.allgather_time_us(bytes_per_shard, n,
                                                  inner=inner)
        return self.machine.allgather_time_us(bytes_per_shard, n)

    def _reduce_scatter_us(self, bytes_: float, n: int, inner: int) -> float:
        if self.tiered:
            return self.machine.reduce_scatter_time_us(bytes_, n,
                                                       inner=inner)
        return self.machine.reduce_scatter_time_us(bytes_, n)

    def _all_to_all_us(self, bytes_: float, n: int, inner: int) -> float:
        if self.tiered:
            return self.machine.all_to_all_time_us(bytes_, n, inner=inner)
        return self.machine.all_to_all_time_us(bytes_, n)

    def _ring_hop_us(self, bytes_: float, n: int, inner: int) -> float:
        """One simultaneous neighbor hop of a ring over an n-wide axis
        (ring-SP rotation, ap halos): on tiered machines the rotation
        advances at the slowest link the ring crosses — a cross-pod ring
        pays the DCN hop, not the innermost-tier neighbor price."""
        if self.tiered:
            return self.machine.ring_hop_time_us(bytes_, n, inner=inner)
        return self.machine.p2p_single_path_time_us(bytes_)

    def tp_collective_time_us(self, op: Op, s: OpStrategy) -> float:
        """Extra collective a TP op needs per step: a row-parallel linear
        all-reduces its partial-sum output; a column-parallel op's gather is
        edge-dependent (tp_boundary_time_us) and not charged here."""
        if s.tp <= 1 or op.op_type not in TP_CAPABLE or not op.outputs:
            return 0.0
        out = op.outputs[0]
        inner = self._axis_inner(s, "tp")
        bytes_ = out.num_elements() * self.op_dtype_bytes(op) / max(1, s.dp)
        if s.tp_row:
            # the Megatron pair costs TWO allreduces per step: fwd partial
            # sums here, plus the bwd allreduce at the pair entry (the
            # column partner's input gradient — same bytes for the
            # canonical d->4d->d pairing); simulate() charges half in each
            # pass
            return 2.0 * self._allreduce_us(bytes_, s.tp, inner)
        # fwd allgather + bwd reduce_scatter of the same bytes
        return self._allgather_us(bytes_ / s.tp, s.tp, inner) + \
            self._reduce_scatter_us(bytes_, s.tp, inner)

    def ap_halo_time_us(self, op: Op, s: OpStrategy) -> float:
        """Halo exchange cost of spatial (H) sharding: each chip swaps the
        kernel-overlap boundary rows with its neighbors per step (GSPMD
        emits collective-permutes for the sharded conv). kernel_h == stride_h
        (1x1 convs, non-overlapping pools) needs no halo and costs none."""
        if s.ap <= 1 or op.op_type not in AP_CAPABLE:
            return 0.0
        elems = ap_halo_elems(op)
        if elems <= 0:
            return 0.0
        halo_bytes = elems * self.op_dtype_bytes(op) / max(1, s.dp)
        # exchanged once fwd + mirrored bwd; neighbors along the attr
        # axis — on tiered machines the exchange pays the slowest tier
        # the axis crosses
        if self.tiered:
            return 2.0 * self.machine.ring_hop_time_us(
                halo_bytes, s.ap, inner=self._axis_inner(s, "ap"))
        return 2.0 * self.machine.p2p_time_us(halo_bytes)

    def sp_collective_time_us(self, op: Op, s: OpStrategy) -> float:
        """Sequence-parallel comm cost, MODE-AWARE:

        - ring (default): (sp-1) neighbor ppermutes of the local K and V
          blocks, forward, plus the mirrored rotation of their gradients in
          backward (the ring scan reverses).
        - ulysses/all_to_all: q/k/v all_to_all from seq- to head-sharding,
          exact local attention, output all_to_all back — 4 tensor blocks
          forward, mirrored in backward. Less traffic than the ring from
          sp>=2 (8/sp tensor-blocks vs 2(sp-1) K+V blocks), which is why
          the kernel exists; the head-divisibility gate lives in
          make_sp_feasible.

        Non-attention ops pay nothing — GSPMD keeps their position-sharded
        activations local."""
        if s.sp <= 1:
            return 0.0
        base = attn_kv_bytes(op, self.op_dtype_bytes(op))
        if base <= 0:
            return 0.0
        if attn_sp_ulysses(op):
            # q and out blocks carry L_q, k and v blocks L_kv — distinct
            # under cross-attention (base counts K+V, so base/2 per tensor)
            denom = max(1, s.dp) * s.sp
            q_tok = attn_q_bytes(op, self.op_dtype_bytes(op)) / denom
            kv_tok = (base / 2.0) / denom
            sp_inner = self._axis_inner(s, "sp")
            return 2.0 * 2.0 * (
                self._all_to_all_us(q_tok, s.sp, sp_inner)
                + self._all_to_all_us(kv_tok, s.sp, sp_inner))
        kv_bytes = base / (max(1, s.dp) * s.sp)
        # fwd rotation + mirrored bwd rotation of dK/dV; single-path: all
        # chips rotate the SAME direction, so ECMP cannot split the hop —
        # and each rotation step advances at the slowest link the seq
        # ring crosses (tiered machines: a cross-pod ring pays the DCN)
        return 2.0 * (s.sp - 1) * self._ring_hop_us(
            kv_bytes, s.sp, self._axis_inner(s, "sp"))

    def ep_collective_time_us(self, op: Op, s: OpStrategy) -> float:
        """Token routing cost of expert parallelism: all_to_all of the
        dispatched capacity buffers to resident experts and back (fwd), and
        the mirrored pair in bwd."""
        if s.ep <= 1 or op.op_type != OpType.EXPERTS:
            return 0.0
        x = op.inputs[0]
        from ..ops.moe import moe_capacity, moe_tokens

        n = op.params["n"]
        cap = moe_capacity(moe_tokens(x.dims), op.inputs[2].dims[-1], n,
                           op.params.get("alpha", 1.0))
        # per-chip share of the capacity buffers (each chip holds n/ep
        # experts' buffers for its dp slice of the batch): dispatch moves
        # (n, cap, F) features in, combine moves (n, cap, out_dim) out
        shard = max(1, s.dp * s.ep)
        db = self.op_dtype_bytes(op)
        disp_bytes = n * cap * x.dims[-1] * db / shard
        comb_bytes = n * cap * op.params["out_dim"] * db / shard
        ep_inner = self._axis_inner(s, "ep")
        # each direction fwd + mirrored bwd
        return 2.0 * (self._all_to_all_us(disp_bytes, s.ep, ep_inner)
                      + self._all_to_all_us(comb_bytes, s.ep, ep_inner))

    def xfer_time_us(self, tensor_bytes: float, src: OpStrategy, dst: OpStrategy) -> float:
        """Reshard cost on an edge when producer/consumer batch degrees differ
        (reference: parallel-op region copies priced by get_comm_path)."""
        if src.dp == dst.dp:
            return 0.0
        n = max(src.dp, dst.dp)
        if dst.dp > src.dp:
            return 0.0  # replicated/coarse -> finer: local slice
        # finer -> coarser: all_gather of the missing shards (the producer's
        # layout fixes which tiers the dp group crosses)
        return self._allgather_us(tensor_bytes / n, n,
                                  self._axis_inner(src, "dp"))

    def tp_boundary_time_us(self, tensor_bytes: float, src_op: Op,
                            src: OpStrategy, dst: OpStrategy,
                            backward: bool = False) -> float:
        """TP reshard on an edge. A column-parallel producer's output is
        sharded over 'model': a row-parallel consumer at the SAME degree
        consumes it sharded for free (the Megatron column->row pairing);
        any other consumer needs the allgather in fwd and the mirrored
        gradient reduce_scatter in bwd (charged by the pass that incurs
        it). A row-parallel producer's output is already replicated after
        its all-reduce (tp_collective_time_us), so its edges are free."""
        if src_op.op_type not in TP_CAPABLE or src.tp <= 1 or src.tp_row:
            return 0.0
        if dst.tp == src.tp and dst.tp_row:
            return 0.0  # paired column->row: stays sharded
        tp_inner = self._axis_inner(src, "tp")
        if backward:
            return self._reduce_scatter_us(
                tensor_bytes / max(1, src.dp), src.tp, tp_inner)
        shard = tensor_bytes / max(1, src.dp * src.tp)
        return self._allgather_us(shard, src.tp, tp_inner)

    def grad_sync_time_us(self, op: Op, s: OpStrategy) -> float:
        """Weight-gradient allreduce over the data axis (reference: NCCL
        allreduce inside the optimizer update task, optimizer_kernel.cu:88).
        Memoized — queried once per op per simulate call."""
        # weights are replicated across attr shards too: their grads
        # all-reduce over the dp x ap group
        sync = s.dp * (s.ap if op.op_type in AP_CAPABLE else 1)
        if sync <= 1 or not op.weights:
            return 0.0
        memo = getattr(self, "_grad_sync_memo", None)
        if memo is None:
            memo = self._grad_sync_memo = {}
        # mesh context and reduction mode are part of the identity on
        # tiered machines: the SAME op strategy prices differently under
        # different candidate factorizations (its sync group strides
        # across their inner axes) and under auto-vs-flat repricing
        key = (op.guid, s, self._mesh_ctx, self.reduction_mode)
        hit = memo.get(key)
        if hit is not None:
            return hit
        out = self._grad_sync_uncached(op, s, sync)
        memo[key] = out
        return out

    def _grad_sync_bytes(self, op: Op, s: OpStrategy) -> float:
        wshard = s.ep if op.op_type == OpType.EXPERTS else s.tp
        return sum(
            w.num_elements() * w.dtype.itemsize for w in op.weights
        ) / max(1, wshard)

    def _grad_sync_uncached(self, op: Op, s: OpStrategy,
                            sync: int) -> float:
        wb = self._grad_sync_bytes(op, s)
        if self.tiered:
            # the sync group spans the dp (x ap) axes — every MESH axis
            # nested inside them is its device stride, which fixes the
            # tiers the reduction crosses. "auto" synthesizes the
            # cheapest tier-decomposable strategy per tensor
            # (reduction_plan exports the choices); "flat" reprices a
            # plan searched under a flat machine model.
            return self.machine.allreduce_time_us(
                wb, sync, inner=self._sync_inner(op, s),
                strategy=self.reduction_mode)
        return self.machine.allreduce_time_us(wb, sync)

    # -- bucketed/async gradient reduction (docs/machine.md "Overlap") ----
    def bucket_target(self) -> float:
        """Byte target of grad-sync bucketing, or 0 when pricing stays
        per-tensor. Bucketing is active only where it is executed and
        where it cannot disturb pinned pricing parities: a MULTI-tier
        hierarchical machine (one-tier hierarchies price bit-for-bit
        like the flat models, and the flat models must keep agreeing
        with the native core), auto reduction synthesis (a flat-repriced
        plan carries no bucket schedule), and
        search_overlap_backward_update on (False = the legacy blocking
        pricing, bit-identical to the pre-bucketing overlap=False
        path)."""
        if not self.tiered or len(getattr(self.machine, "tiers", ())) <= 1:
            return 0.0
        if self.reduction_mode != "auto":
            return 0.0
        cfg = self.config
        if cfg is None or not getattr(cfg, "search_overlap_backward_update",
                                      True):
            return 0.0
        return float(getattr(cfg, "grad_bucket_bytes", 0) or 0)

    def sync_items(self, graph: Graph, strategies: Dict[int, OpStrategy],
                   order: Optional[List[Op]] = None
                   ) -> List[Tuple[Op, OpStrategy, Tuple, float]]:
        """(op, strategy, key, bytes) for every synced tensor in backward
        PRODUCTION order (reverse topo) — the issue order the bucket
        schedule groups over. key = (sync degree, inner stride, comm
        channels, grad dtypes): tensors only share a bucket when their
        collective rides the same group over the same rings and reduces
        in one dtype."""
        default = OpStrategy()
        out: List[Tuple[Op, OpStrategy, Tuple, float]] = []
        for op in reversed(order if order is not None
                           else graph.topo_order()):
            s = strategies.get(op.guid, default)
            sync = s.dp * (s.ap if op.op_type in AP_CAPABLE else 1)
            if sync <= 1 or not op.weights:
                continue
            chans = (("dp", "ap") if (s.ap > 1
                                      and op.op_type in AP_CAPABLE)
                     else ("dp",))
            # grad dtype is part of the key: the lowering reduces per
            # dtype with no casts, so a mixed-dtype bucket would execute
            # as more collectives than the ONE the schedule prices
            dts = tuple(sorted({w.dtype.value for w in op.weights}))
            key = (sync, self._sync_inner(op, s), chans, dts)
            out.append((op, s, key, self._grad_sync_bytes(op, s)))
        return out

    def sync_bucket_schedule(self, graph: Graph,
                             strategies: Dict[int, OpStrategy],
                             order: Optional[List[Op]] = None
                             ) -> Optional[List[Dict[str, Any]]]:
        """The priced bucket schedule ([{key, ops, bytes}] in issue
        order, plan_sync_buckets) or None when bucketing is inactive.
        ONE grouping rule shared by simulate(), reduction_plan(), and
        the memory model, so the schedule the search prices is the
        schedule the lowering executes (FFTA072)."""
        target = self.bucket_target()
        if not target:
            return None
        # memoized like the per-op costs: simulate() and memory_bytes()
        # both derive the schedule per candidate per lambda probe, and
        # it is a pure function of (graph, strategies, target) — the
        # mesh context sync_items reads is itself set from `strategies`
        memo = getattr(self, "_bucket_sched_memo", None)
        if memo is None:
            memo = self._bucket_sched_memo = {}
        key = (id(graph), target,
               tuple(sorted(strategies.items())))
        if key in memo:
            return memo[key]
        self.set_mesh_context(strategies)
        items = self.sync_items(graph, strategies, order=order)
        out = plan_sync_buckets(items, target) if items else None
        memo[key] = out
        return out

    def sync_bucket_scratch_bytes(self, graph: Graph,
                                  strategies: Dict[int, OpStrategy]
                                  ) -> float:
        """Per-chip scratch of the largest grad-sync bucket (the fused
        collective concatenates its tensors into one buffer) — the
        memory the search trades overlap against. 0 when bucketing is
        inactive."""
        buckets = self.sync_bucket_schedule(graph, strategies)
        if not buckets:
            return 0.0
        return max(b["bytes"] for b in buckets)

    def reduction_plan(self, graph: Graph,
                       strategies: Dict[int, OpStrategy]
                       ) -> Dict[str, Dict[str, Any]]:
        """Per-synced-tensor reduction decomposition on a hierarchical
        machine: {op name: {strategy, degree, bytes, tiers, time_us}} for
        every op whose weight gradients sync over dp (x ap). This is THE
        decomposition carried on the plan — the Unity search stores it on
        SearchResult.reduction_strategies, export_strategy serializes it,
        the FFTA07x analysis family checks it, and the executor surfaces
        it (docs/machine.md). Empty on flat machines.

        With bucketing active (docs/machine.md "Overlap"), entries
        additionally carry the bucket schedule the simulator priced:
        "bucket" (issue-ordered id), "bucket_bytes", "bucket_time_us" —
        the op's strategy/tiers are its BUCKET's (one fused collective
        per bucket), and "time_us" is its byte-share of that collective.
        The explicit lowering executes the same schedule and FFTA072
        rejects divergence."""
        if not self.tiered:
            return {}
        self.set_mesh_context(strategies)
        out: Dict[str, Dict[str, Any]] = {}
        default = OpStrategy()
        buckets = self.sync_bucket_schedule(graph, strategies)
        bucket_of: Dict[int, int] = {}
        bucket_info: Dict[int, Tuple[str, float, List[Dict[str, Any]],
                                     float]] = {}
        if buckets:
            for bid, b in enumerate(buckets):
                sync, inner = b["key"][:2]
                strat, t_us, tiers = self.machine.reduction_choice(
                    b["bytes"], sync, inner=inner)
                bucket_info[bid] = (strat, t_us, tiers, b["bytes"])
                for op_b, _s in b["ops"]:
                    bucket_of[op_b.guid] = bid
        for op in graph.ops.values():
            s = strategies.get(op.guid, default)
            sync = s.dp * (s.ap if op.op_type in AP_CAPABLE else 1)
            if sync <= 1 or not op.weights:
                continue
            wb = self._grad_sync_bytes(op, s)
            bid = bucket_of.get(op.guid)
            if bid is not None:
                strat, bt_us, tiers, bb = bucket_info[bid]
                out[op.name] = {
                    "strategy": strat, "degree": sync, "bytes": wb,
                    "tiers": tiers,
                    "time_us": bt_us * (wb / bb if bb else 0.0),
                    "bucket": bid, "bucket_bytes": bb,
                    "bucket_time_us": bt_us}
            else:
                strat, t_us, tiers = self.machine.reduction_choice(
                    wb, sync, inner=self._sync_inner(op, s))
                out[op.name] = {"strategy": strat, "degree": sync,
                                "bytes": wb, "tiers": tiers,
                                "time_us": t_us}
        return out

    # outputs of these op types count as no saved-for-backward buffer:
    # the JAX package's liveness model (XLA fuses elementwise chains into
    # the surrounding GEMMs; reshape-like ops alias their input), kept as
    # it is so both packages size a plan alike
    FUSION_TRANSIENT = {
        OpType.RELU, OpType.SIGMOID, OpType.TANH, OpType.ELU, OpType.GELU,
        OpType.IDENTITY, OpType.NOOP, OpType.EXP, OpType.SIN, OpType.COS,
        OpType.RSQRT, OpType.POW, OpType.SCALAR_MULTIPLY, OpType.SCALAR_ADD,
        OpType.SCALAR_SUB, OpType.SCALAR_TRUE_DIV, OpType.EW_ADD,
        OpType.EW_MUL, OpType.EW_SUB, OpType.EW_DIV, OpType.EW_MAX,
        OpType.EW_MIN, OpType.CAST, OpType.RESHAPE, OpType.TRANSPOSE,
        OpType.FLAT, OpType.SPLIT, OpType.DROPOUT,
    }

    def __init__(self, machine: MachineModel, config=None,
                 optimizer_state_factor: float = 3.0):
        self.machine = machine
        self.config = config
        # hierarchical machine (machine_model.HierarchicalMachineModel):
        # collectives price against the tiers each parallel degree actually
        # crosses, and gradient syncs get a synthesized per-tier reduction
        # strategy (docs/machine.md). reduction_mode="flat" reprices a plan
        # that carries NO tier decomposition (one searched under a flat
        # machine model) — the baseline the multipod bench compares against.
        self.tiered = hasattr(machine, "tier_path")
        self.reduction_mode = "auto"
        # (tp, sp, ep, ap) degrees of the realized mesh — see
        # set_mesh_context/set_mesh_degrees above
        self._mesh_ctx = (1, 1, 1, 1)
        # 3.0 = Adam (param + m + v); 2.0 = SGD momentum; 1.0 = plain SGD.
        # FFModel.compile sets config.optimizer_state_factor from the real
        # optimizer before running the search.
        self.opt_state_factor = float(
            getattr(config, "optimizer_state_factor", None)
            or optimizer_state_factor
        )

    def op_memory_bytes(self, op: Op, s: OpStrategy) -> float:
        """Per-chip memory: sharded weights (x optimizer-state factor) +
        activations saved for the backward pass. Liveness: fusion-transient
        outputs (elementwise/reshape) are excluded — XLA never materializes
        them as saved buffers."""
        wshard = s.tp if op.op_type in TP_CAPABLE else 1
        if op.op_type == OpType.EXPERTS:
            wshard = s.ep
        wb = 0.0
        for w in op.weights:
            b = w.num_elements() * w.dtype.itemsize
            # row-parallel: only the kernel shards; the bias is replicated
            if s.tp_row and w._weight_spec.name != "kernel":
                wb += b
            else:
                wb += b / max(1, wshard)
        if op.op_type in self.FUSION_TRANSIENT:
            return self.opt_state_factor * wb
        ab = sum(t.num_elements() * t.dtype.itemsize for t in op.outputs)
        # activations shard over dp (tp for column-TP ops, ap for spatial
        # ops); row-parallel outputs are replicated after their all-reduce;
        # EXPERTS outputs are data-sharded only — the expert axis shards
        # weights/buffers, not them
        ashard = s.dp * (s.tp if op.op_type in TP_CAPABLE
                         and not s.tp_row else 1)
        if op.op_type in AP_CAPABLE:
            ashard *= s.ap
        if sp_shardable(op, s.sp):
            ashard *= s.sp
        ab /= max(1, ashard)
        return self.opt_state_factor * wb + ab


class OpCostCache:
    """Measured per-op costs (reference: Simulator::measure_operator_cost +
    hash cache simulator.h:750-752): jit the single op at its sharded local
    shape, time warm fwd and bwd runs on the real device.

    Cache keys are shape-based (Op.cost_key), so identical ops — e.g. the 12
    identical layers of a BERT stack, or the same op across compiles — share
    one measurement. Measurement failures are recorded and logged, never
    silently degraded to the analytic model (the Simulator does the fallback
    and the search logs the counts)."""

    def __init__(self, config=None, warmup: int = 2, repeats: int = 5,
                 path: Optional[str] = None):
        self.config = config
        self.warmup = warmup
        self.repeats = repeats
        # cost_key -> (fwd_us, bwd_us); bwd_us < 0 when only fwd measured
        self.cache: Dict[Tuple, Tuple[float, float]] = {}
        self.failures: Dict[Tuple, str] = {}
        self.hits = 0
        self.misses = 0
        self.failure_hits = 0
        self.path = path
        self._has_str_keys = False
        if path:
            self._load(path)
            self._has_str_keys = any(isinstance(k, str) for k in self.cache)

    # -- persistence (across processes; in-process sharing comes from the
    # module-level singleton in get_op_cost_cache) ------------------------
    def _load(self, path: str) -> None:
        import os

        if not os.path.exists(path):
            return
        try:
            with open(path) as f:
                data = json.load(f)
            for k, (fwd, bwd) in data.items():
                self.cache[k] = (fwd, bwd)
        except Exception as exc:  # corrupt cache: start fresh
            _log.warning("op-cost cache %s unreadable (%s); ignoring", path, exc)

    def save(self) -> None:
        if not self.path:
            return
        try:
            data = {self._str_key(k): v for k, v in self.cache.items()}
            with open(self.path, "w") as f:
                json.dump(data, f)
        except OSError as exc:  # never fail a successful search over the cache
            _log.warning("op-cost cache not saved to %s: %s", self.path, exc)

    @staticmethod
    def _str_key(key) -> str:
        return key if isinstance(key, str) else repr(key)

    @staticmethod
    def _op_config(op: Op, fallback):
        cfg = getattr(op, "model_config", None)
        return cfg if cfg is not None else fallback

    def _key(self, op: Op, dp: int, tp: int = 1) -> Tuple:
        # precision is part of the identity: the same op lowers to bf16 or
        # f32 matmuls depending on allow_mixed_precision (ops/common.py)
        cfg = self._op_config(op, self.config)
        mixed = bool(cfg.allow_mixed_precision) if cfg is not None else True
        key = (op.cost_key(), dp, mixed)
        # tp appended only when sharded, keeping round-2 cache files valid
        return key if tp <= 1 else key + (tp,)

    def stats(self) -> str:
        return (f"measured-cost cache: {self.hits} hits, {self.misses} misses, "
                f"{len(self.failures)} failures"
                + (f" ({self.failure_hits} failure-hits)" if self.failure_hits
                   else ""))

    # -- measurement ------------------------------------------------------
    def measure_forward_us(self, op: Op, s: OpStrategy) -> float:
        fwd, _ = self.measure_us(op, s)
        return fwd

    TP_WEIGHT_DIMS = TP_WEIGHT_SHARD_DIMS

    def measure_us(self, op: Op, s: OpStrategy) -> Tuple[float, float]:
        """(fwd_us, bwd_us) for op under strategy s; (-1, -1) if unmeasurable.

        The op is measured at its true sharded local shapes: batch/dp inputs,
        and — for TP-capable ops with weight shard maps — tp-sharded weight
        dims, so the dp-vs-tp decision rests on measured points on both sides
        (TP-sharded matmuls have a different efficiency than time/tp
        predicts). Degrees without a shard map (batch_matmul tp, expert ep,
        spatial ap) still scale the measured dp point analytically."""
        if op.op_type in (OpType.INPUT, OpType.NOOP, OpType.WEIGHT):
            return 0.0, 0.0
        row = bool(s.tp_row) and op.op_type == OpType.LINEAR
        dims_map = ({"kernel": 0} if row
                    else self.TP_WEIGHT_DIMS.get(op.op_type))
        measurable_tp = (s.tp if s.tp > 1 and dims_map
                         and self._tp_shardable(op, s.tp, dims_map) else 1)
        key = self._key(op, s.dp, measurable_tp)
        if row and measurable_tp > 1:
            key = key + ("row",)
        if key in self.cache:
            self.hits += 1
            fwd, bwd = self.cache[key]
        elif key in self.failures:
            self.failure_hits += 1
            if measurable_tp > 1:
                # the tp-sharded measurement failed: fall back to the
                # measured dp point scaled by 1/tp rather than the analytic
                # model, so dp-vs-tp still compares on the measured scale
                fwd, bwd = self.measure_us(
                    op, dataclasses.replace(s, tp=1))
                return ((fwd / s.tp, bwd / s.tp if bwd >= 0 else bwd)
                        if fwd >= 0 else (-1.0, -1.0))
            return -1.0, -1.0
        else:
            # promote a persisted (string-keyed) entry to the tuple key
            skey = self._str_key(key) if self._has_str_keys else None
            if skey is not None and skey in self.cache:
                self.hits += 1
                fwd, bwd = self.cache.pop(skey)
                self.cache[key] = (fwd, bwd)
            else:
                self.misses += 1
                try:
                    fwd, bwd = self._measure(op, s.dp, measurable_tp,
                                             tp_dims=dims_map,
                                             shard_input_dim=-1 if row else None)
                    self.cache[key] = (fwd, bwd)
                except Exception as exc:
                    self.failures[key] = f"{type(exc).__name__}: {exc}"
                    _log.warning("op-cost measurement failed for %s: %s",
                                 op.name, self.failures[key])
                    return -1.0, -1.0
        # analytic scaling for the degrees not captured in the measurement
        scale = 1
        if op.op_type in TP_CAPABLE and measurable_tp == 1:
            scale = s.tp
        if op.op_type == OpType.EXPERTS:
            scale = s.ep
        elif op.op_type in AP_CAPABLE:
            scale = s.ap
        return fwd / scale, (bwd / scale if bwd >= 0 else bwd)

    def _tp_shardable(self, op: Op, tp: int, dims_map=None) -> bool:
        dims_map = dims_map or self.TP_WEIGHT_DIMS[op.op_type]
        for w in op.weights:
            name = w._weight_spec.name
            if name in dims_map:
                d = dims_map[name] % len(w.dims)
                if w.dims[d] % tp != 0:
                    return False
        return True

    def _measure(self, op: Op, dp: int, tp: int = 1, tp_dims=None,
                 shard_input_dim=None) -> Tuple[float, float]:
        """Time the op's own lowering, eagerly, on its model's device, at
        the local shapes: the batch (dim 0) divided by `dp`, and for tp > 1
        each weight `tp_dims` names cut to its 1/tp shard (a row-parallel
        linear also cuts the input's contraction dim). The model is never
        touched: the lowering runs on a shallow copy of the op that holds
        zero weights at those shapes and copies of its state buffers, in
        inference mode with a fresh generator, so the model's weights,
        state and generator keep their bits. A tp-sharded copy runs as one
        device (no collectives): the local piece of the work; where that
        lowering raises, the failure is recorded and measure_us falls back
        to the measured dp point scaled by 1/tp, as the JAX package does.

        Inputs are zeros in the dtype the executor's walk hands the op (a
        graph input's declared dtype, else the boundary dtype, bf16 under
        mixed precision), and the outputs take the walk's boundary cast.
        The backward is torch.autograd.grad of the sum of the float
        outputs with respect to the float inputs and the weights, less the
        measured forward (JAX takes jax.grad less the forward)."""
        import torch

        from ..core.op import LoweringContext
        from ..ffconst import CompMode
        from ..ops.common import emit_dtype

        cfg = self._op_config(op, self.config)
        device = torch.device(getattr(cfg, "device", None) or "cpu")

        def local_shape(t):
            dims = list(t.dims)
            if dims and dims[0] % max(dp, 1) == 0:
                dims[0] //= max(dp, 1)
            if (shard_input_dim is not None and tp > 1
                    and dims[shard_input_dim] % tp == 0):
                # row-parallel: the contraction dim shards with the kernel
                dims[shard_input_dim] //= tp
            return tuple(dims)

        def in_dtype(t):
            src = t.owner_op
            if src is None or src.op_type == OpType.INPUT:
                return t.dtype.torch_dtype
            return emit_dtype(cfg, t.dtype)

        ins = [torch.zeros(local_shape(t), dtype=in_dtype(t), device=device)
               for t in op.inputs]
        if tp <= 1:
            tp_dims = {}
        elif tp_dims is None:
            tp_dims = self.TP_WEIGHT_DIMS.get(op.op_type, {})
        params = {}
        for w in op.weights:
            ws = w._weight_spec
            dims = list(ws.dims)
            if ws.name in tp_dims:
                d = tp_dims[ws.name] % len(dims)
                dims[d] //= tp  # the tp-sharded local weight shape
            params[ws.name] = torch.nn.Parameter(torch.zeros(
                tuple(dims), dtype=ws.dtype.torch_dtype, device=device))
        clone = copy.copy(op)
        # the copy's own registries: assigning them leaves the op's alone
        object.__setattr__(clone, "_parameters", params)
        object.__setattr__(clone, "_buffers", {
            k: v.detach().clone() for k, v in op._buffers.items()
            if v is not None})
        object.__setattr__(clone, "_cast", {})
        object.__setattr__(clone, "kernel_memo", {})
        object.__setattr__(clone, "shards", {})
        object.__setattr__(clone, "tp_degree", 1)
        out_dtypes = [emit_dtype(cfg, t.dtype) for t in op.outputs]
        generator = torch.Generator(device=device).manual_seed(0)

        def run(xs):
            ctx = LoweringContext(cfg, CompMode.COMP_MODE_INFERENCE)
            ctx.generator = generator
            outs = clone.lower(ctx, list(xs))
            return [o.to(dt) for o, dt in zip(outs, out_dtypes)]

        def fwd():
            with torch.no_grad():
                return run(ins)

        fwd_us = self._time(fwd, device)

        float_ins = [x.requires_grad_() for x in ins
                     if x.dtype.is_floating_point]
        wrt = float_ins + [p for p in params.values()
                           if p.dtype.is_floating_point]
        bwd_us = -1.0
        if wrt:
            def bwd():
                with torch.enable_grad():
                    outs = [o for o in run(ins) if o.dtype.is_floating_point]
                    loss = sum(o.float().sum() for o in outs)
                    return torch.autograd.grad(loss, wrt, allow_unused=True)

            try:
                bwd_us = max(0.0, self._time(bwd, device) - fwd_us)
            except Exception:
                bwd_us = -1.0  # non-differentiable op: fwd-only measurement
        return fwd_us, bwd_us

    def _time(self, fn, device) -> float:
        """us a call: one call (it builds the kernels), `warmup` calls,
        then `repeats` calls between two CUDA events on the card (the host
        clock around them on the CPU)."""
        import torch

        fn()
        for _ in range(self.warmup):
            fn()
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(self.repeats):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) * 1e3 / self.repeats
        t0 = time.perf_counter()
        for _ in range(self.repeats):
            fn()
        return (time.perf_counter() - t0) / self.repeats * 1e6


_GLOBAL_CACHE: Optional[OpCostCache] = None


def get_op_cost_cache(config=None) -> OpCostCache:
    """Process-wide measured-cost cache, shared across compiles (reference:
    the Simulator outlives individual searches and keeps its hash cache)."""
    global _GLOBAL_CACHE
    path = getattr(config, "op_cost_cache_file", None) if config else None
    if _GLOBAL_CACHE is None or (path and _GLOBAL_CACHE.path != path):
        _GLOBAL_CACHE = OpCostCache(config, path=path)
    return _GLOBAL_CACHE


class Simulator:
    """Whole-graph strategy cost (reference: simulate_runtime +
    SearchHelper::graph_cost)."""

    def __init__(self, machine: MachineModel, config=None,
                 measured: Optional[OpCostCache] = None):
        self.machine = machine
        self.config = config
        self.cost = CostModel(machine, config)
        self.measured = measured
        self.analytic_fallbacks = 0
        # grad-sync overlap accounting of the LAST simulate() call
        # (docs/machine.md "Overlap"): {total_sync_us,
        # overlapped_sync_us, exposed_sync_us, buckets: [...]} — what
        # the Unity search copies onto SearchResult
        self.last_sync_stats: Optional[Dict[str, Any]] = None
        self._fwd_bwd_memo: Dict[Tuple, Tuple[float, float]] = {}
        self._step_memo: Dict[Tuple, float] = {}
        # (data-axis reshard us, model-axis boundary us) per edge key
        self._edge_memo: Dict[Tuple, Tuple[float, float]] = {}

    def fwd_bwd_time_us(self, op: Op, s: OpStrategy) -> Tuple[float, float]:
        """(fwd, bwd) from the measured cache when available, analytic
        otherwise — one consistent source for both numbers. Memoized per
        (op, strategy): the refinement loop re-simulates the full graph per
        flip, re-querying every unchanged op (was ~60% of search time)."""
        # the frozen dataclass is its own all-fields hash key: a future
        # OpStrategy field changes every memo identity at once
        key = (op.guid, s)
        hit = self._fwd_bwd_memo.get(key)
        if hit is not None:
            return hit
        out = self._fwd_bwd_uncached(op, s)
        self._fwd_bwd_memo[key] = out
        return out

    def _fwd_bwd_uncached(self, op: Op, s: OpStrategy) -> Tuple[float, float]:
        fwd = bwd = -1.0
        if self.measured is not None:
            fwd, bwd = self.measured.measure_us(op, s)
            if fwd < 0:
                self.analytic_fallbacks += 1
            elif sp_shardable(op, s.sp):
                # measured at the (dp, tp) local shape with the full
                # sequence; per-chip work under sp divides by sp exactly —
                # position-wise ops scale with L, and the attention core's
                # per-chip share is (L/sp) x L
                fwd /= s.sp
                if bwd > 0:
                    bwd /= s.sp
        if fwd < 0:
            fwd = self.cost.forward_time_us(op, s)
        if bwd < 0:
            # bwd unmeasured: scale the (possibly measured) fwd by the
            # analytic fwd:bwd ratio
            bwd = _MEMORY_BOUND_BWD_FACTOR * fwd
        return fwd, bwd

    def op_step_time_us(self, op: Op, s: OpStrategy) -> float:
        """Per-op cost used to SEED the segment search. tp_collective is an
        upper-bound heuristic here — the event-driven simulate() prices TP
        resharding exactly on boundary edges, and best-first refinement
        re-scores flips with it — charging it at seed time just biases seeds
        conservatively where edges are unknown."""
        key = (op.guid, s, self.cost._mesh_ctx)
        hit = self._step_memo.get(key)
        if hit is not None:
            return hit
        fwd, bwd = self.fwd_bwd_time_us(op, s)
        out = (fwd + bwd + self.cost.tp_collective_time_us(op, s)
               + self.cost.ep_collective_time_us(op, s)
               + self.cost.ap_halo_time_us(op, s)
               + self.cost.sp_collective_time_us(op, s))
        self._step_memo[key] = out
        return out

    def simulate(self, graph: Graph, strategies: Dict[int, OpStrategy]) -> float:
        """Per-iteration time (us): event-driven schedule of the
        fwd/bwd/update task graph on two streams — compute (ops serialize
        on the device) and communication (collectives, overlapping
        compute).
        Reference: simulate_runtime's task graph with comm tasks,
        simulator.cc:815+. config.search_overlap_backward_update=False forces
        collectives onto the compute stream (no overlap)."""
        default = OpStrategy()
        order = graph.topo_order()
        # tiered machines: the realized mesh fixes each axis's device
        # stride — derive it from THIS strategy set before any pricing
        self.cost.set_mesh_context(strategies)
        overlap = bool(self.config is None
                       or self.config.search_overlap_backward_update)
        # per-axis ICI timelines (congestion analog of EnhancedMachineModel's
        # per-link queues, simulator.h:279-513): collectives on the SAME mesh
        # axis contend for its torus rings and serialize; collectives on
        # different axes ride disjoint link sets and overlap. Machine models
        # without a torus/topology (SimpleMachineModel) keep the single
        # serializing timeline.
        per_axis = overlap and self.machine.comm_channels()
        t_compute = 0.0
        t_comm = 0.0
        t_ch = {"dp": 0.0, "tp": 0.0, "sp": 0.0, "ep": 0.0, "ap": 0.0}
        # bucketed/async gradient reduction (docs/machine.md "Overlap"):
        # on a multi-tier machine, synced gradients group into
        # size-targeted buckets that issue when their LAST member's
        # gradient is produced, so each bucket's per-tier collective
        # overlaps the remaining backward. Inactive (None) under
        # blocking pricing, flat repricing, per-tensor mode
        # (grad_bucket_bytes=0), and on flat/one-tier machines — those
        # paths keep the historical per-op issue bit-for-bit.
        buckets = (self.cost.sync_bucket_schedule(graph, strategies,
                                                  order=order)
                   if overlap else None)
        bucket_of: Dict[int, int] = {}
        bucket_state: List[Dict[str, Any]] = []
        if buckets:
            for b in buckets:
                bucket_state.append({"key": b["key"], "bytes": b["bytes"],
                                     "left": len(b["ops"]), "ready": 0.0})
                for op_b, _s in b["ops"]:
                    bucket_of[op_b.guid] = len(bucket_state) - 1
        sync_total = 0.0
        issued_buckets: List[Dict[str, Any]] = []

        def run_comm(dur: float, ready: float, ch: Optional[str] = None) -> float:
            nonlocal t_comm, t_compute
            if dur <= 0.0:
                return ready
            if not overlap:
                start = max(t_compute, ready)
                t_compute = start + dur
                return t_compute
            if not per_axis or ch is None:
                # one ICI timeline; a channel-less transfer under per-axis
                # mode crosses every axis (full-mesh reshard): barrier
                start = max(t_comm, ready,
                            *(t_ch.values() if per_axis else ()))
                end = start + dur
                t_comm = end
                if per_axis:
                    for k in t_ch:
                        t_ch[k] = end
                return end
            start = max(t_ch[ch], ready)
            t_ch[ch] = start + dur
            return t_ch[ch]

        def run_comm_group(dur: float, ready: float,
                           chans: Tuple[str, ...]) -> float:
            """A collective over a PRODUCT of mesh axes (e.g. the dp x ap
            grad allreduce) occupies every involved axis's rings."""
            nonlocal t_comm
            if dur <= 0.0:
                return ready
            if not overlap or not per_axis:
                return run_comm(dur, ready)
            start = max(ready, *(t_ch[c] for c in chans))
            end = start + dur
            for c in chans:
                t_ch[c] = end
            return end

        def run_compute(dur: float, ready: float) -> float:
            nonlocal t_compute
            start = max(t_compute, ready)
            t_compute = start + dur
            return t_compute

        edge_memo = self._edge_memo

        def edge_comm_us(t, src_op, src_s, s, backward=False) -> Tuple[float, float]:
            """(data-axis reshard us, model-axis boundary us) — separate
            channels: the dp-degree allgather rides the data rings, the TP
            boundary collective rides the model rings."""
            key = (t.guid, src_op.guid, backward, src_s, s,
                   self.cost._mesh_ctx)
            hit = edge_memo.get(key)
            if hit is not None:
                return hit
            bytes_ = t.num_elements() * t.dtype.itemsize
            out = (self.cost.xfer_time_us(bytes_, src_s, s),
                   self.cost.tp_boundary_time_us(bytes_, src_op, src_s, s,
                                                 backward=backward))
            edge_memo[key] = out
            return out

        def run_edge(t, src_op, src_s, s, ready, backward=False) -> float:
            xfer, boundary = edge_comm_us(t, src_op, src_s, s,
                                          backward=backward)
            fin = run_comm(xfer, ready, "dp")
            return run_comm(boundary, fin, "tp")

        # -- forward -------------------------------------------------------
        fwd_times: Dict[int, Tuple[float, float]] = {}
        out_ready: Dict[int, float] = {}
        for op in order:
            s = strategies.get(op.guid, default)
            fwd, bwd = self.fwd_bwd_time_us(op, s)
            fwd_times[op.guid] = (fwd, bwd)
            ready = 0.0
            for t in op.inputs:
                src_op = t.owner_op
                if src_op is None or src_op.guid not in graph.ops:
                    continue
                src_s = strategies.get(src_op.guid, default)
                e = run_edge(t, src_op, src_s, s, out_ready[src_op.guid])
                ready = max(ready, e)
            fin = run_compute(fwd, ready)
            # op-internal fwd collectives gate the op's output: expert
            # all_to_all, conv halos, the ring K/V rotation, and the
            # row-parallel linear's partial-sum allreduce — chained (they
            # gate each other through the op) but each on its own axis
            fin = run_comm(0.5 * self.cost.ep_collective_time_us(op, s),
                           fin, "ep")
            fin = run_comm(0.5 * self.cost.ap_halo_time_us(op, s), fin, "ap")
            fin = run_comm(0.5 * self.cost.sp_collective_time_us(op, s),
                           fin, "sp")
            if s.tp_row:
                fin = run_comm(0.5 * self.cost.tp_collective_time_us(op, s),
                               fin, "tp")
            out_ready[op.guid] = fin

        # -- backward (reverse topo: bwd(op) after bwd of its consumers) ---
        # consumer edges in graph serialization order (ops dict order, then
        # input position) — identical to the native core's edge scan
        consumer_edges: Dict[int, List[Tuple[Op, Any]]] = {g: [] for g in graph.ops}
        for con in graph.ops.values():
            for t in con.inputs:
                src_op = t.owner_op
                if src_op is not None and src_op.guid in graph.ops:
                    consumer_edges[src_op.guid].append((con, t))
        bwd_end: Dict[int, float] = {}
        update_ready = 0.0
        for op in reversed(order):
            s = strategies.get(op.guid, default)
            _, bwd = fwd_times[op.guid]
            ready = 0.0
            for con, t in consumer_edges[op.guid]:
                con_s = strategies.get(con.guid, default)
                # mirrored reshard of the input gradient
                ready = max(ready, run_edge(t, op, s, con_s,
                                            bwd_end[con.guid],
                                            backward=True))
            fin = run_compute(bwd, ready)
            fin = run_comm(0.5 * self.cost.ep_collective_time_us(op, s),
                           fin, "ep")
            fin = run_comm(0.5 * self.cost.ap_halo_time_us(op, s), fin, "ap")
            fin = run_comm(0.5 * self.cost.sp_collective_time_us(op, s),
                           fin, "sp")
            if s.tp_row:  # bwd allreduce at the Megatron pair entry
                fin = run_comm(0.5 * self.cost.tp_collective_time_us(op, s),
                               fin, "tp")
            bwd_end[op.guid] = fin
            # weight-gradient allreduce: async on the data-axis rings (plus
            # the attr rings when the op's weights replicate across ap
            # shards — the reduce spans the dp x ap group and contends with
            # halo exchanges there); the optimizer update waits for the
            # last one (this is where dp overlap with the remaining
            # backward is won — and why it must not queue behind model-axis
            # activation collectives)
            bid = bucket_of.get(op.guid)
            if bid is not None:
                # bucketed issue: the bucket's ONE fused collective fires
                # when its last member's gradient is produced here
                st = bucket_state[bid]
                st["ready"] = max(st["ready"], fin)
                st["left"] -= 1
                if st["left"] == 0:
                    b_sync, b_inner, b_chans = st["key"][:3]
                    strat, dur, _tiers = self.machine.reduction_choice(
                        st["bytes"], b_sync, inner=b_inner)
                    sync_total += dur
                    update_ready = max(
                        update_ready,
                        run_comm_group(dur, st["ready"], b_chans))
                    issued_buckets.append(
                        {"bytes": st["bytes"], "strategy": strat,
                         "time_us": dur,
                         "tensors": len(buckets[bid]["ops"])})
            else:
                gs = self.cost.grad_sync_time_us(op, s)
                sync_total += gs
                gs_chans = (("dp", "ap") if (s.ap > 1
                                             and op.op_type in AP_CAPABLE)
                            else ("dp",))
                update_ready = max(update_ready,
                                   run_comm_group(gs, fin, gs_chans))

        # grad-sync overlap split (docs/machine.md "Overlap"): exposed =
        # the sync tail extending the step past the compute stream's end
        # (under blocking pricing every sync is exposed by definition);
        # overlapped = the rest. Replaces the all-or-nothing
        # search_overlap_backward_update discount as the search's
        # overlap quantity.
        if overlap:
            exposed = min(sync_total, max(0.0, update_ready - t_compute))
        else:
            exposed = sync_total
        self.last_sync_stats = {
            "total_sync_us": sync_total,
            "overlapped_sync_us": max(0.0, sync_total - exposed),
            "exposed_sync_us": exposed,
            "buckets": issued_buckets,
        }
        # step_time_scale: fitted whole-step bias multiplier (1.0 unless a
        # fitted profile overlays it). Applied HERE only — per-op costs stay
        # unscaled, and being uniform it cannot change a plan ranking.
        return (max(t_compute, update_ready)
                * getattr(self.machine, "step_time_scale", 1.0))

    def memory_bytes(self, graph: Graph, strategies: Dict[int, OpStrategy]) -> float:
        default = OpStrategy()
        total = sum(
            self.cost.op_memory_bytes(op, strategies.get(op.guid, default))
            for op in graph.ops.values()
        )
        # bucketed grad sync concatenates each bucket into one fused
        # buffer: the largest bucket is live scratch during backward —
        # the memory the search trades overlap against (0 when
        # bucketing is inactive)
        return total + self.cost.sync_bucket_scratch_bytes(graph,
                                                           strategies)


def reshard_cost_us(schedule, machine) -> float:
    """Price a live-resharding schedule (JAX: resharding/cost.py
    schedule_cost_us); live resharding is not ported (ROADMAP A8)."""
    raise NotImplementedError(
        "reshard_cost_us: live resharding is not ported yet (ROADMAP A8)")
