"""Multi-head attention (counterpart of flexflow_tpu/ops/attention.py):
the full-sequence path and the KV-cache decoding half.

Weights keep the JAX package's names and layouts: wq/wk/wv (e, h, d),
wo (h, d, e), bq/bk/bv (h, d), bo (e). Projections and the output
projection are plain matmuls.

Every attention core is a kernel-tier family (kernels/registry.py), with
the JAX package's einsum chain as its reference lowering.

Full sequence (training, and inference without caches), family
`attention`, selected by the op's `use_flash` param first: the kernel
tier is the JAX package's packed branch. q, k and v are projected with
wq.reshape(e, h*d) in the compute dtype to (b, l, h*d) and run through
the flash-attention kernel (kernels/flash_attention.py) in that layout,
its backward a kernel too. The reference is the einsum core: (b, l, h, d)
projections, f32 logits times the scale, the causal mask
tril(ones(lq, lk), lk - lq) with -1e30, an f32 softmax, the context
product in the compute dtype, under autograd. Either way the context goes
through wo, is cast to the output's boundary dtype, and bo is added in
that dtype.

Sequence parallelism (the JAX package's `ops/attention.py:97-99,
205-232`): on a mesh with a `seq` axis an op the plan cuts over it
(FFModel._assign_strategy, which sets `sequence_parallel` as JAX's
does; `Op.seq_local`) takes its q, k and v inputs cut on the positions
(runtime/executor.py) and projects them head-separated, (b, l/s, h, d).
`sequence_parallel_mode` "ring" (the default) runs
kernels/ring_attention.py, "ulysses" or "all_to_all"
kernels/ulysses_attention.py, whose local core is the flash kernel
where `_use_flash` chooses it; any other mode raises ValueError. The
context goes through wo and bo as above; with a `model` axis too, the
heads are this rank's and the output is summed over the model group.
Iteration truncation does not apply under it, as in JAX.
`sequence_parallel=True` with dropout raises ValueError at build, as in
JAX; the plan keeps attention with dropout > 0 unsharded over `seq`
(JAX `model.py:1051-1058`), and so do the ops whose positions do not
divide over it.

Attention-probability dropout (the JAX package's `ops/attention.py:
258-278`): a training walk with `dropout > 0` takes the einsum core
whatever the registry picks (the flash kernel has no dropout), and drops
out the f32 probabilities there with a keep mask drawn from the walk's
generator (ops/norm.py `dropout_keep`), divided by 1 - dropout, before
the cast to the compute dtype. JAX rematerialises that core in the
backward (`jax.checkpoint`); the port keeps what autograd saves instead:
the f32 probabilities and the bool mask, 160 MiB a layer at the
flagship's (8, 16, 512, 512), with the compute-dtype probabilities
beside them. Inference, and dropout 0, take the path the op takes
without dropout (the flash kernel on the card). `use_flash=True` with
dropout raises, as in JAX. kdim != vdim also takes the einsum core (the
kernels take one head dim), in decoding the einsum decode chain.

A training walk's dropout mask is drawn at the op's whole shape (the
global batch, every head) and cut to this rank's slice of the batch and
heads, so a mesh run draws what the one-device run draws.

On a mesh whose `model` axis is larger than 1 (`tp > 1`, the JAX
package's `ops/attention.py:143-146`) the packed path is off: the heads
are what shard (wq/wk/wv on their heads axis, bq/bk/bv and wo on theirs,
bo replicated; search/simulator.py TP_WEIGHT_SHARD_DIMS). The input
enters through `enter_tp` (one gradient all-reduce for q, k and v when
they are one tensor), the head-separated projections give this rank's
(b, l, h/tp, d) heads, the kernel tier runs the head-separated flash
kernel on them in the blhd layout (kernels/flash_attention.py
`flash_attention_heads`) and the reference the einsum core, and the
local heads' part of the output projection is summed over the ranks in
f32 (`reduce_sum`) before it is cast and bo is added once.

Decoding: the caller holds the caches in `ctx.state[op name]`, updated in
place. The QK^T -> masked softmax -> V core runs through the port's
decode-attention kernel (kernels/decode.py; families `attention_decode`
for C = 1 with a position vector, `attention_decode_mq` for C > 1 and
for a chunk offset) or, when the kernel is not selected, through the JAX
package's einsum decode chain over the whole cache. Two entries, as
`_decode_step` in the JAX package:
 - a (B,) int32 tensor of per-slot positions with C >= 1 query tokens
   per slot: the continuous batcher's decode iteration (C = 1) and
   speculative decoding's verify (C = k + 1). Slot i's rows land at
   [pos[i], pos[i] + C) of its cache and its query j attends rows
   <= pos[i] + j. A row past the cache edge takes the chunk rule below,
   per slot: JAX's scatter drops it; the port aims it at row M - 1 with
   the source of row M - 1, which writes what JAX writes whenever
   pos[i] < M. A position at or past M (the draft's step j writes at
   pos + j, past the edge on a sequence's last iteration) holds no
   such source: row M - 1 takes the step's own row, where JAX keeps the
   old one. No pick the batcher keeps reads row M - 1: a request's last
   token comes from position plen + max_new - 2 <= M - 2. The rows are
   device arithmetic on `pos` (no host read), so the walk can be
   captured;
 - a chunk offset with C >= 1 query tokens: chunked prefill. The
   chunk's K/V rows land at [pos, pos + C) and query j attends rows
   <= pos + j. Rows past the cache edge are DROPPED, where JAX's
   `dynamic_update_slice` would clamp the start and shift the chunk; the
   JAX batcher keeps chunk - 1 slack rows so that its clamp never fires,
   the port writes the pool slot directly and drops the padded tail. The
   offset is a 0-d int32 tensor on the device (the executor makes one of
   a host int), so a prefill chunk captured in a CUDA graph takes a new
   offset at every replay: the rows are written through device indices,
   each row past the edge aimed at the last row with the last row's own
   value, so 0 <= offset < M must hold.

Prefill (`fill_kv_cache`, the JAX package's `ops/attention.py:179-195`):
a full-sequence walk whose state holds this op's caches writes the
projections' K/V rows into cache rows [0, l) (at most M of them), then
attends as the full-sequence path does (the flash kernel, causal for the
LM, or the einsum core). The packed (b, l, h*d) projections view into
the cache's (b, l, h, d) rows for free.

On a data x model mesh (serving on ranks, the JAX entry's leg 9) a
rank's caches hold its own rows (b/dp where `data` divides the batch)
and its own heads (h/tp on `model`; serving/sched/kvpool.py
`local_kv_cache_spec`). A prefill on `model` > 1 takes the
head-separated path and writes the local K and V heads before the `wo`
product (the blhd flash kernel, causal, as JAX keeps a TP mesh on it);
on `data` alone the packed path runs on the rank's rows. Decoding runs
the decode kernels on the local heads, and `_decode_project` sums the
local heads' `wo` products over `model` in f32 before it adds bo once.
"""
from __future__ import annotations

import math
from typing import List

import torch

from ..core.op import Op, WeightSpec, register_op
from ..ffconst import CompMode, OpType
from ..kernels.decode import decode_attention, multiquery_decode_attention
from ..kernels.flash_attention import (flash_attention, flash_attention_heads,
                                       flash_fits)
from ..kernels.registry import KERNELS, flash_crossover
from ..kernels.ring_attention import ring_attention
from ..kernels.ulysses_attention import check_ulysses, ulysses_attention
from ..runtime.collectives import enter_tp, reduce_sum
from ..runtime.initializers import DefaultInitializer, ZeroInitializer
from .common import emit_dtype, matmul_dtype
from .norm import apply_dropout, dropout_keep, global_keep

# score of a masked key, as the JAX package's einsum core and kernels
NEG_INF = -1e30


@register_op
class MultiHeadAttentionOp(Op):
    op_type = OpType.MULTIHEAD_ATTENTION

    def _dims(self):
        q, k, v = self.inputs[:3]
        p = self.params
        embed = p["embed_dim"]
        heads = p["num_heads"]
        kdim = p.get("kdim") or embed // heads
        vdim = p.get("vdim") or embed // heads
        return q, k, v, embed, heads, kdim, vdim

    def output_shapes(self):
        q, _, _, embed, _, _, _ = self._dims()
        if self.params.get("use_flash"):
            kdim, vdim = self.params.get("kdim"), self.params.get("vdim")
            if self.params.get("dropout", 0.0) > 0:
                raise ValueError(
                    "use_flash=True attention has no attention-prob dropout; "
                    "set dropout=0 or drop the explicit use_flash")
            if kdim != vdim:
                raise ValueError(
                    "use_flash=True requires kdim == vdim (one head_dim in "
                    "the kernel); got kdim={} vdim={}".format(kdim, vdim))
        if self.params.get("sequence_parallel") \
                and self.params.get("dropout", 0.0) > 0:
            # the sequence-parallel kernels have no attention-prob dropout
            raise ValueError(
                "sequence_parallel attention does not support attention-prob "
                "dropout; set dropout=0 or sequence_parallel=False")
        return [q.dims[:-1] + (embed,)], [q.dtype]

    def weight_specs(self) -> List[WeightSpec]:
        q, k, v, embed, heads, kdim, vdim = self._dims()
        user_init = self.params.get("kernel_initializer")

        def init(fan_in, fan_out):
            return user_init or DefaultInitializer(fan_in=fan_in,
                                                   fan_out=fan_out)

        dt = q.dtype
        specs = [
            WeightSpec("wq", (q.dims[-1], heads, kdim), dt,
                       init(q.dims[-1], heads * kdim)),
            WeightSpec("wk", (k.dims[-1], heads, kdim), dt,
                       init(k.dims[-1], heads * kdim)),
            WeightSpec("wv", (v.dims[-1], heads, vdim), dt,
                       init(v.dims[-1], heads * vdim)),
            WeightSpec("wo", (heads, vdim, embed), dt,
                       init(heads * vdim, embed)),
        ]
        if self.params.get("bias", True):
            specs += [
                WeightSpec("bq", (heads, kdim), dt, ZeroInitializer()),
                WeightSpec("bk", (heads, kdim), dt, ZeroInitializer()),
                WeightSpec("bv", (heads, vdim), dt, ZeroInitializer()),
                WeightSpec("bo", (embed,), dt, ZeroInitializer()),
            ]
        return specs

    def _project(self, x, w, b, cdt):
        """einsum('ble,ehd->blhd') plus bias, in the compute dtype."""
        e, h, d = self._parameters[w].shape
        y = torch.matmul(x.to(cdt), self.w(w, cdt).reshape(e, h * d))
        y = y.reshape(x.shape[0], x.shape[1], h, d)
        if self.has_weight(b):
            y = y + self.w(b, cdt)
        return y

    def lower(self, ctx, inputs):
        if ctx.decode_pos is None:
            q_in, k_in, v_in = inputs[:3]
            full = q_in.shape[1]
            trunc = ctx.iter_seq_length
            if self._seq_parallel(ctx):  # no truncation under it (JAX)
                return [self._head_separated(ctx, q_in, k_in, v_in)]
            if trunc is None or trunc >= full:
                return [self._full_sequence(ctx, q_in, k_in, v_in)]
            # iteration truncation (JAX `ops/attention.py:89-109, 302-303`):
            # the first L positions through whichever core the walk takes,
            # the output padded back with zeros
            out = self._full_sequence(ctx, q_in[:, :trunc],
                                      k_in[:, :min(trunc, k_in.shape[1])],
                                      v_in[:, :min(trunc, v_in.shape[1])])
            return [torch.nn.functional.pad(out, (0, 0, 0, full - trunc))]
        if self.name not in ctx.state:
            raise ValueError(f"{self.name}: decode_pos given but no KV "
                             "caches in the state")
        q_in, k_in, v_in = inputs[:3]
        cdt = matmul_dtype(ctx.config, q_in.dtype)
        q = self._project(q_in, "wq", "bq", cdt)
        k = self._project(k_in, "wk", "bk", cdt)
        v = self._project(v_in, "wv", "bv", cdt)
        return [self._decode_step(ctx, q, k, v, 1.0 / math.sqrt(q.shape[-1]))]

    def flops(self) -> float:
        q, k, v, embed, heads, kdim, vdim = self._dims()
        b, lq, lk = q.dims[0], q.dims[1], k.dims[1]
        proj = 2.0 * b * heads * (lq * q.dims[-1] * kdim
                                  + lk * k.dims[-1] * kdim
                                  + lk * v.dims[-1] * vdim
                                  + lq * vdim * embed)
        return proj + 2.0 * b * heads * lq * lk * (kdim + vdim)

    def _dropout(self, ctx) -> float:
        """The probabilities' dropout rate of this walk: 0 outside
        training."""
        if ctx.mode != CompMode.COMP_MODE_TRAINING:
            return 0.0
        return float(self.params.get("dropout", 0.0))

    def _use_flash(self, ctx, device) -> bool:
        """The `attention` family through the registry: the op's use_flash
        param first, then override and knob, then auto with the
        score-bytes crossover as its size policy, and only where the
        kernels take the head dim in the compute dtype (`flash_fits`: bf16
        needs a multiple of 8; MoeConfig()'s 64 wide over 16 heads, a head
        dim of 4, stays on the einsum core, as the JAX crossover keeps
        such small scores there)."""
        def crossover() -> bool:
            q, k = self.inputs[0], self.inputs[1]
            cdt = matmul_dtype(ctx.config, torch.float32)
            return flash_fits(cdt, self._dims()[5]) and flash_crossover(
                q.dims[0], self.params["num_heads"], q.dims[1], k.dims[1])

        return bool(KERNELS.resolve(
            self.kernel_memo, "attention", config=ctx.config, device=device,
            param=self.params.get("use_flash"), heuristic=crossover))

    def _full_sequence(self, ctx, q_in, k_in, v_in):
        """The kernel tier: the JAX package's packed flash branch, (b, l,
        h*d) projections with no transposes around the kernel, or on a
        tensor-parallel mesh the head-separated branch. The reference: its
        einsum core."""
        fill = ctx.fill_kv_cache and self.name in ctx.state
        if ctx.mesh is not None and ctx.mesh.size("model") > 1:
            return self._head_separated(ctx, q_in, k_in, v_in)
        _, _, _, embed, _, kdim, vdim = self._dims()
        cdt = matmul_dtype(ctx.config, q_in.dtype)
        q = self._project(q_in, "wq", "bq", cdt)
        k = self._project(k_in, "wk", "bk", cdt)
        v = self._project(v_in, "wv", "bv", cdt)
        # the heads this op's weights hold: all of them, or a head-sharded
        # copy's local ones (the cost model's measurement of a TP shard,
        # search/simulator.py OpCostCache, whose output is that shard's
        # partial sum)
        heads = q.shape[2]
        if fill:
            self._fill_caches(ctx, k, v)
        scale = 1.0 / math.sqrt(kdim)
        causal = self.params.get("causal", False)
        rate = self._dropout(ctx)
        if self._use_flash(ctx, q_in.device) and not rate and kdim == vdim:
            ctxv = flash_attention(
                q.flatten(2), k.flatten(2), v.flatten(2), heads, scale=scale,
                causal=causal, block_q=ctx.config.flash_block_q,
                block_k=ctx.config.flash_block_k)
        else:
            ctxv = self._einsum_core(q, k, v, scale, causal, cdt, rate,
                                     keep=self._keep(ctx, q, k, rate)
                                     ).flatten(2)
        odt = emit_dtype(ctx.config, self.outputs[0].dtype)
        out = torch.matmul(ctxv.to(cdt),
                           self.w("wo", cdt).reshape(heads * vdim, embed))
        out = out.to(odt)
        if self.has_weight("bo"):
            out = out + self.w("bo", odt)
        return out

    def _head_separated(self, ctx, q_in, k_in, v_in):
        """This rank's heads (JAX `ops/attention.py:160-175, 205-288`):
        head-separated projections; on a `seq` axis ring or Ulysses
        attention over this rank's positions, else the head-separated
        flash kernel or the einsum core; the local part of `wo`, then the
        sum over the model group and bo."""
        _, _, _, embed, _, kdim, vdim = self._dims()
        rate = self._dropout(ctx)
        if self.tp_degree > 1:
            group = ctx.mesh.group("model")
            entered = {}
            for t in (q_in, k_in, v_in):  # self-attention: one entry
                if id(t) not in entered:
                    entered[id(t)] = enter_tp(t, group)
            q_in, k_in, v_in = (entered[id(t)] for t in (q_in, k_in, v_in))
        cdt = matmul_dtype(ctx.config, q_in.dtype)
        q = self._project(q_in, "wq", "bq", cdt)            # (b, l, h/tp, d)
        k = self._project(k_in, "wk", "bk", cdt)
        v = self._project(v_in, "wv", "bv", cdt)
        if ctx.fill_kv_cache and self.name in ctx.state:
            self._fill_caches(ctx, k, v)  # this rank's heads
        scale = 1.0 / math.sqrt(kdim)
        causal = self.params.get("causal", False)
        if self._seq_parallel(ctx):
            ctxv = self._sp_core(ctx, q, k, v, scale, causal,
                                 kdim == vdim)
        elif self._use_flash(ctx, q_in.device) and not rate \
                and kdim == vdim:
            ctxv = flash_attention_heads(
                q, k, v, scale=scale, causal=causal,
                block_q=ctx.config.flash_block_q,
                block_k=ctx.config.flash_block_k, layout="blhd")
        else:
            ctxv = self._einsum_core(q, k, v, scale, causal, cdt, rate,
                                     keep=self._keep(ctx, q, k, rate))
        local = ctxv.shape[2] * vdim
        out = torch.matmul(ctxv.to(cdt).reshape(*ctxv.shape[:2], local),
                           self.w("wo", cdt).reshape(local, embed))
        if self.tp_degree > 1:
            out = reduce_sum(out.float(), ctx.mesh.group("model"))
        odt = emit_dtype(ctx.config, self.outputs[0].dtype)
        out = out.to(odt)
        if self.has_weight("bo"):
            out = out + self.w("bo", odt)
        return out

    def _fill_caches(self, ctx, k, v) -> None:
        """A prefill's K/V rows (b, l, h, d) into cache rows [0, l), at
        most as many as the cache holds; on a mesh the rank's rows and
        heads into its own caches (kvpool.py `local_kv_cache_spec`)."""
        kc = ctx.state[self.name]["k_cache"]
        vc = ctx.state[self.name]["v_cache"]
        if kc.shape[0] != k.shape[0] or kc.shape[2] != k.shape[2]:
            raise ValueError(
                f"{self.name}: the caches hold {kc.shape[0]} rows of "
                f"{kc.shape[2]} heads, the walk {k.shape[0]} rows of "
                f"{k.shape[2]} heads (on a mesh the caches take the "
                "rank's local geometry, kvpool.local_kv_cache_spec)")
        n = min(k.shape[1], kc.shape[1])
        kc[:, :n] = k[:, :n].to(kc.dtype)
        vc[:, :n] = v[:, :n].to(vc.dtype)

    def _keep(self, ctx, q, k, rate):
        """The walk's dropout keep mask for this rank's (b, h, lq, lk)
        probabilities: drawn at the op's whole (B, H, Lq, Lk) shape from
        the walk's generator, then cut to this rank's batch rows (when the
        walk's inputs are cut over `data`) and heads (over `model`); None
        at rate 0."""
        if not rate:
            return None
        cuts = {0: "data"} if ctx.in_cuts and "data" in ctx.in_cuts[0] \
            else {}
        if self.tp_degree > 1:
            cuts[1] = "model"
        return global_keep(ctx, (q.shape[0], q.shape[2], q.shape[1],
                                 k.shape[1]), rate, cuts, q.device)

    def _sp_core(self, ctx, q, k, v, scale, causal, same_dims):
        """Attention over the whole sequence from this rank's (b, l/s, h,
        d) blocks, by `sequence_parallel_mode` (JAX `ops/attention.py:
        205-232`)."""
        mode = self.params.get("sequence_parallel_mode", "ring")
        if mode in ("ulysses", "all_to_all"):
            return ulysses_attention(
                q, k, v, ctx.mesh, "seq", causal=causal, scale=scale,
                use_flash=self._use_flash(ctx, q.device) and same_dims,
                block_q=ctx.config.flash_block_q,
                block_k=ctx.config.flash_block_k)
        if mode == "ring":
            return ring_attention(q, k, v, ctx.mesh, "seq", causal=causal,
                                  scale=scale)
        raise ValueError(f"unknown sequence_parallel_mode {mode!r}: "
                         "expected 'ring' or 'ulysses'")

    def _seq_parallel(self, ctx) -> bool:
        """Whether this walk runs the sequence-parallel kernels: the op is
        cut over a `seq` axis (`Op.seq_local`). An op asked for them
        (`sequence_parallel`) whose positions do not divide over the axis
        raises, as the JAX kernels do."""
        if ctx.mesh is None or ctx.mesh.size("seq") == 1:
            return False
        if self.seq_local:
            return True
        if self.params.get("sequence_parallel"):
            sp = ctx.mesh.size("seq")
            if self.params.get("sequence_parallel_mode") in (
                    "ulysses", "all_to_all"):
                check_ulysses(self.params["num_heads"],
                              self.inputs[0].dims[1], sp)
            raise ValueError(
                f"sequence length {self.inputs[0].dims[1]} not divisible by "
                f"'seq' axis size {sp}")
        return False

    @staticmethod
    def _einsum_core(q, k, v, scale, causal, cdt, rate=0.0, generator=None,
                     keep=None):
        """The JAX package's reference core on (b, l, h, d): f32 logits
        (the products of the compute-dtype values, summed in f32), the
        causal mask, an f32 softmax, the context in the compute dtype.
        With `rate` > 0 the probabilities are dropped out first: kept
        where `keep` (a (b, h, lq, lk) bool mask, else drawn from
        `generator`) and divided by 1 - rate."""
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
            * scale
        if causal:
            lq, lk = logits.shape[-2], logits.shape[-1]
            mask = torch.ones((lq, lk), dtype=torch.bool,
                              device=q.device).tril(lk - lq)
            logits = torch.where(mask, logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        if rate:
            if keep is None:
                keep = dropout_keep(probs, rate, generator)
            probs = apply_dropout(probs, keep, rate)
        return torch.einsum("bhqk,bkhd->bqhd", probs.to(cdt), v)

    def _decode_step(self, ctx, q, k, v, scale):
        """Write the new tokens' K/V rows into the caches, then attend:
        per-slot positions (vector, C >= 1) or a chunk offset (0-d,
        C >= 1)."""
        pos = ctx.decode_pos
        kc = ctx.state[self.name]["k_cache"]
        vc = ctx.state[self.name]["v_cache"]
        b, c = q.shape[0], q.shape[1]
        block_k = ctx.config.flash_block_k
        vector = pos.dim() == 1
        if vector:
            slots, rows, src = _slot_rows(ctx, pos, c, kc.shape[1])
            if c > 1:  # C = 1: the source is the step's only row
                k, v = k[slots, src], v[slots, src]
            kc.index_put_((slots, rows), k.to(kc.dtype))
            vc.index_put_((slots, rows), v.to(vc.dtype))
            family = "attention_decode" if c == 1 else "attention_decode_mq"
            if q.shape[-1] == v.shape[-1] and KERNELS.resolve(
                    self.kernel_memo, family, config=ctx.config,
                    device=kc.device):
                fn = decode_attention if c == 1 \
                    else multiquery_decode_attention
                ctxv = fn(q, kc, vc, pos, scale=scale, block_k=block_k)
                return self._decode_project(ctx, ctxv, q.dtype)
            qpos = pos.long()[:, None] + torch.arange(
                c, device=kc.device)[None, :]                # (B, C)
        else:
            rows, src = _chunk_rows(ctx, pos, c, kc.shape[1])
            kc.index_copy_(1, rows, k[:, src].to(kc.dtype))
            vc.index_copy_(1, rows, v[:, src].to(vc.dtype))
            if q.shape[-1] == v.shape[-1] and KERNELS.resolve(
                    self.kernel_memo, "attention_decode_mq",
                    config=ctx.config, device=kc.device):
                posv = pos.reshape(1).expand(b).contiguous()
                ctxv = multiquery_decode_attention(q, kc, vc, posv,
                                                   scale=scale,
                                                   block_k=block_k)
                return self._decode_project(ctx, ctxv, q.dtype)
            qpos = pos.long() + torch.arange(c, device=kc.device)[None, :]
        # the JAX package's einsum decode chain: query j attends cache rows
        # <= its absolute position, over the whole cache
        mask = (torch.arange(kc.shape[1], device=kc.device)[None, None, :]
                <= qpos[:, :, None])[:, None]                # (B|1, 1, C, M)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                              kc.to(q.dtype).float()) * scale
        logits = torch.where(mask, logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        ctxv = torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype),
                            vc.to(q.dtype))
        return self._decode_project(ctx, ctxv, q.dtype)

    def _decode_project(self, ctx, ctxv, cdt):
        """Output projection: the product in the compute dtype, cast to the
        DECLARED output dtype, then bo added (as the JAX decode path). On
        a `model` axis the local heads' products are summed over the
        group in f32 first, so bo is added once."""
        b, c, h, d = ctxv.shape
        wo = self.w("wo", cdt)
        out = torch.matmul(ctxv.to(cdt).reshape(b, c, h * d),
                           wo.reshape(h * d, wo.shape[-1]))
        if self.tp_degree > 1:
            out = reduce_sum(out.float(), ctx.mesh.group("model"))
        out = out.to(self.outputs[0].dtype.torch_dtype)
        if self.has_weight("bo"):
            out = out + self.w("bo")
        return out


def _chunk_rows(ctx, off: torch.Tensor, c: int, m: int):
    """Cache rows and source rows of a chunk at the 0-d device offset
    `off`, made once a walk (every cache of a walk has m rows): query j
    writes row off + j; a row past the cache edge is aimed at row m - 1
    with the source of row m - 1 (which the chunk holds whenever 0 <= off
    < m), so every write a row takes carries the same value and the rows
    past the edge are dropped."""
    if ctx.chunk_rows is None:
        j = torch.arange(c, device=off.device)
        rows = (off.long() + j).clamp(max=m - 1)
        ctx.chunk_rows = (rows, (rows - off.long()).clamp(0, c - 1))
    return ctx.chunk_rows


def _slot_rows(ctx, pos: torch.Tensor, c: int, m: int):
    """(slot, cache row, source row) indices, each (B, C), of per-slot
    positions `pos` (B,) with C queries, made once a walk: slot i's query
    j writes row pos[i] + j; a row past the cache edge is aimed at row
    m - 1 with the source of row m - 1, or with source 0 where pos[i] >= m
    (the walk holds no source of row m - 1), so every write a row takes
    in one call carries the same value."""
    if ctx.chunk_rows is None:
        p = pos.long()[:, None]
        rows = (p + torch.arange(c, device=pos.device)[None, :]).clamp(
            max=m - 1)
        slots = torch.arange(pos.shape[0], device=pos.device)[:, None]
        ctx.chunk_rows = (slots, rows, (rows - p).clamp(0, c - 1))
    return ctx.chunk_rows
