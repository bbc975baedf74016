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
that dtype. Attention dropout and sequence parallelism are not ported and
raise.

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
for C = 1 with a position vector, `attention_decode_mq` for a chunk
offset) or, when the kernel is not selected, through the JAX package's
einsum decode chain over the whole cache. Two entries, as `_decode_step`
in the JAX package:
 - a (B,) int32 tensor of per-slot positions with one query token per
   slot: the continuous batcher's decode iteration;
 - an int chunk offset with C >= 1 query tokens: chunked prefill. The
   chunk's K/V rows land at [pos, pos + C) and query j attends rows
   <= pos + j. Rows past the cache edge are DROPPED, where JAX's
   `dynamic_update_slice` would clamp the start and shift the chunk; the
   JAX batcher keeps chunk - 1 slack rows so that its clamp never fires,
   the port writes the pool slot directly and drops the padded tail.
"""
from __future__ import annotations

import math
from typing import List

import torch

from ..core.op import Op, WeightSpec, register_op
from ..ffconst import OpType
from ..kernels.decode import decode_attention, multiquery_decode_attention
from ..kernels.flash_attention import flash_attention, flash_attention_heads
from ..kernels.registry import KERNELS, flash_crossover
from ..runtime.collectives import enter_tp, reduce_sum
from ..runtime.initializers import DefaultInitializer, ZeroInitializer
from .common import emit_dtype, matmul_dtype

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
        q, _, _, embed, _, kdim, vdim = self._dims()
        if kdim != vdim:
            raise NotImplementedError(
                f"kdim={kdim} != vdim={vdim}: the attention kernels take "
                "one head_dim")
        if self.params.get("dropout", 0.0) > 0:
            raise NotImplementedError(
                f"{self.name}: attention-probability dropout is not ported "
                "(the flash kernel has none); set dropout=0")
        if self.params.get("sequence_parallel"):
            raise NotImplementedError(
                f"{self.name}: sequence-parallel attention (ring / Ulysses) "
                "is not ported yet (ROADMAP A8); the port runs one device")
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
            return [self._full_sequence(ctx, *inputs[:3])]
        if self.name not in ctx.state:
            raise ValueError(f"{self.name}: decode_pos given but no KV "
                             "caches in the state")
        if ctx.mesh is not None:
            raise NotImplementedError(
                f"{self.name}: KV-cache decoding on a mesh (sharded "
                "serving) is not ported yet (ROADMAP A8)")
        q_in, k_in, v_in = inputs[:3]
        cdt = matmul_dtype(ctx.config, q_in.dtype)
        q = self._project(q_in, "wq", "bq", cdt)
        k = self._project(k_in, "wk", "bk", cdt)
        v = self._project(v_in, "wv", "bv", cdt)
        return [self._decode_step(ctx, q, k, v, 1.0 / math.sqrt(q.shape[-1]))]

    def _use_flash(self, ctx, device) -> bool:
        """The `attention` family through the registry: the op's use_flash
        param first, then override and knob, then auto with the
        score-bytes crossover as its size policy."""
        def crossover() -> bool:
            q, k = self.inputs[0], self.inputs[1]
            return flash_crossover(q.dims[0], self.params["num_heads"],
                                   q.dims[1], k.dims[1])

        return bool(KERNELS.resolve(
            self.kernel_memo, "attention", config=ctx.config, device=device,
            param=self.params.get("use_flash"), heuristic=crossover))

    def _full_sequence(self, ctx, q_in, k_in, v_in):
        """The kernel tier: the JAX package's packed flash branch, (b, l,
        h*d) projections with no transposes around the kernel, or on a
        tensor-parallel mesh the head-separated branch. The reference: its
        einsum core."""
        if ctx.mesh is not None and ctx.mesh.size("model") > 1:
            return self._tensor_parallel(ctx, q_in, k_in, v_in)
        _, _, _, embed, heads, kdim, vdim = self._dims()
        cdt = matmul_dtype(ctx.config, q_in.dtype)
        q = self._project(q_in, "wq", "bq", cdt)
        k = self._project(k_in, "wk", "bk", cdt)
        v = self._project(v_in, "wv", "bv", cdt)
        scale = 1.0 / math.sqrt(kdim)
        causal = self.params.get("causal", False)
        if self._use_flash(ctx, q_in.device):
            ctxv = flash_attention(
                q.flatten(2), k.flatten(2), v.flatten(2), heads, scale=scale,
                causal=causal, block_q=ctx.config.flash_block_q,
                block_k=ctx.config.flash_block_k)
        else:
            ctxv = self._einsum_core(q, k, v, scale, causal, cdt).flatten(2)
        odt = emit_dtype(ctx.config, self.outputs[0].dtype)
        out = torch.matmul(ctxv.to(cdt),
                           self.w("wo", cdt).reshape(heads * vdim, embed))
        out = out.to(odt)
        if self.has_weight("bo"):
            out = out + self.w("bo", odt)
        return out

    def _tensor_parallel(self, ctx, q_in, k_in, v_in):
        """This rank's heads (JAX `ops/attention.py:160-175, 245-288`):
        head-separated projections, the head-separated flash kernel or
        the einsum core, the local part of `wo`, then the sum over the
        model group and bo."""
        _, _, _, embed, _, kdim, vdim = self._dims()
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
        scale = 1.0 / math.sqrt(kdim)
        causal = self.params.get("causal", False)
        if self._use_flash(ctx, q_in.device):
            ctxv = flash_attention_heads(
                q, k, v, scale=scale, causal=causal,
                block_q=ctx.config.flash_block_q,
                block_k=ctx.config.flash_block_k, layout="blhd")
        else:
            ctxv = self._einsum_core(q, k, v, scale, causal, cdt)
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

    @staticmethod
    def _einsum_core(q, k, v, scale, causal, cdt):
        """The JAX package's reference core on (b, l, h, d): f32 logits
        (the products of the compute-dtype values, summed in f32), the
        causal mask, an f32 softmax, the context in the compute dtype."""
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
            * scale
        if causal:
            lq, lk = logits.shape[-2], logits.shape[-1]
            mask = torch.ones((lq, lk), dtype=torch.bool,
                              device=q.device).tril(lk - lq)
            logits = torch.where(mask, logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", probs.to(cdt), v)

    def _decode_step(self, ctx, q, k, v, scale):
        """Write the new tokens' K/V rows into the caches, then attend:
        per-slot positions (vector, C = 1) or a chunk offset (int, C >= 1)."""
        pos = ctx.decode_pos
        kc = ctx.state[self.name]["k_cache"]
        vc = ctx.state[self.name]["v_cache"]
        b, c = q.shape[0], q.shape[1]
        block_k = ctx.config.flash_block_k
        vector = torch.is_tensor(pos)
        if vector:
            if c != 1:
                raise NotImplementedError(
                    f"{self.name}: per-slot positions with C={c} query "
                    "tokens is speculative decoding's verify step, which "
                    "is not ported yet (ROADMAP A5)")
            rows = torch.arange(b, device=kc.device)
            idx = pos.long()
            kc.index_put_((rows, idx), k[:, 0].to(kc.dtype))
            vc.index_put_((rows, idx), v[:, 0].to(vc.dtype))
            if KERNELS.resolve(self.kernel_memo, "attention_decode",
                               config=ctx.config, device=kc.device):
                ctxv = decode_attention(q, kc, vc, pos, scale=scale,
                                        block_k=block_k)
                return self._decode_project(ctxv, q.dtype)
            qpos = pos.long()[:, None]                       # (B, C)
        else:
            off = int(pos)
            n = min(c, kc.shape[1] - off)
            kc[:, off:off + n] = k[:, :n].to(kc.dtype)
            vc[:, off:off + n] = v[:, :n].to(vc.dtype)
            if KERNELS.resolve(self.kernel_memo, "attention_decode_mq",
                               config=ctx.config, device=kc.device):
                posv = torch.full((b,), off, dtype=torch.int32,
                                  device=kc.device)
                ctxv = multiquery_decode_attention(q, kc, vc, posv,
                                                   scale=scale,
                                                   block_k=block_k)
                return self._decode_project(ctxv, q.dtype)
            qpos = off + torch.arange(c, device=kc.device)[None, :]
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
        return self._decode_project(ctxv, q.dtype)

    def _decode_project(self, ctxv, cdt):
        """Output projection: the product in the compute dtype, cast to the
        DECLARED output dtype, then bo added (as the JAX decode path)."""
        b, c, h, d = ctxv.shape
        wo = self.w("wo", cdt)
        out = torch.matmul(ctxv.to(cdt).reshape(b, c, h * d),
                           wo.reshape(h * d, wo.shape[-1]))
        out = out.to(self.outputs[0].dtype.torch_dtype)
        if self.has_weight("bo"):
            out = out + self.w("bo")
        return out
