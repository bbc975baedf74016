"""Multi-head attention (counterpart of flexflow_tpu/ops/attention.py):
the full-sequence path and the KV-cache decoding half.

Weights keep the JAX package's names and layouts: wq/wk/wv (e, h, d),
wo (h, d, e), bq/bk/bv (h, d), bo (e). Projections and the output
projection are plain matmuls.

Full sequence (training, and inference without caches): the JAX
package's packed branch. q, k and v are projected with wq.reshape(e, h*d)
in the compute dtype to (b, l, h*d) and run through the flash-attention
kernel (kernels/flash_attention.py) in that layout, its backward a kernel
too; the context goes through wo.reshape(h*d, e), is cast to the output's
boundary dtype, and bo is added in that dtype. Attention dropout and
sequence parallelism are not ported and raise.

Decoding: the QK^T -> masked softmax -> V core runs through the port's
decode-attention kernel (kernels/decode.py) over the caches the caller
holds in `ctx.state[op name]`, updated in place. Two entries, as
`_decode_step` in the JAX package:
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
from ..kernels.flash_attention import flash_attention
from ..runtime.initializers import DefaultInitializer, ZeroInitializer
from .common import emit_dtype, matmul_dtype


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
        q_in, k_in, v_in = inputs[:3]
        cdt = matmul_dtype(ctx.config, q_in.dtype)
        q = self._project(q_in, "wq", "bq", cdt)
        k = self._project(k_in, "wk", "bk", cdt)
        v = self._project(v_in, "wv", "bv", cdt)
        return [self._decode_step(ctx, q, k, v, 1.0 / math.sqrt(q.shape[-1]))]

    def _full_sequence(self, ctx, q_in, k_in, v_in):
        """The JAX package's packed flash branch: (b, l, h*d) projections,
        no transposes around the kernel."""
        _, _, _, embed, heads, kdim, vdim = self._dims()
        cdt = matmul_dtype(ctx.config, q_in.dtype)
        q = self._project(q_in, "wq", "bq", cdt).flatten(2)
        k = self._project(k_in, "wk", "bk", cdt).flatten(2)
        v = self._project(v_in, "wv", "bv", cdt).flatten(2)
        ctxv = flash_attention(
            q, k, v, heads, scale=1.0 / math.sqrt(kdim),
            causal=self.params.get("causal", False),
            block_q=ctx.config.flash_block_q,
            block_k=ctx.config.flash_block_k)
        odt = emit_dtype(ctx.config, self.outputs[0].dtype)
        out = torch.matmul(ctxv.to(cdt),
                           self.w("wo", cdt).reshape(heads * vdim, embed))
        out = out.to(odt)
        if self.has_weight("bo"):
            out = out + self.w("bo", odt)
        return out

    def _decode_step(self, ctx, q, k, v, scale):
        """Write the new tokens' K/V rows into the caches, then attend:
        per-slot positions (vector, C = 1) or a chunk offset (int, C >= 1)."""
        pos = ctx.decode_pos
        kc = ctx.state[self.name]["k_cache"]
        vc = ctx.state[self.name]["v_cache"]
        b, c = q.shape[0], q.shape[1]
        block_k = ctx.config.flash_block_k
        if torch.is_tensor(pos):
            if c != 1:
                raise NotImplementedError(
                    f"{self.name}: per-slot positions with C={c} query "
                    "tokens is speculative decoding's verify step, which "
                    "is not ported yet (ROADMAP A5)")
            rows = torch.arange(b, device=kc.device)
            idx = pos.long()
            kc.index_put_((rows, idx), k[:, 0].to(kc.dtype))
            vc.index_put_((rows, idx), v[:, 0].to(vc.dtype))
            ctxv = decode_attention(q, kc, vc, pos, scale=scale,
                                    block_k=block_k)
        else:
            off = int(pos)
            n = min(c, kc.shape[1] - off)
            kc[:, off:off + n] = k[:, :n].to(kc.dtype)
            vc[:, off:off + n] = v[:, :n].to(vc.dtype)
            posv = torch.full((b,), off, dtype=torch.int32, device=kc.device)
            ctxv = multiquery_decode_attention(q, kc, vc, posv, scale=scale,
                                               block_k=block_k)
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
