"""LSTM (counterpart of flexflow_tpu/ops/rnn.py).

One layer over (batch, seq, input_dim): the input projection hoisted out
of the recurrence as one product over every step, in f32 from the
compute-dtype operands, the bias added once; then a loop over time of
the recurrent product (h cast to the compute dtype, the product summed
in f32) and the gate arithmetic in f32, gates in the order i, f, g, o,
h and c carried in f32. The JAX package runs the loop as a `lax.scan`;
here it is a Python loop of `torch.matmul` and elementwise ops (about
ten launches a step, forward), which a CUDA graph of training steps
replays without the host (runtime/executor.py MultiStep). Not
`nn.LSTM` / cuDNN's RNN: their two biases and their carry's dtype differ
from the JAX op's.
"""
from __future__ import annotations

from typing import List

import torch

from ..core.op import Op, WeightSpec, register_op
from ..ffconst import OpType
from ..runtime.initializers import DefaultInitializer, ZeroInitializer
from .common import matmul_dtype


@register_op
class LSTMOp(Op):
    """(batch, seq, input_dim) -> (batch, seq, hidden) with
    return_sequences (the default), else the last h, (batch, hidden)."""

    op_type = OpType.LSTM

    def output_shapes(self):
        (x,) = self.inputs
        b, s, _ = x.dims
        h = self.params["hidden_size"]
        if self.params.get("return_sequences", True):
            return [(b, s, h)], [x.dtype]
        return [(b, h)], [x.dtype]

    def weight_specs(self) -> List[WeightSpec]:
        (x,) = self.inputs
        h = self.params["hidden_size"]
        return [
            WeightSpec("kernel", (x.dims[-1], 4 * h), x.dtype,
                       DefaultInitializer()),
            WeightSpec("recurrent_kernel", (h, 4 * h), x.dtype,
                       DefaultInitializer()),
            WeightSpec("bias", (4 * h,), x.dtype, ZeroInitializer()),
        ]

    def lower(self, ctx, inputs):
        x = inputs[0]
        cdt = matmul_dtype(ctx.config, x.dtype)
        # compute-dtype values, multiplied and summed in f32 (JAX's
        # preferred_element_type=f32)
        wx = self.w("kernel", cdt).float()
        wh = self.w("recurrent_kernel", cdt).float()
        gates_x = torch.matmul(x.to(cdt).float(), wx) + self.w("bias").float()
        batch, seq = x.shape[0], x.shape[1]
        h = c = torch.zeros((batch, wh.shape[0]), dtype=torch.float32,
                            device=x.device)
        hs = []
        for t in range(seq):
            gates = gates_x[:, t] + torch.matmul(h.to(cdt).float(), wh)
            i, f, g, o = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            hs.append(h)
        out_dtype = self.outputs[0].dtype.torch_dtype
        if self.params.get("return_sequences", True):
            return [torch.stack(hs, dim=1).to(out_dtype)]
        return [h.to(out_dtype)]

    def flops(self) -> float:
        b, s, d = self.inputs[0].dims
        h = self.params["hidden_size"]
        return 2.0 * b * s * (d + h) * 4 * h
