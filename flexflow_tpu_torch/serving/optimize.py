"""Inference-graph optimizations applied at serving time (counterpart of
flexflow_tpu/serving/optimize.py).

Serving folds batchnorm into the preceding conv; training keeps BN live.
fold_batchnorm() rewrites BOTH the graph (BN dropped, consumers rewired)
and the parameters (conv kernel/bias scaled with the BN's eval-mode
statistics):

    y = gamma * (conv(x) - mean) / sqrt(var + eps) + beta
      = conv'(x)   with  k' = k * s,  b' = (b - mean) * s + beta,
                         s = gamma / sqrt(var + eps)   (per out-channel)

The port keeps the weights in the ops (`Op._parameters`), so the fold
writes k' and b' into the conv's own parameters, computed in f32 and
stored in the weight's dtype; a conv built with `use_bias=False` gains a
bias parameter (and its weight spec and handle). The executor and the
step functions are rebuilt over the folded graph, so an InferenceModel
(serving/model.py) captures its buckets anew.
"""
from __future__ import annotations

from typing import List

import torch
from torch import nn

from ..core.op import WeightSpec
from ..core.tensor import Tensor
from ..ffconst import ActiMode, OpType
from ..runtime.initializers import ZeroInitializer


def _add_bias(conv, value: torch.Tensor) -> None:
    """Give a bias-less conv a bias parameter holding `value`, with the
    spec and handle a conv built with `use_bias=True` has."""
    kernel = conv._parameters["kernel"]
    kspec = next(ws for ws in conv.specs if ws.name == "kernel")
    ws = WeightSpec("bias", (kernel.shape[0],), kspec.dtype,
                    ZeroInitializer())
    conv.specs.append(ws)
    handle = Tensor(ws.dims, ws.dtype, name=f"{conv.name}.bias",
                    owner_op=conv)
    handle._weight_spec = ws
    conv.weights.append(handle)
    conv.register_parameter("bias", nn.Parameter(
        value.to(kernel.dtype).contiguous(),
        requires_grad=kernel.requires_grad))


def fold_batchnorm(model) -> List[str]:
    """Fold eval-mode BatchNorm into the preceding Conv2D. Call on a
    COMPILED model before serving; rebuilds the executor. Returns the names
    of the folded BN ops. BNs whose conv has other consumers, or that
    follow a non-conv, are left alone. A BN with relu=True transfers its
    relu to the conv's activation. The model refuses to train afterwards
    (`fit`, `backward` and `update` raise "optimized for inference")."""
    from ..runtime.executor import Executor
    from ..search.substitution import _rewire

    if model.executor is None:
        raise RuntimeError("fold_batchnorm needs compile() first")
    graph = model.graph
    folded: List[str] = []
    for bn in list(graph.ops.values()):
        if bn.op_type != OpType.BATCHNORM:
            continue
        conv = bn.inputs[0].owner_op
        if (conv is None or conv.op_type != OpType.CONV2D
                or conv.guid not in graph.ops):
            continue
        # the conv must feed ONLY this BN (its output disappears)
        consumers = [
            o for o in graph.ops.values()
            if any(t.guid == conv.outputs[0].guid for t in o.inputs)
        ]
        if consumers != [bn]:
            continue
        if conv.params.get("activation",
                           ActiMode.AC_MODE_NONE) != ActiMode.AC_MODE_NONE:
            continue  # activation between conv and BN: not foldable

        eps = bn.params.get("eps", 1e-5)
        with torch.no_grad():
            gamma = bn.w("gamma").float()
            beta = bn.w("beta").float()
            mean = bn.running_mean.float()
            var = bn.running_var.float()
            scale = gamma / torch.sqrt(var + eps)  # (C_out,)
            kernel = conv._parameters["kernel"]  # OIHW
            kernel.copy_((kernel.float() * scale[:, None, None, None]).to(
                kernel.dtype))
            if conv.has_weight("bias"):
                bias = conv._parameters["bias"]
                bias.copy_(((bias.float() - mean) * scale + beta).to(
                    bias.dtype))
            else:
                _add_bias(conv, (-mean) * scale + beta)
        conv._cast.clear()
        conv.params["use_bias"] = True
        if bn.params.get("relu", False):
            conv.params["activation"] = ActiMode.AC_MODE_RELU

        # rewire BN consumers onto the conv output and drop the BN
        _rewire(graph, bn.outputs[0], conv.outputs[0])
        if model.final_tensor is not None \
                and model.final_tensor.guid == bn.outputs[0].guid:
            model.final_tensor = conv.outputs[0]
        graph.remove_op(bn)
        model.ops = [op for op in model.ops if op.guid != bn.guid]
        folded.append(bn.name)

    if folded:
        # rebuild every inference-mode path over the folded graph (predict,
        # eval, and the manual forward), then disarm the training paths:
        # training a folded model is nonsense (BN semantics baked in), and
        # fit()/backward()/update() refuse via the flag
        model.executor = Executor(graph, model.config, model.mesh)
        model._build_steps()
        model._train_step = model._grad_step = None
        model._inference_only = "fold_batchnorm"
    return folded
