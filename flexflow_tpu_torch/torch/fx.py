"""Serialize a torch.fx symbolic trace to the .ff interchange format (the
port's copy of flexflow_tpu/torch/fx.py: the same records for the same
module, so a .ff file written by either package loads in the other).

The format is JSON-lines: one record per fx node {name, op, target, args,
kwargs, module}, where `module` captures the constructor config of
call_module targets and `tensor` the value of get_attr targets.
HuggingFace models trace through transformers.utils.fx, imported only
when such a model is traced.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List

import numpy as np


def _module_spec(mod) -> Dict[str, Any]:
    import torch.nn as nn

    t = type(mod).__name__
    spec: Dict[str, Any] = {"type": t}
    if isinstance(mod, nn.Linear):
        spec.update(in_features=mod.in_features, out_features=mod.out_features,
                    bias=mod.bias is not None)
    elif isinstance(mod, nn.Conv2d):
        spec.update(
            in_channels=mod.in_channels, out_channels=mod.out_channels,
            kernel_size=list(mod.kernel_size), stride=list(mod.stride),
            padding=list(mod.padding) if not isinstance(mod.padding, str) else mod.padding,
            groups=mod.groups, bias=mod.bias is not None,
        )
    elif isinstance(mod, (nn.MaxPool2d, nn.AvgPool2d)):
        def pair(v):
            return list(v) if isinstance(v, (tuple, list)) else [v, v]
        spec.update(kernel_size=pair(mod.kernel_size),
                    stride=pair(mod.stride or mod.kernel_size),
                    padding=pair(mod.padding))
    elif isinstance(mod, nn.AdaptiveAvgPool2d):
        out = mod.output_size
        spec.update(output_size=list(out) if isinstance(out, (tuple, list)) else [out, out])
    elif isinstance(mod, (nn.BatchNorm2d, nn.BatchNorm1d)):
        spec.update(num_features=mod.num_features)
    elif isinstance(mod, nn.LayerNorm):
        spec.update(normalized_shape=list(mod.normalized_shape), eps=mod.eps,
                    elementwise_affine=mod.elementwise_affine)
    elif isinstance(mod, nn.Embedding):
        spec.update(num_embeddings=mod.num_embeddings, embedding_dim=mod.embedding_dim)
    elif isinstance(mod, nn.Dropout):
        spec.update(p=mod.p)
    elif isinstance(mod, nn.Softmax):
        spec.update(dim=mod.dim)
    elif isinstance(mod, nn.Flatten):
        spec.update(start_dim=mod.start_dim, end_dim=mod.end_dim)
    elif isinstance(mod, nn.MultiheadAttention):
        spec.update(embed_dim=mod.embed_dim, num_heads=mod.num_heads,
                    dropout=mod.dropout, batch_first=mod.batch_first)
    # parameterless activations etc. carry only their type name
    return spec


def _encode_arg(a) -> Any:
    import torch.fx as tfx

    if isinstance(a, tfx.Node):
        return {"node": a.name}
    if isinstance(a, slice):
        # bounds may themselves be traced nodes (size arithmetic)
        return {"slice": [_encode_arg(a.start), _encode_arg(a.stop),
                          _encode_arg(a.step)]}
    if isinstance(a, (list, tuple)):
        return [_encode_arg(x) for x in a]
    if isinstance(a, dict):
        return {k: _encode_arg(v) for k, v in a.items()}
    if a is None or isinstance(a, (bool, int, float, str)):
        return a
    import torch

    if isinstance(a, torch.dtype):
        return {"dtype": str(a)}
    return {"repr": repr(a)}


def trace_to_records(model, tracer_cls=None,
                     input_names=None) -> List[Dict[str, Any]]:
    """Symbolically trace a torch module into .ff records.

    HuggingFace models (transformers PreTrainedModel) go through
    transformers.utils.fx.symbolic_trace, which handles their dynamic
    control flow; input_names selects the traced signature (e.g.
    ["input_ids"])."""
    import torch.fx as tfx

    if tracer_cls is not None:
        graph = tracer_cls().trace(model)
        traced = tfx.GraphModule(model, graph)
    elif type(model).__module__.startswith("transformers."):
        from transformers.utils import fx as hf_fx

        traced = hf_fx.symbolic_trace(
            model, input_names=list(input_names) if input_names else None)
    else:
        traced = tfx.symbolic_trace(model)
    modules = dict(traced.named_modules())
    records = []
    for node in traced.graph.nodes:
        rec: Dict[str, Any] = {
            "name": node.name,
            "op": node.op,
            "target": node.target if isinstance(node.target, str) else getattr(
                node.target, "__name__", str(node.target)
            ),
            "args": _encode_arg(list(node.args)),
            "kwargs": _encode_arg(dict(node.kwargs)),
        }
        if node.op == "call_function":
            mod_name = getattr(node.target, "__module__", "") or ""
            rec["target_module"] = mod_name
        if node.op == "call_module":
            rec["module"] = _module_spec(modules[node.target])
        if node.op == "get_attr":
            # direct parameter/buffer access: capture the tensor value so
            # the importer can materialize it as a constant (buffers) or a
            # trainable parameter
            val, trainable = _fetch_attr(traced, node.target)
            val = val.detach().cpu()
            import torch

            if val.dtype == torch.bfloat16:  # numpy has no bf16
                val = val.float()
            arr = val.numpy()
            rec["tensor"] = {
                "shape": list(arr.shape),
                "dtype": str(arr.dtype),
                "trainable": trainable,
            }
            if arr.size <= 65536:
                rec["tensor"]["data"] = arr.tolist()
            else:  # large params (tied embeddings etc.): raw bytes, not
                # a 25x-bloated Python list
                import base64

                rec["tensor"]["data_b64"] = base64.b64encode(
                    np.ascontiguousarray(arr).tobytes()).decode("ascii")
        records.append(rec)
    return records


def _fetch_attr(mod, target: str):
    """Resolve a dotted get_attr target; returns (tensor, trainable)."""
    import torch

    obj = mod
    for part in target.split("."):
        obj = getattr(obj, part)
    trainable = isinstance(obj, torch.nn.Parameter) and obj.requires_grad
    return obj, trainable


def torch_to_flexflow(model, filename: str, tracer_cls=None) -> str:
    """Trace `model` and write the .ff file (one JSON record per line)."""
    records = trace_to_records(model, tracer_cls=tracer_cls)
    with open(filename, "w") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")
    return filename


def load_ff_file(filename: str) -> List[Dict[str, Any]]:
    with open(filename) as f:
        return [json.loads(line) for line in f if line.strip()]
