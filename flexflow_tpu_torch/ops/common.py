"""Shared helpers for op lowerings (counterpart of flexflow_tpu/ops/common.py)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ffconst import ActiMode


def apply_activation(x, activation: ActiMode):
    if activation is None or activation == ActiMode.AC_MODE_NONE:
        return x
    if activation == ActiMode.AC_MODE_RELU:
        return torch.relu(x)
    if activation == ActiMode.AC_MODE_SIGMOID:
        return torch.sigmoid(x)
    if activation == ActiMode.AC_MODE_TANH:
        return torch.tanh(x)
    if activation == ActiMode.AC_MODE_GELU:
        # jax.nn.gelu defaults to the tanh approximation
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {activation}")


def matmul_dtype(config, dtype: torch.dtype) -> torch.dtype:
    """bfloat16 matmul inputs (f32 accumulation) when mixed precision is
    on and the value is f32."""
    if config is not None and config.allow_mixed_precision \
            and dtype == torch.float32:
        return torch.bfloat16
    return dtype


def emit_dtype(config, declared) -> torch.dtype:
    """dtype an op's output is stored in at the graph boundary: under mixed
    precision f32 activations are stored bf16, while parameters stay f32
    and statistics still compute in f32. The executor applies this cast to
    every op output (runtime/executor.py)."""
    dt = declared.torch_dtype if hasattr(declared, "torch_dtype") \
        else declared
    return matmul_dtype(config, dt)
