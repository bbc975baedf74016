"""Runtime configuration: the FFConfig fields the serving slice reads.

Counterpart of flexflow_tpu/config.py FFConfig. The search, mesh and
training flags arrive with their slices; `device` is new — the port runs
on one explicit torch device, CUDA unless the caller asks for the CPU.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class FFConfig:
    batch_size: int = 64
    # bf16 matmul inputs and bf16 activations at op boundaries, f32
    # parameters and f32 statistics (ops/common.py)
    allow_mixed_precision: bool = True
    # cache rows the decode-attention kernel stages per shared-memory tile
    # (capped by the kernel, kernels/decode.py)
    flash_block_k: int = 512
    device: str = "cuda"
