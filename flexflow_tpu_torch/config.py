"""Runtime configuration: the FFConfig fields the serving and training
slices read.

Counterpart of flexflow_tpu/config.py FFConfig. The search and mesh flags
arrive with their slices; `device` is new — the port runs on one explicit
torch device, CUDA unless the caller asks for the CPU.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class FFConfig:
    batch_size: int = 64
    epochs: int = 1
    # SGD's learning rate when compile() is given no optimizer
    learning_rate: float = 0.01
    # bf16 matmul inputs and bf16 activations at op boundaries, f32
    # parameters and f32 statistics (ops/common.py)
    allow_mixed_precision: bool = True
    # query rows / key rows per shared-memory tile of the flash-attention
    # kernel, and cache rows per tile of the decode kernel; the kernels cap
    # them at their largest tile (kernels/flash_attention.py, decode.py)
    flash_block_q: int = 512
    flash_block_k: int = 512
    device: str = "cuda"
