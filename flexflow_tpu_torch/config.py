"""Runtime configuration: the FFConfig fields the ported slices read.

Counterpart of flexflow_tpu/config.py FFConfig. The search and mesh flags
arrive with their slices; `device` is new — the port runs on one explicit
torch device, CUDA unless the caller asks for the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence


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
    # kernel tier (kernels/registry.py): auto, pallas (the CUDA kernels),
    # reference, or family=impl[,...]
    kernel_impl: str = "auto"

    def parse_args(self, argv: Sequence[str]) -> None:
        """Set fields from the JAX package's flag spellings of the fields
        the port has; any other flag raises ValueError naming it."""
        args = list(argv)
        i = 0

        def take() -> str:
            nonlocal i
            i += 1
            if i >= len(args):
                raise ValueError(f"flag {args[i - 1]!r} requires a value")
            return args[i]

        while i < len(args):
            a = args[i]
            if a in ("-b", "--batch-size"):
                self.batch_size = int(take())
            elif a in ("-e", "--epochs"):
                self.epochs = int(take())
            elif a in ("--lr", "--learning-rate"):
                self.learning_rate = float(take())
            elif a == "--flash-block-q":
                self.flash_block_q = int(take())
            elif a == "--flash-block-k":
                self.flash_block_k = int(take())
            elif a == "--kernel-impl":
                v = take()
                from .kernels.registry import KernelRegistry

                KernelRegistry.parse_spec(v)  # raises on a bad spec
                self.kernel_impl = v
            else:
                raise ValueError(f"flag {a!r} is not ported (flags: "
                                 "--batch-size, --epochs, --learning-rate, "
                                 "--flash-block-q, --flash-block-k, "
                                 "--kernel-impl)")
            i += 1
