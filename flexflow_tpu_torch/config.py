"""Runtime configuration: the FFConfig fields the ported slices read.

Counterpart of flexflow_tpu/config.py FFConfig. The cost model's flags
(the machine model, the fitted profile, the op-cost cache, the task-graph
export) are the JAX package's, with its defaults and spellings; the
search's and the mesh's arrive with their slices. `device` is new — the
port runs on one explicit torch device, CUDA unless the caller asks for
the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass
class FFConfig:
    batch_size: int = 64
    epochs: int = 1
    # the JAX package's fields of the same names and defaults: fit prints
    # StepStats' samples/s line every print_freq steps and its summary
    # under profiling (obs/stepstats.py); JAX's CLI passes
    # steps_per_execution to fit
    iterations: int = 1
    steps_per_execution: int = 1
    weight_decay: float = 0.0001
    print_freq: int = 10
    profiling: bool = False
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
    # seeds the training walk's random stream (dropout masks), as the JAX
    # package's `seed` seeds its per-step keys (runtime/executor.py)
    seed: int = 0
    # -- the cost model (search/machine_model.py, search/simulator.py,
    # obs/refit.py), the JAX package's fields and defaults --------------
    # chips the machine model prices (JAX `num_devices`); None: the
    # torch.distributed world when one is initialized, else 1
    num_devices: Optional[int] = None
    # 0: SimpleMachineModel, >= 1: TpuPodModel (the two-link ring)
    machine_model_version: int = 0
    # a machine spec file: a "tiers" list is hierarchical, else a topology
    machine_model_file: Optional[str] = None
    # a FittedProfile (obs/refit.py) overlaid on the machine model, whose
    # per-family residuals the kernel registry reads
    fitted_profile_file: Optional[str] = None
    # the registry's residual threshold when the profile fitted none.
    # In the port it labels a choice ("residual") and never changes one:
    # auto's no-evidence default is already the kernel (kernels/registry.py)
    kernel_residual_threshold: float = 1.10
    # OpCostCache's file of measured op costs (JSON)
    op_cost_cache_file: Optional[str] = None
    # compile() writes the cost-annotated task graph (dot) here
    export_strategy_task_graph_file: Optional[str] = None
    # the memory model's per-weight optimizer state (compile sets it from
    # the optimizer: Adam 3, SGD with momentum 2, plain SGD 1)
    optimizer_state_factor: float = 3.0
    # the simulator: gradient syncs overlap the backward; their bucket
    search_overlap_backward_update: bool = True
    grad_bucket_bytes: int = 25 * 1024 * 1024

    @property
    def total_devices(self) -> int:
        """Chips the cost model prices (JAX `total_devices`)."""
        if self.num_devices is not None:
            return int(self.num_devices)
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_world_size()
        return 1

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
            elif a in ("-i", "--iterations"):
                self.iterations = int(take())
            elif a == "--steps-per-execution":
                self.steps_per_execution = int(take())
            elif a in ("--lr", "--learning-rate"):
                self.learning_rate = float(take())
            elif a in ("--wd", "--weight-decay"):
                self.weight_decay = float(take())
            elif a == "--print-freq":
                self.print_freq = int(take())
            elif a == "--profiling":
                self.profiling = True
            elif a == "--flash-block-q":
                self.flash_block_q = int(take())
            elif a == "--flash-block-k":
                self.flash_block_k = int(take())
            elif a == "--seed":
                self.seed = int(take())
            elif a == "--kernel-residual-threshold":
                v = float(take())
                if not v > 0:
                    raise ValueError(
                        "--kernel-residual-threshold must be > 0 "
                        f"(a measured/predicted ratio), got {v}")
                self.kernel_residual_threshold = v
            elif a == "--machine-model-version":
                self.machine_model_version = int(take())
            elif a in ("--machine-model-file", "--machine-spec"):
                self.machine_model_file = take()
            elif a == "--fitted-profile":
                self.fitted_profile_file = take()
            elif a == "--op-cost-cache":
                self.op_cost_cache_file = take()
            elif a == "--export-strategy-task-graph-file":
                self.export_strategy_task_graph_file = take()
            elif a == "--kernel-impl":
                v = take()
                from .kernels.registry import KernelRegistry

                KernelRegistry.parse_spec(v)  # raises on a bad spec
                self.kernel_impl = v
            else:
                raise ValueError(f"flag {a!r} is not ported (flags: "
                                 "--batch-size, --epochs, --iterations, "
                                 "--steps-per-execution, --learning-rate, "
                                 "--weight-decay, --print-freq, "
                                 "--profiling, --flash-block-q, "
                                 "--flash-block-k, --kernel-impl, --seed, "
                                 "--kernel-residual-threshold, "
                                 "--machine-model-version, "
                                 "--machine-model-file, --machine-spec, "
                                 "--fitted-profile, --op-cost-cache, "
                                 "--export-strategy-task-graph-file)")
            i += 1
