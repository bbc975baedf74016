"""Runtime configuration: the FFConfig fields the ported slices read.

Counterpart of flexflow_tpu/config.py FFConfig. The cost model's flags
(the machine model, the fitted profile, the op-cost cache, the task-graph
export) and the strategy search's (search/unity.py, search/mcmc.py,
search/plan_cache.py, analysis/) are the JAX package's, with its
defaults and spellings. `device` is new — the port runs on one explicit
torch device, CUDA unless the caller asks for the CPU.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from typing import List, Optional, Sequence


@dataclasses.dataclass
class FFIterationConfig:
    """Per-iteration attributes (flexflow_tpu/config.py FFIterationConfig):
    the manual loop's `forward(seq_length=)` / `backward(seq_length=)`
    carry its one field (core/op.py `iter_seq_length`)."""

    seq_length: int = -1

    def reset(self) -> None:
        self.seq_length = -1


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
    # the ranks to run on (global torch.distributed ranks, ascending): the
    # plan's mesh is laid over them, its leader is the first. Set by the
    # elastic coordinator to compile onto the SURVIVORS of a rank loss;
    # wins over num_devices. None: every rank of the world
    device_ids: Optional[List[int]] = None
    # the elastic runtime's hook (elastic/detector.py FailureDetector.wrap):
    # FFModel wraps the elastic step's dispatch with it, so fault
    # injection, failure classification and retry ride every dispatch
    elastic_step_wrapper: Optional[object] = None
    # hosts the devices span (JAX `num_nodes`, `--nodes`): divides them
    # into `workers_per_node`
    num_nodes: int = 1
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
    # -- the strategy search (search/unity.py), the JAX package's fields
    # and defaults. compile() searches when search_budget > 0 (or under
    # strategy_search="mcmc" with mcmc_budget > 0) on a world of more
    # than one rank, and adopts the per-op plan ------------------------
    search_budget: int = 0
    search_alpha: float = 1.2
    base_optimize_threshold: int = 10
    # mesh factorizations that get the cross-segment refinement
    refine_top_k: int = 4
    # the plan cache (search/plan_cache.py): an exact hit skips the
    # enumeration (the analysis gate still runs), a near miss seeds a
    # warm refinement that falls back to a cold search past
    # warm_fallback_tolerance x the warm sweep's floor
    plan_cache: bool = True
    plan_cache_dir: Optional[str] = None
    plan_cache_capacity: int = 32
    search_warm_start: bool = True
    warm_fallback_tolerance: float = 1.05
    # the re-plan's plan-distance term and its live plan (a
    # resharding.ShardingPlan, priced through resharding/cost.py; the
    # elastic coordinator's re-plans set it, elastic/coordinator.py)
    replan_distance_weight: float = 1.0
    replan_live_plan: Optional[object] = None
    # joint substitution x parallelization search; False applies the
    # trade-off rewrites greedily first
    joint_search: bool = True
    # "unity" or "mcmc" (search/mcmc.py)
    strategy_search: str = "unity"
    mcmc_budget: Optional[int] = None
    mcmc_propagate: bool = False
    only_data_parallel: bool = False
    # the search's axes beyond data and model (attr, seq, stage) and the
    # parameter-parallel reductions
    enable_parameter_parallel: bool = False
    enable_attribute_parallel: bool = False
    enable_sequence_parallel: bool = False
    enable_pipeline_parallel: bool = False
    pipeline_microbatches: int = 4
    enable_inplace_optimizations: bool = False
    # the plan analysis (analysis/): pruning of mesh factorizations,
    # verification of the candidates, compile's gate ("error", "warn",
    # "off") and the memory-aware search
    analysis_prune: bool = True
    verify_candidates: bool = False
    plan_analysis: str = "error"
    memory_search: bool = False
    memory_budget_mb: float = 16 * 1024.0
    substitution_json_path: Optional[str] = None
    # measured op costs (OpCostCache): None = measure when `device` is a
    # CUDA card, stay analytic on the CPU
    measure_op_costs: Optional[bool] = None
    # parsed for the JAX package's command lines; it has no effect: the
    # native search core (src/ffcore) is ROADMAP A11, and the Python
    # search is the JAX package's behavioral spec
    use_native_search: bool = True
    # the data axis's gradient sync (runtime/collectives.py): "gspmd" one
    # flat all-reduce bucket, "explicit" the reduction plan's per-tier
    # strategies and buckets (CollectiveLoweringError where the plan
    # cannot be lowered), "auto" explicit when supported and the plan
    # crosses a tier boundary
    collective_lowering: str = "gspmd"
    export_strategy_file: Optional[str] = None
    import_strategy_file: Optional[str] = None
    # compile() writes the computation graph (dot) here
    export_strategy_computation_graph_file: Optional[str] = None
    # the JAX package's flags of these three fields, parsed and kept; as
    # in JAX, nothing reads them
    include_costs_dot_graph: bool = False
    perform_fusion: bool = False
    simulator_work_space_size: int = 2 * 1024 * 1024 * 1024

    @classmethod
    def from_command_line(cls, argv: Optional[Sequence[str]] = None
                          ) -> "FFConfig":
        """A config from command-line flags (JAX `from_command_line`): an
        explicit opt-in, as FFConfig() never reads sys.argv."""
        cfg = cls()
        cfg.parse_args(sys.argv[1:] if argv is None else argv)
        return cfg

    @property
    def total_devices(self) -> int:
        """Chips the cost model prices (JAX `total_devices`): the ranks of
        `device_ids` when set."""
        if self.device_ids is not None:
            return len(self.device_ids)
        if self.num_devices is not None:
            return int(self.num_devices)
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_world_size()
        return 1

    @property
    def workers_per_node(self) -> int:
        """The devices of a host (JAX's): the devices over `num_nodes`."""
        return max(1, self.total_devices // max(1, self.num_nodes))

    def get_current_time(self) -> float:
        """Microseconds since the epoch (JAX's, like Legion's
        timestamps)."""
        return time.time() * 1e6

    def parse_args(self, argv: Sequence[str]) -> List[str]:
        """Set fields from the JAX package's flag spellings; returns the
        flags it does not know, in order (JAX `parse_args`). A flag that
        wants a value and has none raises ValueError."""
        rest: List[str] = []
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
            elif a == "--fusion":
                self.perform_fusion = True
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
            elif a == "--export-strategy-computation-graph-file":
                self.export_strategy_computation_graph_file = take()
            elif a == "--export-strategy-task-graph-file":
                self.export_strategy_task_graph_file = take()
            elif a == "--include-costs-dot-graph":
                self.include_costs_dot_graph = True
            elif a == "--simulator-workspace-size":
                self.simulator_work_space_size = int(take())
            elif a == "--kernel-impl":
                v = take()
                from .kernels.registry import KernelRegistry

                KernelRegistry.parse_spec(v)  # raises on a bad spec
                self.kernel_impl = v
            elif a == "--grad-bucket-bytes":
                v = int(take())
                if v < 0:
                    raise ValueError(
                        "--grad-bucket-bytes must be >= 0 (bytes; 0 "
                        f"disables bucketing), got {v}")
                self.grad_bucket_bytes = v
            elif a == "--search-overlap-backward-update":
                self.search_overlap_backward_update = True
            elif a == "--nodes":
                self.num_nodes = int(take())
            elif a in ("--chips", "-ll:gpu"):
                self.num_devices = int(take())
            elif not self._parse_search_flag(a, take):
                rest.append(a)
            i += 1
        return rest

    def _parse_search_flag(self, a: str, take) -> bool:
        """Set a strategy-search field from its JAX spelling (with JAX's
        checks); False for any other flag."""
        if a in ("--budget", "--search-budget"):
            self.search_budget = int(take())
        elif a in ("--alpha", "--search-alpha"):
            self.search_alpha = float(take())
        elif a == "--base-optimize-threshold":
            self.base_optimize_threshold = int(take())
        elif a == "--refine-top-k":
            self.refine_top_k = int(take())
        elif a == "--plan-cache-dir":
            self.plan_cache_dir = take()
        elif a == "--plan-cache-capacity":
            v = int(take())
            if v < 1:
                raise ValueError(
                    f"--plan-cache-capacity must be >= 1, got {v}")
            self.plan_cache_capacity = v
        elif a == "--no-plan-cache":
            self.plan_cache = False
        elif a == "--no-search-warm-start":
            self.search_warm_start = False
        elif a == "--warm-fallback-tolerance":
            v = float(take())
            if not v >= 1.0:
                raise ValueError(
                    "--warm-fallback-tolerance must be >= 1.0 (a"
                    f" refined/floor cost ratio), got {v}")
            self.warm_fallback_tolerance = v
        elif a == "--replan-distance-weight":
            v = float(take())
            if v < 0:
                raise ValueError(
                    "--replan-distance-weight must be >= 0"
                    f" (0 disables the term), got {v}")
            self.replan_distance_weight = v
        elif a == "--collective-lowering":
            v = take()
            from .runtime.collectives import COLLECTIVE_LOWERINGS

            if v not in COLLECTIVE_LOWERINGS:
                raise ValueError(
                    "--collective-lowering must be one of "
                    f"{COLLECTIVE_LOWERINGS}, got {v!r}")
            self.collective_lowering = v
        elif a == "--strategy-search":
            v = take()
            if v not in ("unity", "mcmc"):
                raise ValueError(
                    f"--strategy-search must be unity or mcmc, got {v!r}")
            self.strategy_search = v
        elif a == "--mcmc-budget":
            self.mcmc_budget = int(take())
        elif a == "--mcmc-propagate":
            self.mcmc_propagate = True
        elif a == "--only-data-parallel":
            self.only_data_parallel = True
        elif a == "--enable-parameter-parallel":
            self.enable_parameter_parallel = True
        elif a == "--enable-attribute-parallel":
            self.enable_attribute_parallel = True
        elif a == "--enable-sequence-parallel":
            self.enable_sequence_parallel = True
        elif a == "--enable-pipeline-parallel":
            self.enable_pipeline_parallel = True
        elif a == "--pipeline-microbatches":
            self.pipeline_microbatches = int(take())
        elif a == "--no-analysis-prune":
            self.analysis_prune = False
        elif a == "--verify-candidates":
            self.verify_candidates = True
        elif a == "--plan-analysis":
            v = take()
            if v not in ("error", "warn", "off"):
                raise ValueError(
                    f"--plan-analysis must be error, warn or off, got {v!r}")
            self.plan_analysis = v
        elif a == "--memory-search":
            self.memory_search = True
        elif a == "--memory-budget":
            self.memory_budget_mb = float(take())
        elif a == "--measure-op-costs":
            self.measure_op_costs = True
        elif a == "--no-measure-op-costs":
            self.measure_op_costs = False
        elif a == "--substitution-json":
            self.substitution_json_path = take()
        elif a == "--export":
            self.export_strategy_file = take()
        elif a == "--import":
            self.import_strategy_file = take()
        else:
            return False
        return True



def take_device(argv: List[str], default: str = "cuda") -> str:
    """Take `--device cuda|cpu` off `argv` (in place) and return it: the
    command line's device, CUDA unless the caller asks for the CPU. A
    CUDA request where no card is visible exits with an error; it never
    falls back to the CPU."""
    device = default
    if "--device" in argv:
        i = argv.index("--device")
        if i + 1 >= len(argv):
            raise SystemExit("missing value for --device")
        device = argv[i + 1]
        del argv[i:i + 2]
    require_device(device)
    return device


def require_device(device: str) -> None:
    """Exit with an error unless `device` is "cpu", or "cuda" with a card
    visible."""
    if device not in ("cuda", "cpu"):
        raise SystemExit(f"--device {device!r}: cuda or cpu")
    if device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device visible (--device cpu runs "
                             "on the CPU)")
