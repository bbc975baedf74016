"""flexflow_tpu_torch: the PyTorch/CUDA port of flexflow_tpu for NVIDIA
Hopper (H100).

flexflow_tpu (JAX on a TPU) stays the reference; this package imports
torch, never jax, and nothing of flexflow_tpu. The port goes slice by
slice (ROADMAP.md). This slice is continuous-batching serving of a causal
transformer LM: the FFModel layer API the LM needs, the executor's
KV-cache decode walk, the paged KV pool, admission and the continuous
batcher, over three hand-written CUDA kernels (kernels/, csrc/).

Entry points run on `FFConfig.device`, "cuda" unless the caller passes
"cpu"; on the CPU every kernel wrapper runs its plain PyTorch version.
"""
from .config import FFConfig
from .ffconst import ActiMode, AggrMode, CompMode, DataType, OpType
from .model import FFModel, params_from_jax

__all__ = ["ActiMode", "AggrMode", "CompMode", "DataType", "FFConfig",
           "FFModel", "OpType", "params_from_jax"]
