"""flexflow_tpu_torch: the PyTorch/CUDA port of flexflow_tpu for NVIDIA
Hopper (H100).

flexflow_tpu (JAX on a TPU) stays the reference; this package imports
torch, never jax, and nothing of flexflow_tpu. The port goes slice by
slice (ROADMAP.md). Ported: continuous-batching serving
of a causal transformer LM (the executor's KV-cache decode walk, the
paged KV pool, admission and the continuous batcher), the single-device
training step of the flagship BERT encoder (compile, fit and eval with
SGD or Adam on autograd), the kernel tier's selection path (the kernel
registry, `FFConfig.kernel_impl`, the ops' reference lowerings, RMSNorm,
the losses), training on a data x model mesh of torch.distributed
ranks (`compile(parallel_axes={"data": dp, "model": tp})`,
runtime/distributed.py, runtime/collectives.py), and the single-device
training runtime with the MLP path (the fused optimizer update,
`fit(steps_per_execution=K)` as a CUDA graph, gradient accumulation,
dataloader-driven fit, the six metrics, the elementwise, shape and
reduction ops), over hand-written CUDA kernels (kernels/, csrc/): decode
attention, flash attention forward and backward (packed and
head-separated), LayerNorm, RMSNorm and softmax forward and backward,
the scalar reduction and the scan, and the Adam / SGD update over a
list of weight tensors.

Entry points run on `FFConfig.device`, "cuda" unless the caller passes
"cpu". The kernel registry (kernels/registry.py) runs the kernels on a
Hopper card and the ops' reference lowerings on the CPU; forced to the
kernel tier on the CPU, every kernel wrapper runs its plain PyTorch
version.
"""
from .config import FFConfig
from .ffconst import (ActiMode, AggrMode, CompMode, DataType, LossType,
                      MetricsType, OpType)
from .model import FFModel, opt_state_from_jax, params_from_jax
from .runtime.dataloader import SingleDataLoader
from .runtime.optimizers import AdamOptimizer, SGDOptimizer

__all__ = ["ActiMode", "AdamOptimizer", "AggrMode", "CompMode", "DataType",
           "FFConfig", "FFModel", "LossType", "MetricsType", "OpType",
           "SGDOptimizer", "SingleDataLoader", "opt_state_from_jax",
           "params_from_jax"]
