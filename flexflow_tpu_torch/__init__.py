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
reduction ops), the op set and model zoo apart from MoE (conv, pool,
flat, batch norm with its running statistics as op state, dropout and
attention dropout from a seeded per-model generator, LSTM, embedding
bags; `models`), mixture of experts, the rest of the FFModel API
(`predict`, the manual loop, regularizers, `summary`, the Tensor value
API) and durable checkpoints in the JAX package's format with the span
tracer (runtime/checkpoint.py, runtime/durability.py, obs/tracing.py),
over hand-written CUDA kernels (kernels/, csrc/): decode
attention, flash attention forward and backward (packed and
head-separated), LayerNorm, RMSNorm and softmax forward and backward,
the scalar reduction and the scan, and the Adam / SGD update over a
list of weight tensors. Later slices ported the serving front end and
fleet, the cost model and the search, the mesh axes, the elastic
coordinator, the graph importers (`onnx`, `torch`, the C model spec's
`native.c_model`), the Keras frontends (`keras`, `keras_exp`), the
command line, and the native host core (`native`: the port's own copy
of libffcore, built with g++ at first use, with the native Unity search
that `unity_optimize` dispatches to, the prefetching `BatchStream`
behind `SingleDataLoader`, and the C API); the package exports the JAX
package's top-level names.

Entry points run on `FFConfig.device`, "cuda" unless the caller passes
"cpu". The kernel registry (kernels/registry.py) runs the kernels on a
Hopper card and the ops' reference lowerings on the CPU; forced to the
kernel tier on the CPU, every kernel wrapper runs its plain PyTorch
version.
"""
from .config import FFConfig, FFIterationConfig
from .ffconst import (ActiMode, AggrMode, CompMode, DataType, LossType,
                      MetricsType, OpType, ParameterSyncType, PoolType)
from .model import FFModel, opt_state_from_jax, params_from_jax
from .core.tensor import ParallelDim, ParallelTensorShape, Tensor
from .core.machine import MachineResource, MachineView, make_mesh
from .core.graph import Graph
from . import ops  # noqa: F401 — registers the operator types
from . import parallel  # noqa: F401 — registers the parallel ops
from .runtime.dataloader import SingleDataLoader
from .runtime.initializers import (ConstantInitializer,
                                   GlorotUniformInitializer,
                                   NormInitializer, UniformInitializer,
                                   ZeroInitializer)
from .runtime.losses import Loss
from .runtime.metrics import Metrics, PerfMetrics
from .runtime.optimizers import AdamOptimizer, Optimizer, SGDOptimizer
from .runtime.recompile import RecompileState

__all__ = ["ActiMode", "AdamOptimizer", "AggrMode", "CompMode",
           "ConstantInitializer", "DataType", "FFConfig",
           "FFIterationConfig", "FFModel", "GlorotUniformInitializer",
           "Graph", "Loss", "LossType", "MachineResource", "MachineView",
           "Metrics", "MetricsType", "NormInitializer", "OpType",
           "Optimizer", "ParallelDim", "ParallelTensorShape",
           "ParameterSyncType", "PerfMetrics", "PoolType", "RecompileState",
           "SGDOptimizer", "SingleDataLoader", "Tensor",
           "UniformInitializer", "ZeroInitializer", "make_mesh",
           "opt_state_from_jax", "params_from_jax"]
