"""PyTorch (torch.fx) frontend (counterpart of flexflow_tpu/torch/):
`fx.torch_to_flexflow(model, path)` serializes a symbolic trace to a .ff
file, and `PyTorchModel(path_or_module).apply(ffmodel, inputs)` replays
the graph as the port's FFModel layer calls, with `transfer_weights`
copying the torch module's weights into the compiled model. Inside this
package `import torch` is absolute and reaches PyTorch itself."""
from . import fx
from .model import PyTorchModel

__all__ = ["fx", "PyTorchModel"]
