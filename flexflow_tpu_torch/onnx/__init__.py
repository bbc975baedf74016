"""ONNX frontend (counterpart of flexflow_tpu/onnx/): `ONNXModel` and
`ONNXModelKeras` replay an ONNX graph through the port's FFModel, read by
the onnx package where it is installed, else by the wire codec (wire.py)."""
from .model import ONNXModel, ONNXModelKeras

__all__ = ["ONNXModel", "ONNXModelKeras"]
