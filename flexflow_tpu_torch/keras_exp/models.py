"""keras_exp Model: tf.keras -> ONNX -> the port's FFModel (counterpart
of flexflow_tpu/keras_exp/models.py; reference:
python/flexflow/keras_exp/models/model.py — BaseModel holds the onnx_model
produced by keras2onnx and drives ONNXModelKeras)."""
from __future__ import annotations

from typing import Optional, Sequence

from ..config import FFConfig
from ..model import FFModel


def _to_onnx(model_or_path):
    """Accepts a tf.keras model (live conversion via tf2onnx), an onnx
    ModelProto, or a path to an exported .onnx file. tf2onnx is looked
    for before tensorflow (which it imports itself), so a machine without
    it fails at once, not after tensorflow's import."""
    if isinstance(model_or_path, str):
        return model_or_path
    mod = type(model_or_path).__module__
    if mod.startswith(("keras", "tensorflow")):
        try:
            import tf2onnx
            import tensorflow as tf
        except ImportError as e:
            raise ImportError(
                "converting a live tf.keras model needs tensorflow + "
                "tf2onnx; alternatively export it to .onnx yourself and "
                "pass the path"
            ) from e
        spec = [tf.TensorSpec(i.shape, i.dtype) for i in model_or_path.inputs]
        proto, _ = tf2onnx.convert.from_keras(model_or_path,
                                              input_signature=spec)
        return proto
    return model_or_path  # assume onnx ModelProto


class Model:
    """keras_exp entry point: wraps a tf.keras model (or its ONNX export)
    and compiles it into an FFModel (reference: keras_exp BaseModel)."""

    def __init__(self, model, batch_size: Optional[int] = None,
                 config: Optional[FFConfig] = None):
        from ..onnx.model import ONNXModelKeras

        self._onnx = ONNXModelKeras(_to_onnx(model))
        self.config = config or FFConfig()
        if batch_size:
            self.config.batch_size = batch_size
        self.ffmodel: Optional[FFModel] = None
        self.outputs = None

    def build(self, input_dims: Sequence[Sequence[int]],
              input_dtypes=None) -> FFModel:
        """Instantiate the graph for concrete input shapes."""
        from ..ffconst import DataType

        ffmodel = FFModel(self.config)
        dtypes = input_dtypes or [DataType.DT_FLOAT] * len(input_dims)
        tensors = [ffmodel.create_tensor(list(d), dt)
                   for d, dt in zip(input_dims, dtypes)]
        self.outputs = self._onnx.apply(ffmodel, tensors)
        ffmodel.final_tensor = self.outputs[0]
        self.ffmodel = ffmodel
        return ffmodel

    def compile(self, optimizer=None, loss_type=None, metrics=(),
                **kwargs) -> FFModel:
        assert self.ffmodel is not None, "call build(input_dims) first"
        from ..ffconst import LossType
        from ..runtime.optimizers import SGDOptimizer

        self.ffmodel.compile(
            optimizer=optimizer or SGDOptimizer(self.ffmodel),
            loss_type=loss_type or LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
            metrics=list(metrics),
            **kwargs,
        )
        # carry the keras-trained weights over (reference keras_exp keeps
        # the tf weights; here they arrive as ONNX initializers —
        # transfer_weights warns on any shortfall)
        self._onnx.transfer_weights(self.ffmodel)
        return self.ffmodel

    def fit(self, x, y, **kwargs):
        return self.ffmodel.fit(x, y, **kwargs)
