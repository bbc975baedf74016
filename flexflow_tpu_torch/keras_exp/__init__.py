"""keras_exp: the tf.keras tracing frontend (counterpart of
flexflow_tpu/keras_exp; reference: python/flexflow/keras_exp/models/model.py
— a REAL tf.keras Model is run through keras2onnx and replayed by
ONNXModelKeras).

Same pipeline here: `Model(tf_keras_model)` converts the live model with
tf2onnx when both it and tensorflow are installed; `Model("model.onnx")`
(or an ONNX ModelProto, or the port's own wire-codec proto) skips the
conversion and replays an already-exported keras model through the port's
ONNX importer (onnx/model.py ONNXModelKeras). The native keras API
(flexflow_tpu_torch.keras) remains the non-tf path."""
from .models import Model

__all__ = ["Model"]
