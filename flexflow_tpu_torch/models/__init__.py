"""Model builders of the port (counterpart of flexflow_tpu/models)."""
from .transformer import TransformerConfig, build_bert_encoder

__all__ = ["TransformerConfig", "build_bert_encoder"]
