"""Model builders of the port (counterpart of flexflow_tpu/models): each
builds its family through the FFModel layer API, with the JAX builder's
graph, op names and defaults. The pipeline transformer is the submodule
`pipeline_transformer`, as in the JAX package (its names are reached
through the package too)."""
from .alexnet import build_alexnet
from .candle_uno import CandleUnoConfig, build_candle_uno
from .cnn import build_cifar10_cnn, build_mnist_cnn, build_mnist_mlp
from .dlrm import DLRMConfig, build_dlrm
from .inception import build_inception_v3
from .mlp import build_mlp_unify
from .moe import (MoeConfig, MoeTransformerConfig, build_moe_encoder,
                  build_moe_lm, build_moe_transformer, moe_expert_ops)
from .resnet import build_resnet, build_resnet50
from .resnext import build_resnext50
from .rnn import build_lstm_nmt
from .transformer import (TransformerConfig, build_bert_encoder,
                          build_transformer)
from .xdl import XDLConfig, build_xdl

_PIPELINE = ("init_pipeline_params", "pipeline_forward",
             "sequential_forward", "make_train_step", "stage_slice")


def __getattr__(name):
    if name == "pipeline_transformer" or name in _PIPELINE:
        import importlib

        mod = importlib.import_module(f"{__name__}.pipeline_transformer")
        return mod if name == "pipeline_transformer" else getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "build_alexnet", "build_mnist_mlp", "build_mnist_cnn",
    "build_cifar10_cnn", "build_resnet", "build_resnet50",
    "build_inception_v3", "build_resnext50", "DLRMConfig", "build_dlrm",
    "XDLConfig", "build_xdl", "CandleUnoConfig", "build_candle_uno",
    "build_mlp_unify", "TransformerConfig", "build_transformer",
    "build_bert_encoder", "MoeConfig", "MoeTransformerConfig",
    "build_moe_encoder", "build_moe_transformer", "build_moe_lm",
    "moe_expert_ops", "build_lstm_nmt",
]
