"""Counterpart of flexflow_tpu/models/candle_uno.py, the same graph, op names
and defaults. CANDLE Uno drug-response model (reference:
examples/cpp/candle_uno/candle_uno.cc) — per-feature encoder towers whose
outputs concat into a deep regression head."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

from ..ffconst import ActiMode


@dataclass
class CandleUnoConfig:
    """Defaults mirror CandleConfig's ctor (candle_uno.cc:29-47)."""
    dense_layers: List[int] = field(default_factory=lambda: [4192] * 4)
    dense_feature_layers: List[int] = field(default_factory=lambda: [4192] * 4)
    # feature name → encoder model name; features sharing an encoder share weights
    input_features: Dict[str, str] = field(default_factory=lambda: {
        "dose1": "dose",
        "dose2": "dose",
        "cell.rnaseq": "cell.rnaseq",
        "drug1.descriptors": "drug.descriptors",
        "drug1.fingerprints": "drug.fingerprints",
        "drug2.descriptors": "drug.descriptors",
        "drug2.fingerprints": "drug.fingerprints",
    })


def _feature_tower(ff, t, dims, name: str):
    """Stack of bias-free ReLU dense layers (candle_uno.cc:49-57)."""
    for i, d in enumerate(dims):
        t = ff.dense(t, d, ActiMode.AC_MODE_RELU, use_bias=False,
                     name=f"{name}_d{i}")
    return t


def build_candle_uno(model, feature_inputs: Dict[str, "object"],
                     config: CandleUnoConfig = None):
    """feature_inputs maps feature name → input tensor. Features mapped to the
    same encoder name get their own tower instance here (the reference shares
    encoder architecture, not weights, per input; candle_uno.cc:90-120), then
    all encodings concat into the final dense_layers stack with a 1-unit
    regression output."""
    cfg = config or CandleUnoConfig()
    ff = model
    encoded = []
    for fname, tensor in feature_inputs.items():
        if fname.startswith("dose"):
            encoded.append(tensor)  # scalar doses feed the head directly
        else:
            encoded.append(_feature_tower(ff, tensor, cfg.dense_feature_layers,
                                          f"enc_{fname.replace('.', '_')}"))
    t = ff.concat(encoded, axis=-1)
    for i, d in enumerate(cfg.dense_layers):
        t = ff.dense(t, d, ActiMode.AC_MODE_RELU, use_bias=False, name=f"head{i}")
    return ff.dense(t, 1, name="out")
