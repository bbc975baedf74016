"""Counterpart of flexflow_tpu/models/mlp.py, the same graph, op names
and defaults. MLP_Unify two-tower MLP (reference: examples/cpp/MLP_Unify/mlp.cc:37-51)
— the minimal Unity-search benchmark (scripts/osdi22ae/mlp.sh)."""
from __future__ import annotations

from typing import Sequence

from ..ffconst import ActiMode


def build_mlp_unify(model, input1, input2,
                    hidden_dims: Sequence[int] = (8192, 8192, 8192, 8192)):
    """Two parallel dense towers summed then softmaxed — its branch structure
    is what Unity's nonsequence split exploits."""
    ff = model
    t1, t2 = input1, input2
    for i, dim in enumerate(hidden_dims):
        t1 = ff.dense(t1, dim, ActiMode.AC_MODE_RELU, use_bias=False, name=f"a{i}")
        t2 = ff.dense(t2, dim, ActiMode.AC_MODE_RELU, use_bias=False, name=f"b{i}")
    t = ff.add(t1, t2)
    return ff.softmax(t)
