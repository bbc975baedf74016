"""Weight regularizers, applied as extra loss terms on the named weight
(counterpart of flexflow_tpu/keras/regularizers.py).

reference parity: python/flexflow/keras/regularizers.py. A regularizer
maps the f32 master weight (a torch tensor) to a 0-d tensor, so it runs
inside every training dispatch of FFModel.fit, the captured K-step graph
included (FFModel.add_weight_regularizer).
"""
from __future__ import annotations

import torch


class Regularizer:
    def __call__(self, weight):
        raise NotImplementedError


class L1L2(Regularizer):
    def __init__(self, l1: float = 0.0, l2: float = 0.0):
        self.l1 = float(l1)
        self.l2 = float(l2)

    def __call__(self, weight):
        total = 0.0
        if self.l1:
            total = total + self.l1 * torch.sum(torch.abs(weight))
        if self.l2:
            total = total + self.l2 * torch.sum(weight * weight)
        return total


def L1(l1: float = 0.01) -> L1L2:
    return L1L2(l1=l1)


def L2(l2: float = 0.01) -> L1L2:
    return L1L2(l2=l2)
