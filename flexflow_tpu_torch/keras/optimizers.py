"""Keras optimizer wrappers (counterpart of flexflow_tpu/keras/optimizers.py).

reference parity: python/flexflow/keras/optimizers.py (SGD, Adam wrapping the
core optimizers): `to_ff` builds the port's SGDOptimizer / AdamOptimizer,
whose update is one launch of the fused optimizer kernel on the card.
"""
from __future__ import annotations

from ..runtime.optimizers import AdamOptimizer, SGDOptimizer


class Optimizer:
    def to_ff(self, ffmodel):
        raise NotImplementedError


class SGD(Optimizer):
    def __init__(self, learning_rate: float = 0.01, momentum: float = 0.0,
                 nesterov: bool = False, weight_decay: float = 0.0, lr=None):
        self.learning_rate = lr if lr is not None else learning_rate
        self.momentum = momentum
        self.nesterov = nesterov
        self.weight_decay = weight_decay

    def to_ff(self, ffmodel):
        return SGDOptimizer(
            ffmodel, lr=self.learning_rate, momentum=self.momentum,
            nesterov=self.nesterov, weight_decay=self.weight_decay,
        )


class Adam(Optimizer):
    def __init__(self, learning_rate: float = 0.001, beta_1: float = 0.9,
                 beta_2: float = 0.999, epsilon: float = 1e-8,
                 weight_decay: float = 0.0, lr=None):
        self.learning_rate = lr if lr is not None else learning_rate
        self.beta_1 = beta_1
        self.beta_2 = beta_2
        self.epsilon = epsilon
        self.weight_decay = weight_decay

    def to_ff(self, ffmodel):
        return AdamOptimizer(
            ffmodel, alpha=self.learning_rate, beta1=self.beta_1,
            beta2=self.beta_2, epsilon=self.epsilon,
            weight_decay=self.weight_decay,
        )


def get(identifier):
    if isinstance(identifier, Optimizer):
        return identifier
    if isinstance(identifier, str):
        return {"sgd": SGD, "adam": Adam}[identifier.lower()]()
    return identifier  # assume a core optimizer of the port
