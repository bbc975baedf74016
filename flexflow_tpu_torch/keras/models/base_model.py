"""BaseModel: compile keras layer graph -> FFModel; fit/evaluate/predict
(counterpart of flexflow_tpu/keras/models/base_model.py).

reference parity: python/flexflow/keras/models/base_model.py:31 (BaseModel:
compile :128 builds the FFModel from the layer graph, fit :198 drives the
training loop with callbacks). fit() calls FFModel.fit once an epoch; the
model's K-step dispatch (`steps_per_execution`) is built once and kept
across those calls. Weights leave and enter in JAX's order, sorted by op
name, then weight name, so one package's get_weights() feeds the other's
set_weights(); set_weights copies into the masters in place
(Op.set_weight), which a captured graph sees.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ...config import FFConfig
from ...model import FFModel
from .. import losses as keras_losses
from .. import metrics as keras_metrics
from .. import optimizers as keras_optimizers
from ..callbacks import Callback, CallbackList, History
from .tensor import KerasTensor


class BaseModel:
    def __init__(self, name: str = "model"):
        self.name = name
        self.ffconfig: Optional[FFConfig] = None
        self.ffmodel: Optional[FFModel] = None
        self.inputs: List[KerasTensor] = []
        self.outputs: List[KerasTensor] = []
        self.stop_training = False
        self._layers: List = []

    # populated by subclasses before compile
    @property
    def layers(self):
        return list(self._layers)

    # -- graph walk -----------------------------------------------------
    def _build_tensor(self, t: KerasTensor):
        if t.ff_tensor is not None:
            return t.ff_tensor
        layer = t.layer
        ff_ins = [self._build_tensor(i) for i in t.inputs]
        out = layer._build(self.ffmodel, ff_ins)
        if isinstance(out, (list, tuple)):
            t.ff_tensor = out[t.output_index]
        else:
            t.ff_tensor = out
        return t.ff_tensor

    def _stabilize_layer_names(self):
        """Rename auto-named layers deterministically by position within THIS
        model (class-global counters would make op names — the checkpoint
        pytree keys — depend on how many models the process built before)."""
        from ..layers.base_layer import _snake

        counts: Dict[str, int] = {}
        taken = {l.name for l in self._layers if not getattr(l, "_auto_named", False)}
        for layer in self._layers:
            if not getattr(layer, "_auto_named", False):
                continue
            base = _snake(type(layer).__name__)
            while True:
                idx = counts.get(base, 0)
                counts[base] = idx + 1
                name = f"{base}_{idx}" if idx else base
                if name not in taken:
                    break
            layer.name = name

    def compile(self, optimizer, loss=None, metrics=None, ffconfig=None,
                parallel_axes: Optional[Dict[str, int]] = None,
                steps_per_execution: int = 1, **kwargs):
        """steps_per_execution mirrors tf.keras: K optimizer steps per
        jitted device dispatch (FFModel.fit's flag of the same name)."""
        self._steps_per_execution = int(steps_per_execution)
        self.ffconfig = ffconfig or FFConfig()
        self.ffmodel = FFModel(self.ffconfig)
        self._stabilize_layer_names()
        # inputs first (establishes input order for fit(x=[...]))
        for t in self.inputs:
            t.ff_tensor = t.layer._build(self.ffmodel, [])
        for t in self.outputs:
            self._build_tensor(t)
        self.ffmodel.final_tensor = self.outputs[0].ff_tensor

        opt = keras_optimizers.get(optimizer)
        ff_opt = opt.to_ff(self.ffmodel) if hasattr(opt, "to_ff") else opt
        loss_type = keras_losses.get(loss or "sparse_categorical_crossentropy")
        metric_types = [keras_metrics.get(m) for m in (metrics or [])]
        self.ffmodel.compile(
            optimizer=ff_opt, loss_type=loss_type, metrics=metric_types,
            parallel_axes=parallel_axes, **kwargs,
        )
        return self

    # -- training -------------------------------------------------------
    def fit(self, x=None, y=None, epochs: int = 1, batch_size: Optional[int] = None,
            callbacks: Optional[Sequence[Callback]] = None,
            validation_data=None, accum_steps: int = 1,
            verbose: bool = False) -> History:
        assert self.ffmodel is not None, "call compile() first"
        history = History()
        cbs = CallbackList([history] + list(callbacks or []), model=self)
        self.stop_training = False
        cbs.on_train_begin()
        for epoch in range(epochs):
            cbs.on_epoch_begin(epoch)
            logs = self.ffmodel.fit(
                x, y, batch_size=batch_size, epochs=1,
                accum_steps=accum_steps,
                steps_per_execution=getattr(self, "_steps_per_execution", 1),
                verbose=verbose
            )[0]
            if validation_data is not None:
                vx, vy = validation_data
                val = self.ffmodel.eval(vx, vy, batch_size=batch_size)
                logs.update({f"val_{k}": v for k, v in val.items()})
            cbs.on_epoch_end(epoch, logs)
            if self.stop_training:
                break
        cbs.on_train_end()
        return history

    def evaluate(self, x, y, batch_size: Optional[int] = None) -> Dict[str, float]:
        return self.ffmodel.eval(x, y, batch_size=batch_size)

    def predict(self, x, batch_size: Optional[int] = None) -> np.ndarray:
        return self.ffmodel.predict(x, batch_size=batch_size)

    # -- weights --------------------------------------------------------
    def get_weights(self) -> List[np.ndarray]:
        """Copies of the f32 masters (never views of them)."""
        import torch

        params = self.ffmodel.params
        return [params[op][w].to("cpu", torch.float32, copy=True).numpy()
                for op in sorted(params) for w in sorted(params[op])]

    def set_weights(self, weights: Sequence[np.ndarray]) -> None:
        import torch

        ops = {op.name: op for op in self.ffmodel.ops}
        params = self.ffmodel.params
        it = iter(weights)
        for op_name in sorted(params):
            for w_name in sorted(params[op_name]):
                ops[op_name].set_weight(w_name, torch.tensor(
                    np.asarray(next(it))))

    def summary(self) -> str:
        lines = [f'Model: "{self.name}"', "-" * 52,
                 f"{'Layer':<28}{'Params':>12}", "-" * 52]
        total = 0
        for layer in self._layers:
            n = layer.count_params()
            total += n
            lines.append(f"{layer.name:<28}{n:>12}")
        lines.append("-" * 52)
        lines.append(f"Total params: {total}")
        return "\n".join(lines)
