"""Keras callbacks (counterpart of flexflow_tpu/keras/callbacks.py).

reference parity: python/flexflow/keras/callbacks.py:21-90 (Callback,
LearningRateScheduler, VerifyMetrics, EpochVerifyMetrics). History and
ModelCheckpoint are capability extensions (the reference lacks checkpoint
writing — SURVEY.md §5). LearningRateScheduler reads `opt_state["lr"]`
(a 0-d tensor on the model's device) and writes the new rate in place
(FFModel.set_learning_rate), so a captured K-step graph's replays train
at it; ModelCheckpoint writes the JAX package's checkpoint format
(runtime/checkpoint.py).
"""
from __future__ import annotations

from typing import Dict, List, Optional


class Callback:
    def __init__(self):
        self.model = None

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch: int, logs=None):
        pass

    def on_epoch_end(self, epoch: int, logs=None):
        pass

    def on_batch_begin(self, batch: int, logs=None):
        pass

    def on_batch_end(self, batch: int, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks: List[Callback], model=None):
        self.callbacks = list(callbacks)
        for cb in self.callbacks:
            cb.set_model(model)

    def __getattr__(self, name):
        if name.startswith("on_"):
            def dispatch(*args, **kwargs):
                for cb in self.callbacks:
                    getattr(cb, name)(*args, **kwargs)
            return dispatch
        raise AttributeError(name)


class History(Callback):
    def on_train_begin(self, logs=None):
        self.epoch: List[int] = []
        self.history: Dict[str, List[float]] = {}

    def on_epoch_end(self, epoch, logs=None):
        self.epoch.append(epoch)
        for k, v in (logs or {}).items():
            self.history.setdefault(k, []).append(v)


class LearningRateScheduler(Callback):
    """schedule(epoch) or, tf.keras-style, schedule(epoch, lr)."""

    def __init__(self, schedule):
        super().__init__()
        self.schedule = schedule

    def on_epoch_begin(self, epoch, logs=None):
        ffmodel = self.model.ffmodel
        try:
            current = float(ffmodel.opt_state["lr"])
        except (KeyError, TypeError):
            current = float(getattr(ffmodel.optimizer, "lr",
                                    getattr(ffmodel.optimizer, "alpha", 0.0)))
        try:
            lr = self.schedule(epoch, current)
        except TypeError:
            lr = self.schedule(epoch)
        ffmodel.set_learning_rate(float(lr))


class EarlyStopping(Callback):
    """Stop when the monitored metric stops improving (tf.keras semantics)."""

    def __init__(self, monitor: str = "loss", min_delta: float = 0.0,
                 patience: int = 0, mode: str = "auto"):
        super().__init__()
        self.monitor = monitor
        self.min_delta = abs(min_delta)
        self.patience = patience
        if mode == "auto":
            mode = "max" if ("acc" in monitor) else "min"
        self.mode = mode
        self.best = None
        self.wait = 0

    def on_train_begin(self, logs=None):
        self.best = None
        self.wait = 0

    def on_epoch_end(self, epoch, logs=None):
        val = (logs or {}).get(self.monitor)
        if val is None:
            return
        val = float(val)
        if self.mode == "max":
            improved = self.best is None or val > self.best + self.min_delta
        else:
            improved = self.best is None or val < self.best - self.min_delta
        if improved:
            self.best = val
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True


class VerifyMetrics(Callback):
    """Assert the final accuracy beats the given gate (examples'
    ModelAccuracy enum value, e.g. MNIST_MLP >= 90%)."""

    def __init__(self, accuracy):
        super().__init__()
        self.target = accuracy.value if hasattr(accuracy, "value") else float(accuracy)
        self.last: Optional[Dict] = None

    def on_epoch_end(self, epoch, logs=None):
        self.last = logs or {}

    def on_train_end(self, logs=None):
        acc = 100.0 * float((self.last or {}).get("accuracy", 0.0))
        assert acc >= self.target, (
            f"accuracy {acc:.2f}% below required {self.target:.2f}%"
        )


class EpochVerifyMetrics(Callback):
    """Stop training early once the accuracy gate is reached."""

    def __init__(self, accuracy):
        super().__init__()
        self.target = accuracy.value if hasattr(accuracy, "value") else float(accuracy)

    def on_epoch_end(self, epoch, logs=None):
        acc = 100.0 * float((logs or {}).get("accuracy", 0.0))
        if acc >= self.target:
            self.model.stop_training = True


class ModelCheckpoint(Callback):
    """Save checkpoints each epoch via the core checkpoint module."""

    def __init__(self, filepath: str, save_best_only: bool = False,
                 monitor: str = "loss", mode: str = "auto"):
        super().__init__()
        self.filepath = filepath
        self.save_best_only = save_best_only
        self.monitor = monitor
        if mode == "auto":
            mode = "max" if ("acc" in monitor or monitor.endswith("accuracy")) else "min"
        self.mode = mode
        self.best = None

    def on_epoch_end(self, epoch, logs=None):
        logs = logs or {}
        if self.save_best_only and self.monitor not in logs:
            raise KeyError(
                f"ModelCheckpoint monitor {self.monitor!r} not in logs "
                f"{sorted(logs)}"
            )
        val = float(logs.get(self.monitor, 0.0))
        if self.mode == "max":
            better = self.best is None or val > self.best
        else:
            better = self.best is None or val < self.best
        if self.save_best_only and not better:
            return
        self.best = val if better else self.best
        from ..runtime.checkpoint import save_checkpoint

        save_checkpoint(self.filepath.format(epoch=epoch), self.model.ffmodel,
                        step=epoch)
