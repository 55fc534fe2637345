"""Training callbacks (port of ``bert4rec_tpu/trainers/callbacks.py``),
driven by the trainer's epoch loop."""

import json
import math
import pathlib
import time

import torch


def _snapshot_tree(tree):
    """Deep copy of a train state: tensors cloned, other leaves as they
    are (the train step updates params and moments in place)."""
    if isinstance(tree, dict):
        return {k: _snapshot_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone().requires_grad_(tree.requires_grad)
    return tree


class Callback:
    def on_train_begin(self, trainer): ...
    def on_epoch_end(self, trainer, epoch: int, logs: dict): ...
    def on_train_end(self, trainer): ...

    @property
    def stop_training(self) -> bool:
        return False


class History(Callback):
    """Collects per-epoch logs (keras History parity)."""

    def __init__(self):
        self.history = {}

    def on_epoch_end(self, trainer, epoch, logs):
        for k, v in logs.items():
            self.history.setdefault(k, []).append(v)


class JSONLLogger(Callback):
    """Append one JSON line of metrics per epoch to a file, flushed as it
    is written, so a killed run leaves a record up to its last finished
    epoch. Under ``torch.distributed`` only rank 0 writes.

    Line schema: ``{"epoch": E, "step": S, "wall_time": unix_seconds,
    <metric>: value, ...}``.
    """

    def __init__(self, filepath):
        self.filepath = pathlib.Path(filepath)

    @staticmethod
    def _is_primary() -> bool:
        dist = torch.distributed
        return not (dist.is_available() and dist.is_initialized()) \
            or dist.get_rank() == 0

    def on_train_begin(self, trainer):
        if self._is_primary():
            self.filepath.parent.mkdir(parents=True, exist_ok=True)

    def on_epoch_end(self, trainer, epoch, logs):
        if not self._is_primary():
            return
        record = {"epoch": epoch + 1,
                  "step": int(trainer.state["step"]),
                  "wall_time": time.time()}
        record.update({k: float(v) for k, v in logs.items()})
        with open(self.filepath, "a") as f:
            f.write(json.dumps(record) + "\n")
            f.flush()


class ModelCheckpoint(Callback):
    """Best-metric train-state checkpointing (monitor
    ``val_masked_accuracy``, save_best_only). Saves the full train state
    (params, optimizer state, step, seed, epoch, best value), so resume is
    exact."""

    def __init__(self, filepath, monitor: str = "val_masked_accuracy",
                 mode: str = "max", save_best_only: bool = True,
                 verbose: bool = True):
        self.filepath = pathlib.Path(filepath)
        self.monitor = monitor
        self.mode = mode
        self.save_best_only = save_best_only
        self.verbose = verbose
        self.best: float = -math.inf if mode == "max" else math.inf
        self._warned_missing_monitor = False

    def _improved(self, value: float) -> bool:
        return value > self.best if self.mode == "max" else value < self.best

    def on_train_begin(self, trainer):
        # adopt a resumed checkpoint's high-water mark, so the first epoch
        # after a restart does not overwrite a better checkpoint
        restored = getattr(trainer, "_best_monitor_value", None)
        if (restored is not None and math.isfinite(restored)
                and not math.isfinite(self.best)):
            self.best = float(restored)

    def on_epoch_end(self, trainer, epoch, logs):
        value = logs.get(self.monitor)
        if value is None and self.save_best_only:
            if not self._warned_missing_monitor:
                print(f"[checkpoint] monitor {self.monitor!r} is not in "
                      f"the epoch logs ({sorted(logs)}); skipping saves — "
                      f"monitor a train metric or pass "
                      f"save_best_only=False to save every epoch")
                self._warned_missing_monitor = True
            return
        if self.save_best_only and not self._improved(float(value)):
            return
        if value is not None:
            self.best = float(value)
        trainer._best_monitor_value = self.best
        trainer.save_checkpoint(self.filepath)
        if self.verbose:
            print(f"[checkpoint] epoch {epoch}: saved to {self.filepath} "
                  f"({self.monitor}={value})")


class EarlyStopping(Callback):
    """Stop when the monitored metric plateaus (keras EarlyStopping parity)."""

    def __init__(self, monitor: str = "val_loss", patience: int = 5,
                 mode: str = "min", min_delta: float = 0.0,
                 restore_best_weights: bool = False):
        self.monitor = monitor
        self.patience = patience
        self.mode = mode
        self.min_delta = abs(min_delta)
        self.restore_best_weights = restore_best_weights
        self.best = -math.inf if mode == "max" else math.inf
        self.best_state = None
        self.wait = 0
        self._stop = False

    @property
    def stop_training(self) -> bool:
        return self._stop

    def _improved(self, value: float) -> bool:
        if self.mode == "max":
            return value > self.best + self.min_delta
        return value < self.best - self.min_delta

    def on_epoch_end(self, trainer, epoch, logs):
        value = logs.get(self.monitor)
        if value is None:
            return
        if self._improved(float(value)):
            self.best = float(value)
            self.wait = 0
            if self.restore_best_weights:
                # a copy: the train step updates the state in place
                self.best_state = _snapshot_tree(trainer.state)
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self._stop = True
                if self.restore_best_weights and self.best_state is not None:
                    trainer.state = self.best_state
