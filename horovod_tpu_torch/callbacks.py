"""Training-loop callbacks (the Keras callback family, framework-neutral).

The port of ``horovod_tpu/callbacks.py`` (reference
horovod/_keras/callbacks.py, _keras/elastic.py): plain objects an
explicit training loop invokes. ``BroadcastGlobalVariablesCallback``
broadcasts a module's (or a state dict's) tensors from the root in
place; ``MetricAverageCallback`` averages numeric logs over the ranks
with the port's ``allreduce`` (in float32, as the JAX callback does);
the learning-rate callbacks give the JAX callbacks' multipliers and
schedules as Python floats, for the loop to write into an optimizer's
``param_groups``; the elastic callbacks commit and track cursors in an
elastic ``State``.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional


class Callback:
    def on_train_begin(self, state: Any = None) -> Any:
        return state

    def on_epoch_begin(self, epoch: int, state: Any = None) -> Any:
        return state

    def on_batch_end(self, batch: int, state: Any = None) -> Any:
        return state

    def on_epoch_end(self, epoch: int, logs: Optional[Dict] = None,
                     state: Any = None) -> Any:
        return state


class BroadcastGlobalVariablesCallback(Callback):
    """Broadcast the initial parameters from the root at train start
    (reference _keras/callbacks.py BroadcastGlobalVariablesCallback):
    ``state`` is an ``nn.Module`` or a state dict, updated in place and
    returned."""

    def __init__(self, root_rank: int = 0):
        self.root_rank = root_rank

    def on_train_begin(self, state):
        import torch

        from .optim.functions import broadcast_parameters

        tensors = (state.state_dict() if isinstance(state, torch.nn.Module)
                   else state)
        broadcast_parameters(tensors, root_rank=self.root_rank)
        return state


class MetricAverageCallback(Callback):
    """Allreduce-average metric values across ranks at epoch end
    (reference MetricAverageCallback): numbers and numeric arrays or
    tensors, in float32 like the JAX callback."""

    def on_epoch_end(self, epoch, logs=None, state=None):
        if logs:
            import numpy as np
            import torch

            from .core import basics
            from .ops.collectives import allreduce

            dev = basics.device()
            for k, v in list(logs.items()):
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    reduced = allreduce(
                        torch.tensor([float(v)], dtype=torch.float32,
                                     device=dev),
                        average=True, name=f"metric.{k}")
                    logs[k] = float(reduced.cpu()[0])
                elif (torch.is_tensor(v) or (hasattr(v, "dtype") and
                                             np.issubdtype(np.asarray(
                                                 v).dtype, np.number))):
                    arr = v if torch.is_tensor(v) else torch.from_numpy(
                        np.asarray(v, dtype=np.float32))
                    reduced = allreduce(
                        arr.to(dev).reshape(-1), average=True,
                        name=f"metric.{k}").reshape(arr.shape)
                    logs[k] = (float(reduced) if arr.ndim == 0
                               else reduced.cpu().numpy())
        return state


class LearningRateWarmupCallback(Callback):
    """Linearly ramp the LR multiplier from 1 to `size` over warmup epochs
    (reference _keras/callbacks.py LearningRateWarmupCallback: multiplier
    = 1 + epoch * (size - 1) / warmup_epochs — the gradual-warmup trick
    from the large-minibatch SGD recipe). Exposes `scale(epoch)` for
    explicit loops and a step -> learning rate schedule via
    `as_schedule`.

    `momentum_correction` is accepted for reference-API compatibility:
    the loop multiplies an SGD optimizer's momentum by
    `momentum_correction_factor(prev_epoch, epoch)` when it changes the
    learning rate; nothing is applied automatically here.
    """

    def __init__(self, warmup_epochs: float = 5.0,
                 momentum_correction: bool = True,
                 steps_per_epoch: Optional[int] = None, verbose: int = 0,
                 initial_lr: Optional[float] = None,
                 size: Optional[int] = None):
        from .core import basics

        self.warmup_epochs = warmup_epochs
        self.momentum_correction = momentum_correction
        self.steps_per_epoch = steps_per_epoch
        self.verbose = verbose
        self.size = size if size is not None else (
            basics.size() if basics.is_initialized() else 1
        )
        self.initial_lr = initial_lr

    def scale(self, epoch: float) -> float:
        """Multiplier on the base (single-rank) LR at fractional epoch."""
        if epoch >= self.warmup_epochs:
            return float(self.size)
        return 1.0 + epoch * (self.size - 1.0) / self.warmup_epochs

    def momentum_correction_factor(self, prev_epoch: float,
                                   epoch: float) -> float:
        """Multiply SGD momentum by this when the LR changes mid-warmup
        (reference callbacks.py momentum correction: new_lr/old_lr)."""
        if not self.momentum_correction:
            return 1.0
        return self.scale(epoch) / max(self.scale(prev_epoch), 1e-12)

    def as_schedule(self, steps_per_epoch: int,
                    base_lr: Optional[float] = None
                    ) -> Callable[[int], float]:
        if base_lr is None:
            base_lr = self.initial_lr
        if base_lr is None:
            raise ValueError(
                "pass base_lr to as_schedule or initial_lr at construction"
            )

        def schedule(step):
            epoch = min(step / steps_per_epoch, float(self.warmup_epochs))
            return base_lr * (
                1.0 + epoch * (self.size - 1.0) / self.warmup_epochs
            )

        return schedule


class LearningRateScheduleCallback(Callback):
    """Piecewise LR multiplier over epochs
    (reference LearningRateScheduleCallback)."""

    def __init__(self, multiplier, start_epoch: int = 0,
                 end_epoch: Optional[int] = None, staircase: bool = True):
        self.multiplier = (
            multiplier if callable(multiplier) else (lambda e: multiplier)
        )
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch
        self.staircase = staircase

    def scale(self, epoch: float) -> float:
        if epoch < self.start_epoch:
            return 1.0
        if self.end_epoch is not None and epoch >= self.end_epoch:
            return 1.0
        e = math.floor(epoch) if self.staircase else epoch
        return float(self.multiplier(e))


class EarlyStoppingCallback(Callback):
    """Stop training when a monitored metric stops improving — the
    Lightning estimator's early-stop surface (reference
    spark/lightning/estimator.py ships pytorch_lightning's
    EarlyStopping through its callbacks param; semantics follow
    keras.callbacks.EarlyStopping).

    Sets ``self.stop_training = True``; a loop checks the flag after
    the epoch-end callbacks and, averaging the metric first
    (``MetricAverageCallback``), stops every rank in the same epoch. ``best`` and ``stopped_epoch`` are left on the instance
    for inspection.
    """

    def __init__(self, monitor: str = "val_loss", min_delta: float = 0.0,
                 patience: int = 0, mode: str = "min"):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        self.monitor = monitor
        self.min_delta = abs(float(min_delta))
        self.patience = int(patience)
        self.mode = mode
        self.stop_training = False
        self.best: Optional[float] = None
        self.stopped_epoch: Optional[int] = None
        self._wait = 0

    def _improved(self, value: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "min":
            return value < self.best - self.min_delta
        return value > self.best + self.min_delta

    def on_train_begin(self, state=None):
        self.stop_training = False
        self.best = None
        self.stopped_epoch = None
        self._wait = 0
        return state

    def on_epoch_end(self, epoch, logs=None, state=None):
        value = (logs or {}).get(self.monitor)
        if value is None:
            return state  # metric absent this epoch: no verdict
        value = float(value)
        if self._improved(value):
            self.best = value
            self._wait = 0
        else:
            self._wait += 1
            if self._wait > self.patience:
                self.stop_training = True
                self.stopped_epoch = epoch
        return state


class CommitStateCallback(Callback):
    """Commit elastic state every N batches and at epoch end
    (reference _keras/elastic.py:17 CommitStateCallbackImpl). More
    frequent commits shrink the replay window after a failure; less
    frequent commits cost less snapshot time."""

    def __init__(self, state, batches_per_commit: int = 1):
        self.state = state
        self.batches_per_commit = max(1, int(batches_per_commit))
        self.batches_remaining = self.batches_per_commit

    def on_train_begin(self, state=None):
        # reset on every sync event for cross-rank consistency
        self.batches_remaining = self.batches_per_commit
        return state

    def on_batch_end(self, batch, state=None):
        self.batches_remaining -= 1
        if self.batches_remaining == 0:
            self.state.commit()
            self.batches_remaining = self.batches_per_commit
        return state

    def on_epoch_end(self, epoch, logs=None, state=None):
        self.state.commit()
        return state


class UpdateBatchStateCallback(Callback):
    """Track the in-epoch batch cursor in elastic state so a restarted
    epoch resumes mid-epoch instead of replaying it (reference
    _keras/elastic.py:42). Pairs with ElasticSampler, whose cursor
    skips already-processed samples."""

    def __init__(self, state):
        self.state = state
        if not hasattr(state, "batch"):
            state.batch = 0
            state.register("batch")

    def on_batch_end(self, batch, state=None):
        self.state.batch = batch
        return state

    def on_epoch_end(self, epoch, logs=None, state=None):
        self.state.batch = 0
        return state


class UpdateEpochStateCallback(Callback):
    """Track the GLOBAL epoch number across elastic resets (reference
    _keras/elastic.py:66): framework epoch counters restart at 0 after
    a reset; the state's does not."""

    def __init__(self, state):
        self.state = state
        if not hasattr(state, "epoch"):
            state.epoch = 0
            state.register("epoch")

    def on_epoch_end(self, epoch, logs=None, state=None):
        self.state.epoch += 1
        return state
