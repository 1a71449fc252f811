"""Model-selection policies + early stopping + LR plateau scheduling.

The port's own copy of ``laryngeal_tpu/train/selection.py`` (pure Python).

All three reference policies, one interface each returns ``True`` when the
current epoch's model should be checkpointed as best:

- ``MinLossSelection``   — min validation loss (vivit/timesformer,
  ``vivit_transformer/.../utils/early_stopping.py:25-40``).
- ``CompositeSelection`` — ``loss_weight * normalized_loss +
  (1-loss_weight) * val_auroc`` (2d-lstm,
  ``resnet50-2d-lstm/src/trainer/trainer.py:99-122``).
- ``LossAccThresholdSelection`` — loss improved AND accuracy within
  ``acc_threshold`` of the best (resnet3d/swin,
  ``resnet50-3d-video/.../trainers/trainer.py:57-70``).

``EarlyStopping`` reproduces the reference counter (patience/delta on min
val loss). ``ReduceLROnPlateau`` reproduces torch's scheduler as configured
by the 2d-lstm trainer (mode='max' on val AUROC, factor 0.5, patience 5).
"""

from __future__ import annotations

import inspect
from typing import Optional


class MinLossSelection:
    def __init__(self):
        self.best_loss = float("inf")

    def __call__(self, val_loss: float, **_) -> bool:
        if val_loss < self.best_loss:
            self.best_loss = val_loss
            return True
        return False


class CompositeSelection:
    """Composite of normalized loss and AUROC (see module doc)."""

    def __init__(self, loss_weight: float = 0.3):
        self.loss_weight = float(loss_weight)
        self.auroc_weight = 1.0 - self.loss_weight
        self.best_composite = -float("inf")
        self.best_val_loss = float("inf")
        self.best_val_auroc = 0.0

    def __call__(self, val_loss: float, val_auroc: float = 0.0, **_) -> bool:
        best_val_loss = min(self.best_val_loss, val_loss)
        normalized_loss = best_val_loss / max(val_loss, 1e-10)
        composite = self.loss_weight * normalized_loss + self.auroc_weight * val_auroc
        if composite > self.best_composite:
            self.best_composite = composite
            self.best_val_loss = val_loss
            self.best_val_auroc = val_auroc
            return True
        return False


class LossAccThresholdSelection:
    """Save when loss improves AND accuracy is within acc_threshold of best."""

    def __init__(self, acc_threshold: float = 0.02):
        self.acc_threshold = float(acc_threshold)
        self.best_loss = float("inf")
        self.best_acc = 0.0

    def __call__(self, val_loss: float, val_acc: float = 0.0, **_) -> bool:
        self.best_acc = max(self.best_acc, val_acc)
        if val_loss < self.best_loss and val_acc >= self.best_acc - self.acc_threshold:
            self.best_loss = val_loss
            return True
        return False


SELECTION_POLICIES = {
    "min_loss": MinLossSelection,
    "composite": CompositeSelection,
    "loss_acc_threshold": LossAccThresholdSelection,
}


def make_selection(policy: str, **kwargs):
    if policy not in SELECTION_POLICIES:
        raise ValueError(f"Unknown selection policy {policy!r}")
    cls = SELECTION_POLICIES[policy]
    accepted = set(inspect.signature(cls.__init__).parameters)
    return cls(**{k: v for k, v in kwargs.items() if k in accepted})


class EarlyStopping:
    """Min-val-loss early stopping with patience/delta
    (vivit_transformer/.../utils/early_stopping.py:4-56)."""

    def __init__(self, patience: int = 7, delta: float = 0.0):
        self.patience = int(patience)
        self.delta = float(delta)
        self.counter = 0
        self.best_loss: Optional[float] = None
        self.should_stop = False

    def __call__(self, val_loss: float) -> bool:
        """Returns True when this epoch improved (checkpoint-worthy)."""
        if self.best_loss is None or val_loss < self.best_loss - self.delta:
            self.best_loss = val_loss
            self.counter = 0
            return True
        self.counter += 1
        if self.counter >= self.patience:
            self.should_stop = True
        return False


class ReduceLROnPlateau:
    """torch ReduceLROnPlateau subset (mode max/min, factor, patience)."""

    def __init__(self, lr: float, mode: str = "max", factor: float = 0.5,
                 patience: int = 5, min_lr: float = 0.0):
        if mode not in ("max", "min"):
            raise ValueError(f"mode must be 'max' or 'min', got {mode!r}")
        self.lr = float(lr)
        self.mode = mode
        self.factor = float(factor)
        self.patience = int(patience)
        self.min_lr = float(min_lr)
        self.best: Optional[float] = None
        self.counter = 0

    def step(self, metric: float) -> float:
        improved = (
            self.best is None
            or (self.mode == "max" and metric > self.best)
            or (self.mode == "min" and metric < self.best)
        )
        if improved:
            self.best = metric
            self.counter = 0
        else:
            self.counter += 1
            if self.counter > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.counter = 0
        return self.lr
