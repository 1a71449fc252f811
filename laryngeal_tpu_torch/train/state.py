"""Train state + optimizer factory (counterpart of
``laryngeal_tpu/train/state.py``).

Adam and AdamW on ``torch.optim`` with optax's semantics: b1 = 0.9,
b2 = 0.999, eps = 1e-8 added outside the square root of the bias-corrected
second moment, and (AdamW) decoupled weight decay lr * wd * p on every
parameter, biases and LayerNorm scales included, as ``optax.adamw`` does
with no mask. The learning rate lives in the optimizer's ``param_groups``,
so the host-side ReduceLROnPlateau (train/selection.py) rewrites it between
epochs. The JAX package's ``_freeze_by_mask`` (the resnet50_lstm trunk) is
not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import torch

BETAS = (0.9, 0.999)
EPS = 1e-8


def make_optimizer(name: str, params: Iterable[torch.nn.Parameter], learning_rate: float,
                   weight_decay: float = 0.0) -> torch.optim.Optimizer:
    """'adam' | 'adamw' over ``params``."""
    if name == "adam":
        return torch.optim.Adam(params, lr=learning_rate, betas=BETAS, eps=EPS)
    if name == "adamw":
        return torch.optim.AdamW(params, lr=learning_rate, betas=BETAS, eps=EPS,
                                 weight_decay=weight_decay)
    raise ValueError(f"Unknown optimizer {name!r}")


@dataclasses.dataclass
class TrainState:
    """The model (parameters on the device), its optimizer and the number of
    optimizer steps taken."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def create_train_state(model: torch.nn.Module, optimizer: str = "adam",
                       learning_rate: float = 1e-3, weight_decay: float = 0.0) -> TrainState:
    """``model`` already on its device (the optimizer state follows it)."""
    return TrainState(model, make_optimizer(optimizer, model.parameters(), learning_rate,
                                            weight_decay))


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    """Rewrite the learning rate of every parameter group (host-side)."""
    for group in state.optimizer.param_groups:
        group["lr"] = float(lr)
    return state


def get_learning_rate(state: TrainState) -> float:
    return float(state.optimizer.param_groups[0]["lr"])
