"""Train state + optimizer factory (counterpart of
``laryngeal_tpu/train/state.py``).

Adam and AdamW on ``torch.optim`` with optax's semantics: b1 = 0.9,
b2 = 0.999, eps = 1e-8 added outside the square root of the bias-corrected
second moment, and (AdamW) decoupled weight decay lr * wd * p on every
parameter, biases and LayerNorm scales included, as ``optax.adamw`` does
with no mask. The learning rate lives in the optimizer's ``param_groups``,
so the host-side ReduceLROnPlateau (train/selection.py) rewrites it between
epochs.

A trainable mask (``models.resnet.backbone_param_mask``: the resnet50_lstm
trunk frozen) is the counterpart of the JAX package's ``_freeze_by_mask``:
a frozen parameter gets ``requires_grad_(False)`` and stays out of the
optimizer, so it takes no update and keeps no Adam moments. JAX computes
those gradients only to zero them. Its module's BatchNorm statistics still
move in train mode.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

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
                       learning_rate: float = 1e-3, weight_decay: float = 0.0,
                       trainable_mask: Optional[Dict[str, bool]] = None) -> TrainState:
    """``model`` already on its device (the optimizer state follows it).
    ``trainable_mask`` maps parameter names to trainable; the others are
    frozen (``requires_grad_(False)``) and left out of the optimizer."""
    params = []
    for name, p in model.named_parameters():
        if trainable_mask is None or trainable_mask[name]:
            params.append(p)
        else:
            p.requires_grad_(False)
    return TrainState(model, make_optimizer(optimizer, params, learning_rate, weight_decay))


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    """Rewrite the learning rate of every parameter group (host-side)."""
    for group in state.optimizer.param_groups:
        group["lr"] = float(lr)
    return state


def get_learning_rate(state: TrainState) -> float:
    return float(state.optimizer.param_groups[0]["lr"])
