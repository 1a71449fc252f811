"""Loss library and logits -> probabilities (counterpart of
``laryngeal_tpu/train/losses.py``).

- Cross-entropy on 2-class logits (vivit/timesformer/resnet3d/swin trainers).
- BCE-with-logits with pos_weight (2d-lstm,
  ``resnet50-2d-lstm/src/trainer/trainer.py:35-42``), where
  ``pos_weight = 1.5 * n_neg / n_pos``.

Every loss takes an optional per-sample validity mask (padded final batches)
and reduces with a masked mean. Losses are computed in float32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return x.mean()
    mask = mask.to(x.dtype)
    return (x * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE over integer labels; logits (B, C)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels.long()[:, None])[:, 0]
    return _masked_mean(nll, mask)


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor, pos_weight: float = 1.0,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """torch BCEWithLogitsLoss(pos_weight) semantics; logits (B,) or (B, 1)."""
    x = logits.reshape(-1).float()
    y = labels.reshape(-1).float()
    loss = -(pos_weight * y * F.logsigmoid(x) + (1.0 - y) * F.logsigmoid(-x))
    return _masked_mean(loss, mask)


def reference_pos_weight(num_pos: int, num_neg: int, scale: float = 1.5) -> float:
    """The 2d-lstm trainer's class weighting (trainer.py:35-42)."""
    if num_pos <= 0:
        return scale
    return float(num_neg) / float(num_pos) * scale


def make_loss_fn(loss: str, pos_weight: float = 1.0):
    """'ce' | 'bce_pos_weight' -> callable(logits, labels, mask)."""
    if loss == "ce":
        return cross_entropy
    if loss == "bce_pos_weight":
        def fn(logits, labels, mask=None):
            return bce_with_logits(logits, labels, pos_weight=pos_weight, mask=mask)
        return fn
    raise ValueError(f"Unknown loss {loss!r}")


def binary_probs_from_logit(logits: torch.Tensor) -> torch.Tensor:
    """(B,) or (B, 1) single-logit head -> (B, 2) class probabilities."""
    p1 = torch.sigmoid(logits.reshape(-1).float())
    return torch.stack([1.0 - p1, p1], dim=-1)


def _softmax_probs(logits: torch.Tensor) -> torch.Tensor:
    return torch.softmax(logits.float(), dim=-1)


def probs_fn(loss: str):
    """Logits -> (B, 2) probabilities, per head type (softmax vs sigmoid)."""
    if loss == "ce":
        return _softmax_probs
    if loss == "bce_pos_weight":
        return binary_probs_from_logit
    raise ValueError(f"Unknown loss {loss!r}")
