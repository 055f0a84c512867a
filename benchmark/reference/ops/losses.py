"""Detection losses: sigmoid focal loss and L1.

Counterpart of ``unibev_tpu/ops/losses.py`` (the reference's CUDA
``sigmoid_focal_loss`` and mmdet's ``L1Loss``).  Labels equal to
``num_classes`` mean background and give an all-zero one-hot row, so padded
or unmatched queries count only as negatives.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.registry import LOSSES


def sigmoid_focal_loss(logits: torch.Tensor, labels: torch.Tensor,
                       num_classes: int, alpha: float = 0.25,
                       gamma: float = 2.0) -> torch.Tensor:
    """Per-element focal loss (..., num_classes); sum over classes for the
    per-sample loss.  logits (..., num_classes); labels (...,) integer."""
    onehot = F.one_hot(labels.long(), num_classes + 1)[..., :num_classes]
    onehot = onehot.to(logits.dtype)
    p = torch.sigmoid(logits)
    ce = (logits.clamp(min=0) - logits * onehot
          + torch.log1p(torch.exp(-logits.abs())))
    p_t = p * onehot + (1 - p) * (1 - onehot)
    alpha_t = alpha * onehot + (1 - alpha) * (1 - onehot)
    return alpha_t * (1 - p_t) ** gamma * ce


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred - target).abs()


def _reduce(loss, weight, avg_factor, loss_weight):
    if weight is not None:
        loss = loss * weight
    total = loss.sum()
    if avg_factor is not None:
        total = total / torch.clamp(torch.as_tensor(avg_factor, dtype=total.dtype,
                                                    device=total.device), min=1e-6)
    return total * loss_weight


@LOSSES.register_module()
class FocalLoss:
    def __init__(self, use_sigmoid: bool = True, gamma: float = 2.0,
                 alpha: float = 0.25, loss_weight: float = 1.0):
        if not use_sigmoid:
            raise NotImplementedError("FocalLoss: only use_sigmoid=True")
        self.gamma = gamma
        self.alpha = alpha
        self.loss_weight = loss_weight

    def __call__(self, logits, labels, weight=None, avg_factor=None):
        loss = sigmoid_focal_loss(logits, labels, logits.shape[-1],
                                  alpha=self.alpha, gamma=self.gamma).sum(-1)
        return _reduce(loss, weight, avg_factor, self.loss_weight)


@LOSSES.register_module()
class L1Loss:
    def __init__(self, loss_weight: float = 1.0):
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None):
        return _reduce(l1_loss(pred, target), weight, avg_factor,
                       self.loss_weight)
