"""Match costs of the Hungarian assignment.

Counterpart of ``unibev_tpu/core/bbox/match_costs.py``: mmdet's
``FocalLossCost`` and the reference's ``BBox3DL1CostBEVFormer`` (a weighted
L1 distance over the first 8 normalized box dims).  Both take any leading
batch dims.
"""

from __future__ import annotations

import torch

from benchmark.reference.registry import MATCH_COSTS


@MATCH_COSTS.register_module()
class FocalLossCost:
    """cost[q, g] = focal positive cost - focal negative cost of query q's
    score for gt g's label."""

    def __init__(self, weight: float = 1.0, alpha: float = 0.25,
                 gamma: float = 2.0, eps: float = 1e-12):
        self.weight = weight
        self.alpha = alpha
        self.gamma = gamma
        self.eps = eps

    def __call__(self, cls_pred: torch.Tensor, gt_labels: torch.Tensor) -> torch.Tensor:
        """cls_pred (..., Q, num_cls) logits; gt_labels (..., G) -> (..., Q, G)."""
        p = 1.0 / (1.0 + torch.exp(-cls_pred))
        neg = -torch.log1p(-p + self.eps) * p ** self.gamma * (1 - self.alpha)
        pos = -torch.log(p + self.eps) * (1 - p) ** self.gamma * self.alpha
        diff = pos - neg
        labels = gt_labels.long()[..., None, :].expand(
            *diff.shape[:-1], gt_labels.shape[-1])
        return torch.gather(diff, -1, labels) * self.weight


@MATCH_COSTS.register_module(name="BBox3DL1CostBEVFormer")
class BBox3DL1Cost:
    """Weighted L1 distance between normalized boxes."""

    def __init__(self, weight: float = 1.0):
        self.weight = weight

    def __call__(self, bbox_pred: torch.Tensor, gt_bboxes: torch.Tensor) -> torch.Tensor:
        """bbox_pred (..., Q, D); gt_bboxes (..., G, D) -> (..., Q, G)."""
        cost = (bbox_pred[..., :, None, :] - gt_bboxes[..., None, :, :]).abs().sum(-1)
        return cost * self.weight
