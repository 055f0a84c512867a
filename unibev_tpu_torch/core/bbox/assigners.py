"""Hungarian assigner for the 3D DETR-style head.

Counterpart of ``unibev_tpu/core/bbox/assigners.py::HungarianAssigner3D``
with the same ``(gt_inds, pos_mask)`` contract: cost = focal class cost +
L1 cost over the first 8 normalized box dims, NaN and inf mapped to +-1e4,
solved exactly over the valid gt rows; padded gt rows receive no query.
The reference configs carry an ``iou_cost`` at weight 0, a placeholder
neither package computes; a nonzero weight raises.
The solve stays on the costs' device, as the JAX package's in-graph
Jonker-Volgenant does (``core/bbox/lsa.py``; kernel K12 on CUDA): every
problem of a batch in one call, the assignment scattered back to the
queries there, nothing read on the host.  The reference copies each
problem to the host and solves it there instead.
"""

from __future__ import annotations

from typing import Tuple

import torch

from unibev_tpu_torch.core.bbox import match_costs  # noqa: F401 (registers)
from unibev_tpu_torch.core.bbox.lsa import linear_sum_assignment
from unibev_tpu_torch.core.bbox.util import normalize_bbox
from unibev_tpu_torch.registry import BBOX_ASSIGNERS, MATCH_COSTS


def _cost(cfg, default):
    return MATCH_COSTS.build(dict(cfg or default))


@BBOX_ASSIGNERS.register_module(name="HungarianAssigner3DBEVFormer")
class HungarianAssigner3D:

    def __init__(self, cls_cost=None, reg_cost=None, iou_cost=None,
                 pc_range=None):
        # pc_range is accepted so the reference configs build, and not read;
        # mmdet's IoUCost weighs 1.0 when the config names none
        if iou_cost is not None and dict(iou_cost).get("weight", 1.0) != 0:
            raise ValueError(f"iou_cost {dict(iou_cost)}: the IoU cost is not "
                             f"computed; only weight 0 is accepted")
        self.cls_cost = _cost(cls_cost, dict(type="FocalLossCost", weight=2.0))
        self.reg_cost = _cost(reg_cost, dict(type="BBox3DL1CostBEVFormer",
                                             weight=0.25))

    @torch.no_grad()
    def costs(self, bbox_pred: torch.Tensor, cls_pred: torch.Tensor,
              gt_bboxes: torch.Tensor, gt_labels: torch.Tensor) -> torch.Tensor:
        """The assignment problems of :meth:`assign`'s inputs: (P, G, Q)
        float32, contiguous, P the product of the leading dims; rows gt
        boxes and columns queries, as the JAX package's ``cost.T``."""
        Q, G = bbox_pred.shape[-2], gt_bboxes.shape[-2]
        cost = (self.cls_cost(cls_pred.float(), gt_labels)
                + self.reg_cost(bbox_pred[..., :8].float(),
                                normalize_bbox(gt_bboxes.float())[..., :8]))
        cost = torch.nan_to_num(cost, nan=1e4, posinf=1e4, neginf=-1e4)
        return cost.reshape(-1, Q, G).transpose(1, 2).contiguous()

    @torch.no_grad()
    def assign(self, bbox_pred: torch.Tensor, cls_pred: torch.Tensor,
               gt_bboxes: torch.Tensor, gt_labels: torch.Tensor,
               gt_valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """bbox_pred (..., Q, 10) normalized; cls_pred (..., Q, ncls) logits;
        gt_bboxes (..., G, 9) LiDAR boxes; gt_labels, gt_valid (..., G).

        Returns gt_inds (..., Q) int64, the gt each query is matched to (0
        where it is not), and pos_mask (..., Q) bool, on bbox_pred's device.
        """
        lead = bbox_pred.shape[:-2]
        Q, G = bbox_pred.shape[-2], gt_bboxes.shape[-2]
        valid = gt_valid.reshape(-1, G).bool().contiguous()
        col4row = linear_sum_assignment(
            self.costs(bbox_pred, cls_pred, gt_bboxes, gt_labels), valid)
        # Scatter back to the queries as the JAX package does: an invalid
        # row goes to column 0 with weight 0 (an additive scatter, so it
        # cannot collide with a real assignment at column 0)
        safe = torch.where(valid, col4row, 0).clamp(0, Q - 1).long()
        weight = valid.long()
        pos = torch.zeros(safe.shape[0], Q, dtype=torch.long,
                          device=safe.device).scatter_add_(1, safe, weight) > 0
        gt_inds = torch.zeros_like(pos, dtype=torch.long).scatter_add_(
            1, safe, weight * torch.arange(G, device=safe.device))
        return gt_inds.reshape(*lead, Q), pos.reshape(*lead, Q)
