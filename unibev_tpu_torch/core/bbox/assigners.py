"""Hungarian assigner for the 3D DETR-style head.

Counterpart of ``unibev_tpu/core/bbox/assigners.py::HungarianAssigner3D``
with the same ``(gt_inds, pos_mask)`` contract: cost = focal class cost +
L1 cost over the first 8 normalized box dims, NaN and inf mapped to +-1e4,
solved exactly over the valid gt rows; padded gt rows receive no query.
The reference configs carry an ``iou_cost`` at weight 0, a placeholder
neither package computes; a nonzero weight raises.
The solve is ``scipy.optimize.linear_sum_assignment`` on the host, which is
the reference's own choice (the JAX package's in-graph Jonker-Volgenant
stays JAX-only).  The costs of every problem in a batch are built on the
device and copied to the host in one transfer.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

from unibev_tpu_torch.core.bbox import match_costs  # noqa: F401 (registers)
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
        cost = (self.cls_cost(cls_pred.float(), gt_labels)
                + self.reg_cost(bbox_pred[..., :8].float(),
                                normalize_bbox(gt_bboxes.float())[..., :8]))
        cost = torch.nan_to_num(cost, nan=1e4, posinf=1e4, neginf=-1e4)
        cost = cost.reshape(-1, Q, G).cpu().numpy()
        valid = gt_valid.reshape(-1, G).cpu().numpy().astype(bool)
        gt_inds = np.zeros(cost.shape[:2], np.int64)
        pos = np.zeros(cost.shape[:2], bool)
        for i in range(cost.shape[0]):
            rows = np.flatnonzero(valid[i])
            if rows.size == 0:
                continue
            r, c = linear_sum_assignment(cost[i][:, rows].T)
            gt_inds[i, c] = rows[r]
            pos[i, c] = True
        dev = bbox_pred.device
        return (torch.from_numpy(gt_inds).reshape(*lead, Q).to(dev),
                torch.from_numpy(pos).reshape(*lead, Q).to(dev))
