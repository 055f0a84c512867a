"""NMS-free top-k box decoding.

Counterpart of ``unibev_tpu/core/bbox/coders.py``: sigmoid scores over all
(query, class) pairs, flat top-k (``max_num``), label = flat index mod
num_classes, denormalize, then a post-center-range validity mask.  Scores
are decoded in float32.  The reference's score-threshold decay is not
ported: no config sets ``score_threshold``.
"""

from __future__ import annotations

from typing import Dict

import torch

from unibev_tpu_torch.core.bbox.util import denormalize_bbox
from unibev_tpu_torch.registry import BBOX_CODERS


@BBOX_CODERS.register_module()
class NMSFreeCoder:
    def __init__(self, pc_range, post_center_range=None, max_num: int = 100,
                 num_classes: int = 10):
        # pc_range: part of every bbox_coder config; decoding does not use it
        self.post_center_range = post_center_range
        self.max_num = max_num
        self.num_classes = num_classes

    def decode(self, all_cls_scores: torch.Tensor,
               all_bbox_preds: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Decode the last decoder layer of every batch element.

        all_cls_scores (L, B, Q, num_cls) logits; all_bbox_preds (L, B, Q, 10).
        Returns bboxes (B, max_num, 9), scores, labels and valid (B, max_num).
        """
        cls_scores = all_cls_scores[-1].float()
        bbox_preds = all_bbox_preds[-1].float()
        B = cls_scores.shape[0]
        scores, idx = torch.sigmoid(cls_scores).reshape(B, -1).topk(self.max_num)
        labels = (idx % self.num_classes).to(torch.int32)
        query_idx = idx // self.num_classes
        boxes = denormalize_bbox(torch.gather(
            bbox_preds, 1, query_idx[..., None].expand(-1, -1, bbox_preds.shape[-1])))

        valid = torch.ones_like(scores, dtype=torch.bool)
        if self.post_center_range is not None:
            pcr = self.post_center_range
            centers = boxes[..., :3]
            valid &= (centers >= centers.new_tensor(pcr[:3])).all(dim=-1)
            valid &= (centers <= centers.new_tensor(pcr[3:])).all(dim=-1)
        return dict(bboxes=boxes, scores=scores, labels=labels, valid=valid)
