"""NMS-free top-k box decoding.

Counterpart of ``unibev_tpu/core/bbox/coders.py``: sigmoid scores over all
(query, class) pairs, flat top-k (``max_num``), label = flat index mod
num_classes, denormalize, then a post-center-range validity mask.  Scores
are decoded in float32.

With ``score_threshold`` the reference relaxes the threshold by 0.9x until
some box clears it, or lets every box through once it falls below 0.01.
As in the JAX package, that loop is a static ladder of thresholds compared
at once: strictly above the threshold itself, at or above each decayed
rung, the first rung any box clears deciding; no host loop, no sync.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.reference.core.bbox.util import denormalize_bbox
from benchmark.reference.registry import BBOX_CODERS


def decay_ladder(threshold: float) -> List[float]:
    """The decayed thresholds the reference tries after ``threshold``: 0.9x
    each, in float32, while at least 0.01."""
    ladder = []
    t = np.float32(threshold)
    while True:
        t = np.float32(t * np.float32(0.9))
        if t < np.float32(0.01):
            return ladder
        ladder.append(float(t))


@BBOX_CODERS.register_module()
class NMSFreeCoder:
    def __init__(self, pc_range, post_center_range=None, max_num: int = 100,
                 score_threshold: Optional[float] = None,
                 num_classes: int = 10, voxel_size=None):
        # pc_range and voxel_size: part of the reference's bbox_coder
        # configs; decoding does not use them
        self.post_center_range = post_center_range
        self.max_num = max_num
        self.score_threshold = score_threshold
        self.num_classes = num_classes
        self.ladder = (None if score_threshold is None
                       else decay_ladder(score_threshold))

    def score_mask(self, scores: torch.Tensor) -> torch.Tensor:
        """(B, max_num) bool: the top-k scores kept by the threshold decay."""
        pass0 = scores > self.score_threshold
        if self.ladder:
            rungs = torch.tensor(self.ladder, dtype=torch.float32,
                                 device=scores.device)
            passes = scores[..., None] >= rungs                  # (B, k, R)
            anyk = passes.any(dim=1)                             # (B, R)
            first = anyk.to(torch.uint8).argmax(dim=1)           # first rung
            relaxed = torch.gather(passes, 2, first[:, None, None].expand(
                -1, passes.shape[1], 1))[..., 0]
            relaxed = torch.where(anyk.any(dim=1, keepdim=True), relaxed, True)
        else:
            relaxed = torch.ones_like(pass0)
        return torch.where(pass0.any(dim=1, keepdim=True), pass0, relaxed)

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
        if self.score_threshold is not None:
            valid &= self.score_mask(scores)
        if self.post_center_range is not None:
            pcr = self.post_center_range
            centers = boxes[..., :3]
            valid &= (centers >= centers.new_tensor(pcr[:3])).all(dim=-1)
            valid &= (centers <= centers.new_tensor(pcr[3:])).all(dim=-1)
        return dict(bboxes=boxes, scores=scores, labels=labels, valid=valid)
