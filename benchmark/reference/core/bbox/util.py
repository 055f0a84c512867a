"""3D box (de)normalization in the UniBEV/BEVFormer regression space.

Counterpart of ``unibev_tpu/core/bbox/util.py``: a LiDAR-frame box
``(cx, cy, cz, w, l, h, rot[, vx, vy])`` maps to the 10-dof layout
``(cx, cy, log w, log l, cz, log h, sin r, cos r[, vx, vy])`` that the L1
loss and the Hungarian match cost use, and back.
"""

from __future__ import annotations

import torch


def normalize_bbox(bboxes: torch.Tensor) -> torch.Tensor:
    """(..., 7 or 9) LiDAR boxes -> (..., 8 or 10) normalized regression
    targets; sizes clipped at 1e-5 before the log."""
    sizes = bboxes[..., 3:6].clamp(min=1e-5).log()
    rot = bboxes[..., 6:7]
    parts = [bboxes[..., 0:2], sizes[..., 0:2], bboxes[..., 2:3],
             sizes[..., 2:3], rot.sin(), rot.cos()]
    if bboxes.shape[-1] > 7:
        parts.append(bboxes[..., 7:9])
    return torch.cat(parts, dim=-1)


def denormalize_bbox(normalized: torch.Tensor) -> torch.Tensor:
    """(..., 8 or 10) normalized boxes -> (..., 7 or 9) LiDAR boxes;
    rotation via atan2(sin, cos)."""
    parts = [normalized[..., 0:2], normalized[..., 4:5],
             normalized[..., 2:4].exp(), normalized[..., 5:6].exp(),
             torch.atan2(normalized[..., 6:7], normalized[..., 7:8])]
    if normalized.shape[-1] > 8:
        parts.append(normalized[..., 8:10])
    return torch.cat(parts, dim=-1)
