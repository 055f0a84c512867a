"""3D box denormalization from the UniBEV/BEVFormer regression space.

Counterpart of ``unibev_tpu/core/bbox/util.py::denormalize_bbox``: the 10-dof
layout ``(cx, cy, log w, log l, cz, log h, sin r, cos r[, vx, vy])`` maps
back to a LiDAR-frame box ``(cx, cy, cz, w, l, h, rot[, vx, vy])``.
``normalize_bbox`` (the regression targets) comes with the loss.
"""

from __future__ import annotations

import torch


def denormalize_bbox(normalized: torch.Tensor) -> torch.Tensor:
    """(..., 8 or 10) normalized boxes -> (..., 7 or 9) LiDAR boxes;
    rotation via atan2(sin, cos)."""
    parts = [normalized[..., 0:2], normalized[..., 4:5],
             normalized[..., 2:4].exp(), normalized[..., 5:6].exp(),
             torch.atan2(normalized[..., 6:7], normalized[..., 7:8])]
    if normalized.shape[-1] > 8:
        parts.append(normalized[..., 8:10])
    return torch.cat(parts, dim=-1)
