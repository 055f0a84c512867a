"""torchvision's ``transforms.functional.rotate`` on a float (C, H, W)
tensor, with nearest interpolation, no expansion and zero fill: the call
by which the published BEVFormer (``PerceptionTransformer.
get_bev_features``) aligns the previous frame's BEV map.  torchvision is not
installed; this is its tensor path step by step (``rotate``,
``_get_inverse_affine_matrix``, ``_gen_affine_grid``,
``_apply_grid_transform``): the inverse affine matrix in Python floats, a
float32 grid from the pixel centres by one matrix product, and
``grid_sample``.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch
import torch.nn.functional as F


def _inverse_affine_matrix(center: Sequence[float], angle: float
                           ) -> List[float]:
    """``_get_inverse_affine_matrix(center, angle, [0, 0], 1.0, [0, 0])``."""
    rot = math.radians(angle)
    cx, cy = center
    a, b = math.cos(rot), -math.sin(rot)
    c, d = math.sin(rot), math.cos(rot)
    matrix = [d, -b, 0.0, -c, a, 0.0]
    matrix[2] += matrix[0] * (-cx) + matrix[1] * (-cy)
    matrix[5] += matrix[3] * (-cx) + matrix[4] * (-cy)
    matrix[2] += cx
    matrix[5] += cy
    return matrix


def _affine_grid(theta: torch.Tensor, w: int, h: int) -> torch.Tensor:
    """``_gen_affine_grid(theta, w, h, ow=w, oh=h)``: (1, h, w, 2)."""
    d = 0.5
    base = torch.empty(1, h, w, 3, dtype=theta.dtype, device=theta.device)
    base[..., 0].copy_(torch.linspace(-w * 0.5 + d, w * 0.5 + d - 1, steps=w,
                                      device=theta.device))
    base[..., 1].copy_(torch.linspace(-h * 0.5 + d, h * 0.5 + d - 1, steps=h,
                                      device=theta.device).unsqueeze_(-1))
    base[..., 2].fill_(1)
    scale = torch.tensor([0.5 * w, 0.5 * h], dtype=theta.dtype,
                         device=theta.device)
    grid = base.view(1, h * w, 3).bmm(theta.transpose(1, 2) / scale)
    return grid.view(1, h, w, 2)


def rotate(img: torch.Tensor, angle: float, center: Sequence[float]
           ) -> torch.Tensor:
    """``img`` (C, H, W) rotated by ``angle`` degrees (counter-clockwise as
    displayed) about ``center`` (x, y) in pixels."""
    _, h, w = img.shape
    center_f = [1.0 * (c - s * 0.5) for c, s in zip(center, [w, h])]
    # torchvision passes -angle: its affine and rotate differ in direction
    matrix = _inverse_affine_matrix(center_f, -float(angle))
    theta = torch.tensor(matrix, dtype=img.dtype,
                         device=img.device).reshape(1, 2, 3)
    grid = _affine_grid(theta, w, h)
    return F.grid_sample(img[None], grid, mode="nearest",
                         padding_mode="zeros", align_corners=False)[0]
