"""Rotation of BEV maps about a centre: how BEVFormer aligns the previous
frame's BEV map with the ego's new heading.

The published BEVFormer (``PerceptionTransformer.get_bev_features``) rotates
each sample's previous map, as a (C, H, W) tensor, with torchvision's
``transforms.functional.rotate(img, angle, center=rotate_center)``: nearest
interpolation, no expansion, zero fill, a positive angle turning the map
counter-clockwise as displayed (rows down, columns right).  torchvision is
not installed, so this op computes what that call computes, for a batch of
maps in the port's (B, H, W, C) layout and with one angle a sample held on
the device (nothing is read back to the host):

* the inverse affine matrix of torchvision's ``_get_inverse_affine_matrix``
  for the angle ``-angle`` about the centre, formed in float64 and rounded
  to float32, and rescaled by (W / 2, H / 2) in float32;
* each output pixel's source point from its centre, ``x = j - W / 2 + 0.5``,
  ``y = i - H / 2 + 0.5``, in float32 (``_gen_affine_grid``);
* the source cell as ``grid_sample(mode='nearest', align_corners=False)``
  rounds it: ``((g + 1) * W - 1) / 2`` to the nearest integer, ties to
  even; a source outside the map reads zero;
* the map's rows gathered at the source cells, channels whole.

torchvision forms the source point by one small matrix product; here it is
three float32 products and sums, which can round the last bit otherwise:
a source point within one rounding of a cell edge may then take the
neighbouring cell.  A rotation by a multiple of 90 degrees about a pixel
corner maps pixel centres onto pixel centres and is exact.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def source_cells(angle_deg: torch.Tensor, height: int, width: int,
                 center: Sequence[float]) -> torch.Tensor:
    """(B, H * W) int64: the flat source cell of each output cell of a
    rotation by ``angle_deg`` (B,) degrees about ``center`` (x, y) in
    pixels, or -1 where the source falls outside the map."""
    dev = angle_deg.device
    cx = float(center[0]) - width * 0.5
    cy = float(center[1]) - height * 0.5
    rot = torch.deg2rad(-angle_deg.to(torch.float64))
    cos, sin = torch.cos(rot), torch.sin(rot)
    # torchvision's inverse matrix [d, -b, 0, -c, a, 0] of the rotation
    # (a, b, c, d) = (cos, -sin, sin, cos), moved to and from the centre
    m0, m1, m3, m4 = cos, sin, -sin, cos
    m2 = m0 * -cx + m1 * -cy + cx
    m5 = m3 * -cx + m4 * -cy + cy
    # rows (x, y, 1) by columns (gx, gy), in float32; Python scalars, so
    # that no host-to-device copy is made
    theta = torch.stack([m0, m1, m2, m3, m4, m5], -1).float().view(-1, 2, 3)
    r = torch.stack([theta[:, 0] / (width * 0.5),
                     theta[:, 1] / (height * 0.5)], -1)      # (B, 3, 2)
    xs = torch.linspace(-width * 0.5 + 0.5, width * 0.5 - 0.5, width,
                        device=dev)
    ys = torch.linspace(-height * 0.5 + 0.5, height * 0.5 - 0.5, height,
                        device=dev)
    x, y = xs[None, None, :], ys[None, :, None]
    gx = x * r[:, 0, 0, None, None] + y * r[:, 1, 0, None, None] \
        + r[:, 2, 0, None, None]
    gy = x * r[:, 0, 1, None, None] + y * r[:, 1, 1, None, None] \
        + r[:, 2, 1, None, None]
    ix = torch.round(((gx + 1) * width - 1) / 2)
    iy = torch.round(((gy + 1) * height - 1) / 2)
    inside = (ix >= 0) & (ix < width) & (iy >= 0) & (iy < height)
    flat = (iy * width + ix).long()
    return torch.where(inside, flat, -1).reshape(-1, height * width)


def rotate_bev(x: torch.Tensor, angle_deg: torch.Tensor,
               center: Sequence[float],
               keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each map of ``x`` (B, H, W, C) rotated by its ``angle_deg`` (B,)
    degrees, counter-clockwise as displayed, about ``center`` (x, y) in
    pixels; zero where the source lies outside the map and, where ``keep``
    (B,) bool is given, wherever it is False.  Returns (B, H, W, C) in x's
    dtype."""
    B, H, W, C = x.shape
    src = source_cells(angle_deg, H, W, center)
    if keep is not None:
        src = torch.where(keep[:, None], src, -1)
    base = torch.arange(B, device=x.device)[:, None] * (H * W)
    rows = x.reshape(B * H * W, C).index_select(
        0, (src.clamp(min=0) + base).reshape(-1))
    rows.masked_fill_((src < 0).reshape(-1, 1), 0)
    return rows.view(B, H, W, C)
