"""Radar branch: the pillar feature net and the pillar scatter to the BEV.

Counterpart of ``unibev_tpu/models/radar.py``.  The radar cloud is
voxelized into pillars (z collapsed) by ``ops/voxelize.py`` with the mean
of each pillar's points; ``PillarFeatureNet`` appends the offsets of that
mean from the pillar's centre and runs ``Linear`` (no bias) + ``LayerNorm``
+ ReLU per entry of ``feat_channels``, as the JAX code does (its docstring
names a BatchNorm and a max-pool that its code does not run).
``PointPillarsScatter`` writes each pillar's row into a zero (B, H, W, C)
canvas with kernel K5 (``ops/scatter.py::scatter_add_rows``), the port of
the Pallas scatter, and hands it to SECOND as an NCHW view.

The parameters keep the JAX module names (``fc{i}``, ``ln{i}``): the
reference checkpoint's radar keys are not known to this repo.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from benchmark.reference.models.layers import layer_norm
from benchmark.reference.ops.scatter import scatter_add_rows
from benchmark.reference.registry import MIDDLE_ENCODERS, VOXEL_ENCODERS


@VOXEL_ENCODERS.register_module()
class PillarFeatureNet(nn.Module):
    """Per-pillar MLP on the mean point features and the offsets of that
    mean from the pillar's centre."""

    def __init__(self, in_channels: int = 7,
                 feat_channels: Sequence[int] = (64,),
                 voxel_size: Tuple[float, float, float] = (0.8, 0.8, 8.0),
                 point_cloud_range: Sequence[float] = (-54, -54, -5, 54, 54, 3)):
        super().__init__()
        self.voxel_size = tuple(voxel_size)
        self.pc_range = tuple(point_cloud_range)
        self.num_layers = len(feat_channels)
        cin = in_channels + 2
        for i, c in enumerate(feat_channels):
            self.add_module(f"fc{i}", nn.Linear(cin, c, bias=False))
            self.add_module(f"ln{i}", layer_norm(c))
            cin = c

    def forward(self, pillar_feats: torch.Tensor, coords: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        """pillar_feats (V, F) mean features (x, y first); coords (V, 3)
        (z, y, x); mask (V,).  Returns (V, C), masked rows 0.  The centres
        are computed in pillar_feats' dtype, as the JAX module does in its
        compute dtype."""
        x = pillar_feats
        xc = ((coords[:, 2].to(x.dtype) + 0.5) * self.voxel_size[0]
              + self.pc_range[0])
        yc = ((coords[:, 1].to(x.dtype) + 0.5) * self.voxel_size[1]
              + self.pc_range[1])
        x = torch.cat([x, x[:, 0:1] - xc[:, None], x[:, 1:2] - yc[:, None]],
                      dim=-1)
        for i in range(self.num_layers):
            x = getattr(self, f"ln{i}")(getattr(self, f"fc{i}")(x))
            x = torch.relu(x)
        return torch.where(mask[:, None], x, 0.0)


class _PillarScatter(torch.autograd.Function):
    """(B * H * W, C) canvas rows from pillar rows at ``idx``: K5 into a
    float32 table, rounded once to the rows' dtype.  The backward gathers
    the canvas gradient at ``idx`` (the JAX backward is XLA's gather), 0
    for an index outside the canvas (a masked pillar)."""

    @staticmethod
    def forward(ctx, feats, idx, rows):
        ctx.save_for_backward(idx)
        ctx.rows = rows
        return scatter_add_rows(idx, feats.contiguous(), rows).to(feats.dtype)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        live = (idx >= 0) & (idx < ctx.rows)
        rows = grad.index_select(0, torch.where(live, idx, 0))
        return torch.where(live[:, None], rows, 0.0), None, None


@MIDDLE_ENCODERS.register_module()
class PointPillarsScatter(nn.Module):
    """Scatter pillar features into the dense BEV canvas (H = y, W = x)."""

    def __init__(self, in_channels: int = 64,
                 output_shape: Tuple[int, int] = (180, 180)):
        super().__init__()
        self.in_channels = in_channels
        self.output_shape = tuple(output_shape)

    def forward(self, feats: torch.Tensor, coords: torch.Tensor,
                mask: torch.Tensor, batch_size: int) -> torch.Tensor:
        """feats (V, C); coords (V, 4) (b, z, y, x); mask (V,).  Returns
        (B, C, H, W) in feats' dtype, an NCHW view of (B, H, W, C) memory
        (channels_last, as SECOND runs).  Pillar v goes to canvas row
        ``(b * H + y) * W + x``; a masked one to row B * H * W, past the
        canvas, which the scatter skips (the JAX module's ``canvas[:-1]``)."""
        H, W = self.output_shape
        rows = batch_size * H * W
        flat = (coords[:, 0] * H + coords[:, 2]) * W + coords[:, 3]
        idx = torch.where(mask, flat, rows).to(torch.int32)
        canvas = _PillarScatter.apply(feats, idx, rows)
        return canvas.view(batch_size, H, W, -1).permute(0, 3, 1, 2)
