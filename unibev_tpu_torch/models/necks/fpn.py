"""FPN image neck and the SECONDFPN LiDAR neck.

Counterpart of ``unibev_tpu/models/necks/fpn.py::FPN``: lateral 1x1 convs, a
nearest-neighbour top-down pathway, and 3x3 output convs, NCHW.  Module names
are mmdet's (``lateral_convs.i.conv``, ``fpn_convs.i.conv``).  Every
reference config runs one level from ``start_level`` 0; the extra strided
output levels (``num_outs > len(in_channels)``) are not ported yet.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from unibev_tpu_torch.registry import NECKS


class ConvModule(nn.Module):
    """mmcv ConvModule without norm or activation: a conv under ``.conv``."""

    def __init__(self, cin: int, cout: int, kernel_size: int, padding: int = 0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel_size, padding=padding)

    def forward(self, x):
        return self.conv(x)


@NECKS.register_module(name="FPN")
class FPN(nn.Module):

    def __init__(self, in_channels: Sequence[int] = (2048,),
                 out_channels: int = 256, num_outs: int = 1):
        super().__init__()
        self.in_channels = tuple(in_channels)
        if num_outs != len(in_channels):
            raise NotImplementedError("FPN: extra output levels are not yet ported")
        self.lateral_convs = nn.ModuleList(
            [ConvModule(c, out_channels, 1) for c in in_channels])
        self.fpn_convs = nn.ModuleList(
            [ConvModule(out_channels, out_channels, 3, padding=1)
             for _ in in_channels])

    def forward(self, inputs):
        """inputs: tuple of NCHW maps, low to high stride."""
        if len(inputs) != len(self.in_channels):
            raise ValueError(f"FPN got {len(inputs)} inputs for {self.in_channels}")
        laterals = [conv(x) for conv, x in zip(self.lateral_convs, inputs)]
        for i in range(len(laterals) - 1, 0, -1):
            up = laterals[i].repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
            h, w = laterals[i - 1].shape[2:]
            laterals[i - 1] = laterals[i - 1] + up[:, :, :h, :w]
        return tuple(conv(x) for conv, x in zip(self.fpn_convs, laterals))


@NECKS.register_module(name="SECONDFPN")
class SECONDFPN(nn.Module):
    """SECOND neck: each scale to a common resolution by a bias-free
    transposed conv (kernel = stride) or, at stride 1, a 1x1 conv, then
    BatchNorm (eps 1e-3) and ReLU, concatenated over channels.

    Counterpart of ``unibev_tpu/models/necks/fpn.py::SECONDFPN``, with torch's
    ``ConvTranspose2d`` as the reference has it; the JAX package's flax
    ``ConvTranspose`` applies the kernel mirrored in both spatial axes, which
    ``utils/convert_jax.py`` undoes when it carries the weights over.
    Module names are mmdet3d's (``deblocks.i.{0, 1}``).
    """

    def __init__(self, in_channels: Sequence[int] = (128, 256),
                 out_channels: Sequence[int] = (128, 128),
                 upsample_strides: Sequence[int] = (1, 2),
                 use_conv_for_no_stride: bool = True):
        super().__init__()
        if not use_conv_for_no_stride:
            raise NotImplementedError("SECONDFPN: use_conv_for_no_stride=False "
                                      "is not yet ported")
        deblocks = []
        for cin, cout, s in zip(in_channels, out_channels, upsample_strides):
            up = (nn.ConvTranspose2d(cin, cout, s, stride=s, bias=False) if s > 1
                  else nn.Conv2d(cin, cout, 1, bias=False))
            deblocks.append(nn.Sequential(
                up, nn.BatchNorm2d(cout, eps=1e-3, momentum=0.01),
                nn.ReLU(inplace=True)))
        self.deblocks = nn.ModuleList(deblocks)

    def forward(self, inputs):
        """inputs: tuple of NCHW maps -> (B, sum(out_channels), H, W)."""
        return torch.cat([d(x) for d, x in zip(self.deblocks, inputs)], dim=1)
