"""FPN image neck and the SECONDFPN LiDAR neck.

Counterpart of ``unibev_tpu/models/necks/fpn.py::FPN``: lateral 1x1 convs
on the inputs from ``start_level``, a nearest-neighbour top-down pathway,
3x3 output convs, NCHW, and with ``num_outs`` above the levels used the
extra levels of ``add_extra_convs='on_output'``: strided 3x3 convs, each on
the previous output (through a ReLU from the second on, with
``relu_before_extra_convs``).  Module names are mmdet's
(``lateral_convs.i.conv``, ``fpn_convs.i.conv``, the extra convs after the
level convs in ``fpn_convs``).  Every reference config runs one level.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.models.layers import BatchNorm2d
from benchmark.reference.registry import NECKS


class ConvModule(nn.Module):
    """mmcv ConvModule without norm or activation: a conv under ``.conv``."""

    def __init__(self, cin: int, cout: int, kernel_size: int, padding: int = 0,
                 stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel_size, stride=stride,
                              padding=padding)

    def forward(self, x):
        return self.conv(x)


@NECKS.register_module(name="FPN")
class FPN(nn.Module):

    def __init__(self, in_channels: Sequence[int] = (2048,),
                 out_channels: int = 256, num_outs: int = 1,
                 start_level: int = 0, add_extra_convs="on_output",
                 relu_before_extra_convs: bool = True):
        super().__init__()
        if add_extra_convs != "on_output":
            # the JAX package builds the on_output extra levels whatever the
            # setting says
            raise ValueError(f"FPN: add_extra_convs={add_extra_convs!r}; "
                             f"only 'on_output' is implemented")
        self.in_channels = tuple(in_channels)
        self.start_level = start_level
        self.num_outs = num_outs
        self.relu_before_extra_convs = relu_before_extra_convs
        used = self.in_channels[start_level:]
        self.lateral_convs = nn.ModuleList(
            [ConvModule(c, out_channels, 1) for c in used])
        self.fpn_convs = nn.ModuleList(
            [ConvModule(out_channels, out_channels, 3, padding=1) for _ in used]
            + [ConvModule(out_channels, out_channels, 3, padding=1, stride=2)
               for _ in range(num_outs - len(used))])

    def forward(self, inputs):
        """inputs: tuple of NCHW maps, low to high stride -> ``num_outs``
        maps."""
        if len(inputs) != len(self.in_channels):
            raise ValueError(f"FPN got {len(inputs)} inputs for {self.in_channels}")
        laterals = [conv(x) for conv, x in zip(self.lateral_convs,
                                               inputs[self.start_level:])]
        for i in range(len(laterals) - 1, 0, -1):
            up = laterals[i].repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
            h, w = laterals[i - 1].shape[2:]
            laterals[i - 1] = laterals[i - 1] + up[:, :, :h, :w]
        n = len(laterals)
        outs = [conv(x) for conv, x in zip(self.fpn_convs, laterals)]
        for i, conv in enumerate(self.fpn_convs[n:]):
            src = outs[-1]
            outs.append(conv(F.relu(src) if self.relu_before_extra_convs and i
                             else src))
        return tuple(outs[:self.num_outs])


@NECKS.register_module(name="SECONDFPN")
class SECONDFPN(nn.Module):
    """SECOND neck: each scale to a common resolution by a bias-free
    transposed conv (kernel = stride) or, at stride 1, a 1x1 conv, then
    BatchNorm (eps 1e-3; ``layers.BatchNorm2d``, flax's train-mode update)
    and ReLU, concatenated over channels.

    Counterpart of ``unibev_tpu/models/necks/fpn.py::SECONDFPN``, with torch's
    ``ConvTranspose2d`` as the reference has it; the JAX package's flax
    ``ConvTranspose`` applies the kernel mirrored in both spatial axes, which
    ``utils/convert_jax.py`` undoes when it carries the weights over.
    With ``use_conv_for_no_stride=False`` a stride-1 scale takes no conv, as
    in the JAX package: its BatchNorm and ReLU run on the input's channels.
    Module names are mmdet3d's (``deblocks.i.{0, 1}``).
    """

    def __init__(self, in_channels: Sequence[int] = (128, 256),
                 out_channels: Sequence[int] = (128, 128),
                 upsample_strides: Sequence[int] = (1, 2),
                 use_conv_for_no_stride: bool = True):
        super().__init__()
        deblocks = []
        for cin, cout, s in zip(in_channels, out_channels, upsample_strides):
            if s > 1:
                up = nn.ConvTranspose2d(cin, cout, s, stride=s, bias=False)
            elif use_conv_for_no_stride:
                up = nn.Conv2d(cin, cout, 1, bias=False)
            else:
                up, cout = nn.Identity(), cin
            deblocks.append(nn.Sequential(
                up, BatchNorm2d(cout, eps=1e-3, momentum=0.01),
                nn.ReLU(inplace=True)))
        self.deblocks = nn.ModuleList(deblocks)

    def forward(self, inputs):
        """inputs: tuple of NCHW maps -> (B, sum(out_channels), H, W)."""
        return torch.cat([d(x) for d, x in zip(self.deblocks, inputs)], dim=1)
