"""SECOND BEV backbone: 2D conv stacks over the LiDAR BEV map.

Counterpart of ``unibev_tpu/models/backbones/second.py``: per stage one 3x3
conv carrying the stride, then ``layer_nums`` stride-1 3x3 convs, each
bias-free and followed by flax's BatchNorm (eps 1e-3, momentum 0.01;
``layers.BatchNorm2d``: running statistics in eval, batch statistics and a
biased running variance in train) and ReLU.  NCHW; module names are
mmdet3d's (``blocks.i.{3j, 3j + 1}``), so ``pts_backbone.*`` checkpoint keys
load as they are.
"""

from __future__ import annotations

from typing import Sequence

from torch import nn

from benchmark.reference.models.layers import BatchNorm2d
from benchmark.reference.registry import BACKBONES


def conv_bn_relu(cin: int, cout: int, stride: int = 1):
    return [nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False),
            BatchNorm2d(cout, eps=1e-3, momentum=0.01), nn.ReLU(inplace=True)]


@BACKBONES.register_module(name="SECOND")
class SECOND(nn.Module):

    def __init__(self, in_channels: int = 256,
                 out_channels: Sequence[int] = (128, 256),
                 layer_nums: Sequence[int] = (5, 5),
                 layer_strides: Sequence[int] = (1, 2)):
        super().__init__()
        blocks, cin = [], in_channels
        for cout, n, stride in zip(out_channels, layer_nums, layer_strides):
            layers = conv_bn_relu(cin, cout, stride)
            for _ in range(n):
                layers += conv_bn_relu(cout, cout)
            blocks.append(nn.Sequential(*layers))
            cin = cout
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x):
        """x (B, in_channels, H, W) -> tuple of each stage's NCHW map."""
        outs = []
        for block in self.blocks:
            x = block(x)
            outs.append(x)
        return tuple(outs)
