"""ResNet image backbone with frozen BN and DCNv2 stages.

Counterpart of ``unibev_tpu/models/backbones/resnet.py``: depths 26, 50, 101
and 152; caffe style (the stride of a bottleneck on its first 1x1, as every
config file sets) or pytorch style (on its 3x3, plain or deformable); every
BN frozen to a per-channel affine, DCNv2 on the stages ``stage_with_dcn``
names.  Module names are mmdet's, so the reference checkpoint's
``img_backbone.*`` keys load as they are.  Inputs and outputs are NCHW
tensors; run the module in ``torch.channels_last``, so that the NHWC view
the deformable convolution reads costs no copy, and on CUDA because the
frozen BN passes (``ops/frozen_bn.py``, kernel K13) take nothing else.

Each frozen BN is one pass fused with what follows it: the stem's and a
bottleneck's bn1 and bn2 with their ReLU, bn3 with the residual add and the
ReLU, where the downsample branch's BN (``downsample.1``) is applied in the
same pass to the raw ``downsample.0`` convolution.  The affine is formed
from the BN's buffers on every call.

Training: ``frozen_stages`` (mmcv's ``_freeze_stages``, re-applied by
``train()``) turns gradients off for the stem and ``layer1..frozen_stages``
and detaches their outputs, as the JAX package's ``stop_gradient`` does;
``with_cp`` checkpoints every trainable bottleneck
(``torch.utils.checkpoint``, non-reentrant), so its activations are
recomputed in the backward, as the JAX package's remat does.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from unibev_tpu_torch.ops.deform_conv import modulated_deform_conv2d
from unibev_tpu_torch.ops.frozen_bn import bn_affine, frozen_bn_act
from unibev_tpu_torch.registry import BACKBONES

ARCH_SETTINGS = {
    26: (1, 1, 1, 1),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}
STYLES = ("caffe", "pytorch")


class FrozenBatchNorm(nn.Module):
    """BatchNorm with frozen statistics: y = (x - mean) / sqrt(var + eps) * w + b.

    Buffers carry torch BatchNorm2d's names (with ``num_batches_tracked``) so a
    reference checkpoint loads with ``strict=True``.  The ResNet does not call
    ``forward``: it hands the module to ``ops.frozen_bn.frozen_bn_act``, which
    applies it with its ReLU and residual add in one pass.  ``forward``, for
    any other caller, forms the same affine in float32 (``bn_affine``) and
    applies it in x's dtype.
    """

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))

    def forward(self, x):
        scale, shift = bn_affine(self)
        return x * scale.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


class DeformConv2d(nn.Module):
    """mmcv ModulatedDeformConv2dPack, 3x3 with padding 1: an offset/mask
    conv, then DCNv2.

    ``conv_offset`` yields (o1, o2, mask logits), 9 channels each; the offset
    is cat(o1, o2), i.e. (dy, dx) interleaved per tap.  The weight keeps the
    reference layout (Cout, Cin, 3, 3).
    """

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 3, 3))
        self.conv_offset = nn.Conv2d(in_channels, 27, 3, stride=stride, padding=1)

    def forward(self, x):
        om = self.conv_offset(x).permute(0, 2, 3, 1)         # (B, Ho, Wo, 27)
        offset = om[..., :18].contiguous()
        mask = torch.sigmoid(om[..., 18:])
        x_nhwc = x.permute(0, 2, 3, 1).contiguous()          # no copy in channels_last
        # (Cout, 3, 3, Cin) -> (9*Cin, Cout), tap-major like the im2col; a
        # view of the K-major rows (Cout, 9*Cin) that the CUDA forward reads
        w = self.weight.permute(0, 2, 3, 1).reshape(self.weight.shape[0], -1).t()
        out = modulated_deform_conv2d(x_nhwc, offset, mask, w, stride=self.stride)
        return out.permute(0, 3, 1, 2)                       # NCHW, channels_last


def _conv(cin, cout, k, stride=1, padding=0):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding, bias=False)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, with_dcn: bool = False,
                 style: str = "caffe"):
        super().__init__()
        # caffe style puts the stride on the first 1x1, pytorch style on the
        # 3x3
        s1, s2 = (stride, 1) if style == "caffe" else (1, stride)
        self.conv1 = _conv(inplanes, planes, 1, s1)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = (DeformConv2d(planes, planes, stride=s2) if with_dcn
                      else _conv(planes, planes, 3, s2, 1))
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = _conv(planes, planes * self.expansion, 1)
        self.bn3 = FrozenBatchNorm(planes * self.expansion)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(
                _conv(inplanes, planes * self.expansion, 1, stride),
                FrozenBatchNorm(planes * self.expansion))

    def forward(self, x):
        out = frozen_bn_act(self.conv1(x), self.bn1)
        out = frozen_bn_act(self.conv2(out), self.bn2)
        out = self.conv3(out)
        if self.downsample is None:
            return frozen_bn_act(out, self.bn3, residual=x)
        conv, bn = self.downsample
        return frozen_bn_act(out, self.bn3, down=conv(x), down_bn=bn)


@BACKBONES.register_module(name="ResNet")
class ResNet(nn.Module):
    """ResNet (caffe or pytorch style) with frozen BN and optional DCNv2
    stages (NCHW)."""

    def __init__(self, depth: int = 101, num_stages: int = 4,
                 out_indices: Sequence[int] = (3,), frozen_stages: int = -1,
                 style: str = "caffe", with_cp: bool = False,
                 stage_with_dcn: Sequence[bool] = (False, False, False, False),
                 dcn: Optional[dict] = None):
        super().__init__()
        if style not in STYLES:
            raise ValueError(f"ResNet style={style!r}: one of {STYLES}")
        self.out_indices = tuple(out_indices)
        self.frozen_stages = frozen_stages
        self.with_cp = with_cp
        deform_groups = (dcn or {}).get("deform_groups", 1)
        self.conv1 = _conv(3, 64, 7, 2, 3)
        self.bn1 = FrozenBatchNorm(64)
        inplanes, planes = 64, 64
        self.num_stages = num_stages
        for stage, n_blocks in enumerate(ARCH_SETTINGS[depth][:num_stages]):
            with_dcn = bool(stage_with_dcn[stage]) and dcn is not None
            if with_dcn and deform_groups != 1:
                raise NotImplementedError("DCNv2: only deform_groups=1 is ported")
            blocks = []
            for b in range(n_blocks):
                blocks.append(Bottleneck(inplanes, planes,
                                         stride=(1 if stage == 0 else 2) if b == 0 else 1,
                                         downsample=(b == 0), with_dcn=with_dcn,
                                         style=style))
                inplanes = planes * Bottleneck.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
            planes *= 2

    def train(self, mode: bool = True):
        super().train(mode)
        if self.frozen_stages >= 0:
            for m in [self.conv1, self.bn1] + [
                    getattr(self, f"layer{i}")
                    for i in range(1, self.frozen_stages + 1)]:
                m.requires_grad_(False)
        return self

    def forward(self, x):
        """x (B, 3, H, W) -> tuple of the stage outputs at out_indices."""
        x = frozen_bn_act(self.conv1(x), self.bn1)
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        if self.frozen_stages >= 0:
            x = x.detach()
        outs = []
        for stage in range(self.num_stages):
            frozen = stage + 1 <= self.frozen_stages
            for block in getattr(self, f"layer{stage + 1}"):
                if self.with_cp and not frozen and torch.is_grad_enabled():
                    x = checkpoint(block, x, use_reentrant=False)
                else:
                    x = block(x)
            if frozen:
                x = x.detach()
            if stage in self.out_indices:
                outs.append(x)
        return tuple(outs)
