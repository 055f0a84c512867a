"""SECOND-style sparse middle encoder.

Counterpart of ``unibev_tpu/models/middle_encoder.py`` (mmdet3d v0.18
``SparseEncoder``, block_type 'basicblock'):

  conv_input: SubM(5 -> 16) + BN + ReLU
  stage0: SparseBasicBlock(16) x2, SparseConv3d(16 -> 32, k3 s2 p1)
  stage1: SparseBasicBlock(32) x2, SparseConv3d(32 -> 64, k3 s2 p1)
  stage2: SparseBasicBlock(64) x2, SparseConv3d(64 -> 128, k3 s2 p(0,1,1))
  stage3: SparseBasicBlock(128) x2
  conv_out: SparseConv3d(128 -> 128, k(3,1,1), s(2,1,1)) + BN + ReLU
  to_dense: [41, 1440, 1440] -> (B, 2, 180, 180, 128) -> (B, 256, 180, 180)

The active set of each resolution is a fixed-capacity row set with a mask
and a compact cell -> row table (``ops/sparse_conv.py``); its submanifold
rulebook (kernel K6) is built once and shared by every submanifold conv
there, and every conv is kernel K7.
Module names are the reference's, so ``pts_middle_encoder.*`` checkpoint
keys load as they are; a conv weight keeps spconv's (kz, ky, kx, Cin, Cout).
BatchNorm (eps 1e-3) leaves padding rows exactly 0; in ``train()`` mode it
normalizes with the statistics of the live rows and updates its running
ones.  With gradients on, each strided conv also gets its inverse rulebook
(kernel K8) for the backward of ``ops/sparse_conv.py::SparseConvFn``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from unibev_tpu_torch.ops.sparse_conv import (SparseGrid, build_table,
                                              downsample_with_table,
                                              sparse_conv, sparse_inv_nbr,
                                              strided_neighbor_idx,
                                              subm_neighbor_idx, to_dense)
from unibev_tpu_torch.parallel.dist import sum_over_ranks
from unibev_tpu_torch.registry import MIDDLE_ENCODERS, VOXEL_ENCODERS

Triple = Tuple[int, int, int]


@VOXEL_ENCODERS.register_module()
class HardSimpleVFE:
    """Mean-of-points voxel feature encoder.  The mean is computed by
    ``ops/voxelize.py::voxelize_and_encode``; this class only carries the
    config contract (``num_features``) through the registry."""

    def __init__(self, num_features: int = 5):
        self.num_features = num_features


class MaskedBatchNorm(nn.BatchNorm1d):
    """BatchNorm1d over voxel rows, eps 1e-3, momentum 0.01:
    ``(x - mean) * (weight / sqrt(var + eps)) + bias`` in x's dtype (the
    scale formed in float32), padding rows exactly 0.

    Eval: the running statistics.  Train: the mean and the biased variance
    of the live rows (``mask``), in float32 over ``n = max(live, 1)`` rows,
    with gradients through both; the running statistics move by
    ``(1 - momentum) * running + momentum * batch``, the biased variance
    included, as the JAX package's ``MaskedBatchNorm`` does.  Under a process
    group the sums and the live count are summed over the ranks
    (differentiably): the statistics of the global batch, as the JAX mesh
    computes them.
    """

    def __init__(self, features: int):
        super().__init__(features, eps=1e-3, momentum=0.01)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if self.training:
            m = mask[:, None].float()
            xf = x.float()
            s = sum_over_ranks(torch.cat([(xf * m).sum(0), m.sum()[None]]))
            n = s[-1].clamp(min=1.0)
            mean = s[:-1] / n
            var = sum_over_ranks(((xf - mean) ** 2 * m).sum(0)) / n
            with torch.no_grad():
                for running, batch in ((self.running_mean, mean),
                                       (self.running_var, var)):
                    running.mul_(1 - self.momentum).add_(self.momentum * batch)
                self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean.float(), self.running_var.float()
        scale = self.weight.float() * torch.rsqrt(var + self.eps)
        out = (x - mean.to(x.dtype)) * scale.to(x.dtype) + self.bias.to(x.dtype)
        return torch.where(mask[:, None], out, 0.0)


class SparseConv3d(nn.Module):
    """Weight holder of one spconv conv, (kz, ky, kx, Cin, Cout); the rulebook
    comes with the call."""

    def __init__(self, cin: int, cout: int, kernel: Triple = (3, 3, 3)):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(*kernel, cin, cout))

    def forward(self, feats, nidx, mask, inv_idx=None):
        w = self.weight
        return sparse_conv(feats, nidx, w.reshape(-1, w.shape[-1]), mask,
                           inv_idx)


class SparseConvBN(nn.Sequential):
    """spconv conv (``.0``) + masked BN (``.1``) + ReLU, as the reference's
    ``SparseSequential(conv, norm, ReLU)``."""

    def __init__(self, cin: int, cout: int, kernel: Triple = (3, 3, 3)):
        super().__init__(SparseConv3d(cin, cout, kernel), MaskedBatchNorm(cout))

    def forward(self, feats, nidx, mask, inv_idx=None):
        return torch.relu(self[1](self[0](feats, nidx, mask, inv_idx), mask))


class SparseBasicBlock(nn.Module):
    """Two submanifold convs with BN, ReLU between, and the identity added
    before the last ReLU."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = SparseConv3d(channels, channels)
        self.bn1 = MaskedBatchNorm(channels)
        self.conv2 = SparseConv3d(channels, channels)
        self.bn2 = MaskedBatchNorm(channels)

    def forward(self, feats, nidx, mask):
        out = torch.relu(self.bn1(self.conv1(feats, nidx, mask), mask))
        out = self.bn2(self.conv2(out, nidx, mask), mask)
        return torch.relu(out + feats)


def _triple(p) -> Triple:
    return (p, p, p) if isinstance(p, int) else tuple(p)


@MIDDLE_ENCODERS.register_module(name="SparseEncoder")
class SparseEncoder(nn.Module):

    def __init__(self, in_channels: int = 5,
                 sparse_shape: Sequence[int] = (41, 1440, 1440),
                 output_channels: int = 128,
                 encoder_channels: Sequence[Sequence[int]] = (
                     (16, 16, 32), (32, 32, 64), (64, 64, 128), (128, 128)),
                 encoder_paddings: Sequence[Sequence] = (
                     (0, 0, 1), (0, 0, 1), (0, 0, (0, 1, 1)), (0, 0)),
                 capacities: Sequence[int] = (120000, 90000, 60000, 40000),
                 table_dtype: str = "bf16"):
        # table_dtype selects the JAX package's fp8 gather tables, a TPU
        # gather-engine packing the port does not have: it is accepted so
        # that the config dicts build, and only "bf16" (plain) is taken.
        super().__init__()
        if table_dtype != "bf16":
            raise NotImplementedError(f"table_dtype={table_dtype!r}: the port "
                                      "computes the plain gather conv only")
        self.sparse_shape = tuple(sparse_shape)
        self.capacities = tuple(capacities)
        self.paddings = [_triple(p[-1]) for p in encoder_paddings[:-1]]
        self.conv_input = SparseConvBN(in_channels, encoder_channels[0][0])
        self.encoder_layers = nn.ModuleDict()
        last = len(encoder_channels) - 1
        for i, blocks in enumerate(encoder_channels):
            n_basic = len(blocks) - 1 if i != last else len(blocks)
            layer = nn.ModuleList([SparseBasicBlock(blocks[j])
                                   for j in range(n_basic)])
            if i != last:
                layer.append(SparseConvBN(blocks[-2], blocks[-1]))
            self.encoder_layers[f"encoder_layer{i + 1}"] = layer
        self.conv_out = SparseConvBN(encoder_channels[-1][-1], output_channels,
                                     (3, 1, 1))

    def forward(self, voxel_feats: torch.Tensor, coords: torch.Tensor,
                mask: torch.Tensor, batch_size: int):
        """voxel_feats (V, in_channels); coords (V, 4) int32 (b, z, y, x), -1
        on padding rows; mask (V,) bool.

        Returns (bev (B, output_channels * Dz, H / 8, W / 8) NCHW over
        channels-last memory, channel ``c * Dz + d`` as spconv's ``.dense()``
        stacks it; overflow (4,) int64: the active sites each strided conv
        found beyond its capacity, ``conv_out`` last).
        """
        grid = SparseGrid(coords, mask, self.sparse_shape, batch_size)
        table = build_table(grid)
        nidx = subm_neighbor_idx(grid, table)
        x = self.conv_input(voxel_feats, nidx, mask)
        overflow = []
        stages = list(self.encoder_layers.values())
        for i, layer in enumerate(stages):
            down = i != len(stages) - 1
            for block in layer[:-1] if down else layer:
                x = block(x, nidx, grid.mask)
            if down:
                grid, table, x, over = self._strided(
                    layer[-1], x, grid, table, (3, 3, 3), (2, 2, 2),
                    self.paddings[i], self.capacities[i + 1])
                overflow.append(over)
                nidx = subm_neighbor_idx(grid, table)
        grid, _, x, over = self._strided(self.conv_out, x, grid, table,
                                         (3, 1, 1), (2, 1, 1), (0, 0, 0),
                                         self.capacities[-1])
        overflow.append(over)
        dense = to_dense(x, grid)                       # (B, Dz, H', W', C)
        B, Dz, Hp, Wp, C = dense.shape
        bev = dense.permute(0, 2, 3, 4, 1).reshape(B, Hp, Wp, C * Dz)
        return bev.permute(0, 3, 1, 2), torch.stack(overflow)

    @staticmethod
    def _strided(conv: SparseConvBN, x, grid: SparseGrid, table, kernel,
                 stride, padding, capacity):
        out_shape = tuple((s + 2 * p - k) // st + 1 for s, p, k, st in
                          zip(grid.shape, padding, kernel, stride))
        co, mo, new_table, overflow = downsample_with_table(
            grid, kernel, stride, padding, out_shape, capacity)
        sidx = strided_neighbor_idx(grid, table, co, mo, kernel, stride,
                                    padding)
        inv = None
        if torch.is_grad_enabled() and (x.requires_grad
                                        or conv[0].weight.requires_grad):
            # d_feats of the strided conv gathers over the output rows
            inv = sparse_inv_nbr(new_table, capacity, out_shape, grid.coords,
                                 grid.mask, kernel, stride, padding)
        x = conv(x, sidx, mo, inv)
        return SparseGrid(co, mo, out_shape, grid.batch), new_table, x, overflow
