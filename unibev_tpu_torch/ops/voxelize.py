"""Hard voxelization with the mean voxel feature encoder, in plain PyTorch.

Counterpart of ``unibev_tpu/ops/voxelize.py::voxelize_and_encode`` (an XLA
op of the JAX package, not a Pallas kernel): a stable sort by voxel key and a
segment sum.  The semantics are the JAX op's, to the bit where it matters:

* grid cells are ``floor((p - x0) * (1 / v))`` in float32: XLA compiles the
  JAX op's division by the constant voxel size into a multiplication by its
  float32 reciprocal, which puts some points in another cell than a true
  division would (5 of the flagship cloud's 600k x and y coordinates), so
  the port multiplies too;
* points keep their input order inside a voxel, and only the first
  ``max_points_per_voxel`` of each voxel count;
* voxels are numbered in ascending key order ``(z * Y + y) * X + x`` and the
  ``max_voxels`` smallest keys are kept (the JAX package's documented
  deviation from the reference's first-seen order);
* the feature of a voxel is the float32 mean of its kept points.

Whether the voxelizer deserves a kernel is left to the card's profile
(``chip_smoke.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch


class VoxelizationResult(NamedTuple):
    feats: torch.Tensor       # (max_voxels, F) mean feature per voxel
    coords: torch.Tensor      # (max_voxels, 3) int32 (z, y, x), -1 on padding
    mask: torch.Tensor        # (max_voxels,) bool
    num_voxels: torch.Tensor  # () int32
    num_points: torch.Tensor  # (max_voxels,) int32 points kept per voxel
    num_distinct: torch.Tensor  # () int64 occupied voxels before the cap


def voxelize_and_encode(points: torch.Tensor, points_mask: torch.Tensor,
                        voxel_size: Sequence[float], pc_range: Sequence[float],
                        grid_size: Tuple[int, int, int], max_voxels: int,
                        max_points_per_voxel: int = 10) -> VoxelizationResult:
    """Voxelize one padded cloud: points (P, F) float32 (x, y, z first),
    points_mask (P,) bool; grid_size (X, Y, Z)."""
    P, F = points.shape
    X, Y, Z = grid_size
    dev = points.device
    origin = torch.tensor(pc_range[:3], dtype=torch.float32, device=dev)
    inv = torch.tensor(voxel_size, dtype=torch.float32, device=dev).reciprocal()
    g = torch.floor((points[:, :3].float() - origin) * inv).to(torch.int64)
    gx, gy, gz = g.unbind(1)
    in_range = ((gx >= 0) & (gx < X) & (gy >= 0) & (gy < Y)
                & (gz >= 0) & (gz < Z) & points_mask)
    big = Z * Y * X
    key = torch.where(in_range, (gz * Y + gy) * X + gx, big)

    skey, order = torch.sort(key, stable=True)
    svalid = skey < big
    first = torch.ones_like(svalid)
    first[1:] = skey[1:] != skey[:-1]
    first &= svalid
    voxel_id = torch.cumsum(first, 0) - 1
    pos = torch.arange(P, device=dev)
    seg_start = torch.cummax(torch.where(first, pos, -1), 0).values
    rank = pos - seg_start
    keep = svalid & (voxel_id < max_voxels) & (rank < max_points_per_voxel)
    seg = torch.where(keep, voxel_id, max_voxels)

    spoints = points[order].float()
    sums = torch.zeros((max_voxels + 1, F), dtype=torch.float32, device=dev)
    sums.index_add_(0, seg, torch.where(keep[:, None], spoints, 0.0))
    counts = torch.zeros((max_voxels + 1,), dtype=torch.int64, device=dev)
    counts.index_add_(0, seg, keep.to(torch.int64))
    vkey = torch.zeros((max_voxels + 1,), dtype=torch.int64, device=dev)
    vkey.index_add_(0, seg, torch.where(first & keep, skey, 0))
    sums, counts, vkey = sums[:-1], counts[:-1], vkey[:-1]

    feats = sums / counts.clamp(min=1)[:, None].to(torch.float32)
    mask = counts > 0
    coords = torch.stack([vkey // (Y * X), (vkey // X) % Y, vkey % X], 1)
    coords = torch.where(mask[:, None], coords, -1).to(torch.int32)
    return VoxelizationResult(
        feats=feats.to(points.dtype), coords=coords, mask=mask,
        num_voxels=mask.sum().to(torch.int32),
        num_points=counts.to(torch.int32),
        num_distinct=first.sum())
