"""Hard voxelization with the mean voxel feature encoder: kernel K10
(``csrc/voxelize.cu``) and its plain PyTorch version.

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

CPU tensors take the plain version (``voxelize_and_encode_reference``: a
stable sort, scans and ``index_add_``, ~20 launches on a card); CUDA
tensors launch K10 or raise.  K10 ranks the voxels over an occupancy bitmap
of the grid instead of sorting the points, keeps each voxel's first points
by input index with an ``atomicMin`` cascade, and gets the cell arithmetic's
float32 origin and reciprocal as scalar arguments (``cell_params``), so a
call copies nothing from the host and synchronizes nothing.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from unibev_tpu_torch.ops import _build
from unibev_tpu_torch.utils.timer import spanned


class VoxelizationResult(NamedTuple):
    feats: torch.Tensor       # (max_voxels, F) mean feature per voxel
    coords: torch.Tensor      # (max_voxels, 3) int32 (z, y, x), -1 on padding
    mask: torch.Tensor        # (max_voxels,) bool
    num_voxels: torch.Tensor  # () int32
    num_points: torch.Tensor  # (max_voxels,) int32 points kept per voxel
    num_distinct: torch.Tensor  # () int64 occupied voxels before the cap


def voxelize_and_encode_reference(points: torch.Tensor,
                                  points_mask: torch.Tensor,
                                  voxel_size: Sequence[float],
                                  pc_range: Sequence[float],
                                  grid_size: Tuple[int, int, int],
                                  max_voxels: int,
                                  max_points_per_voxel: int = 10
                                  ) -> VoxelizationResult:
    """Plain version of K10: voxelize one padded cloud, points (P, F)
    float32 (x, y, z first), points_mask (P,) bool; grid_size (X, Y, Z)."""
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


@functools.lru_cache(maxsize=None)
def cell_params(voxel_size: Tuple[float, float, float],
                pc_range: Tuple[float, ...]):
    """K10's cell arithmetic as Python floats that are exactly float32: the
    origin ``(x0, y0, z0)`` and the reciprocal ``1 / v`` of each voxel size,
    both rounded to float32 as the plain version's tensors hold them (the
    reciprocal of the float32 size, correctly rounded)."""
    origin = np.asarray(pc_range[:3], np.float32)
    inv = np.float32(1) / np.asarray(voxel_size, np.float32)
    return tuple(map(float, origin)), tuple(map(float, inv))


class VoxelizePlan(NamedTuple):
    """How K10 covers one call (``csrc/voxelize.cu`` reads it as int64s in
    this order and refuses one whose layout or launch sizes disagree with
    its own).  The workspace in int32 words: the bitmap (``padded`` words,
    whole scan tiles) at 0, the scan state (a 64-bit status word a tile,
    the ticket, the total) at ``state_offset``, the set bits before each
    8-word sector at ``dir_offset``, each point's key at
    ``keys_offset``, each kept voxel's ``max_points`` slots at
    ``slots_offset``; the fill zeroes the first ``zero_vectors`` 16-byte
    vectors and empties the ``slot_words`` slots.  The outputs in one byte
    buffer of ``out_bytes``: feats at 0 and the others at their offsets,
    each 16-byte aligned.  Launches: ``fill_blocks``, ``point_blocks`` (mark,
    slot), ``tiles`` (scan), ``voxel_blocks`` (emit)."""
    points: int
    features: int
    X: int
    Y: int
    Z: int
    max_voxels: int
    max_points: int
    rows: int
    words: int
    padded: int
    tiles: int
    state_offset: int
    dir_offset: int
    keys_offset: int
    slots_offset: int
    work_words: int
    zero_vectors: int
    slot_words: int
    coords_offset: int
    num_points_offset: int
    num_voxels_offset: int
    num_distinct_offset: int
    mask_offset: int
    out_bytes: int
    fill_blocks: int
    point_blocks: int
    voxel_blocks: int


def _round(n: int, m: int) -> int:
    return -(-n // m) * m


@functools.lru_cache(maxsize=None)
def voxelize_plan(P: int, F: int, grid_size: Tuple[int, int, int],
                  max_voxels: int, max_points: int) -> VoxelizePlan:
    """K10's plan for ``P`` points of ``F`` features on ``grid_size`` (X, Y,
    Z).  Raises where the kernel's int32 keys and rows do not reach."""
    X, Y, Z = grid_size
    M, K = max_voxels, max_points
    if F < 3 or M < 1 or K < 1 or min(grid_size) < 1 or P < 0:
        raise ValueError(f"voxelize_and_encode: points (P, F >= 3), "
                         f"max_voxels and max_points >= 1 and a grid; got "
                         f"{(P, F)}, {M}, {K}, {grid_size}")
    if X * Y * Z >= 2 ** 31 or P >= 2 ** 31 or M * F >= 2 ** 31:
        raise ValueError(f"voxelize_and_encode: the kernel's int32 keys and "
                         f"rows take fewer than 2^31 cells, points and "
                         f"features; got grid {grid_size}, {P} points")
    words, padded = _build.bitmap_words(X * Y * Z)
    tiles = padded // _build.BITMAP_TILE_WORDS
    rows = min(M, P)
    state = padded
    dirs = state + _build.scan_state_words(tiles)
    keys = dirs + padded // 8
    slots = keys + _round(P, 4)
    coords = _round(4 * M * F, 16)
    num_points = coords + _round(12 * M, 16)
    num_voxels = num_points + _round(4 * M, 16)
    num_distinct = num_voxels + 16
    mask = num_distinct + 16
    return VoxelizePlan(
        points=P, features=F, X=X, Y=Y, Z=Z, max_voxels=M, max_points=K,
        rows=rows, words=words, padded=padded, tiles=tiles,
        state_offset=state, dir_offset=dirs,
        keys_offset=keys, slots_offset=slots, work_words=slots + rows * K,
        zero_vectors=dirs // 4, slot_words=rows * K, coords_offset=coords,
        num_points_offset=num_points, num_voxels_offset=num_voxels,
        num_distinct_offset=num_distinct, mask_offset=mask,
        out_bytes=mask + _round(M, 16),
        fill_blocks=_build.bitmap_blocks(dirs // 4 + rows * K, fill=True),
        point_blocks=_build.bitmap_blocks(P),
        voxel_blocks=_build.bitmap_blocks(M))


@functools.lru_cache(maxsize=None)
def _cell_args(voxel_size: Tuple[float, ...], pc_range: Tuple[float, ...]):
    """``cell_params`` as the C entry point's six float32s."""
    origin, inv = cell_params(voxel_size, pc_range)
    return (ctypes.c_float * 6)(*origin, *inv)


@spanned("kernel:voxelize")
def _voxelize(points: torch.Tensor, points_mask: torch.Tensor, cell,
              plan: VoxelizePlan) -> VoxelizationResult:
    """One launch of K10 by ``plan`` (the C entry point checks it)."""
    dev = points.device
    out = torch.empty((plan.out_bytes,), dtype=torch.uint8, device=dev)
    work = torch.empty((plan.work_words,), dtype=torch.int32, device=dev)
    err = _build.lib().unibev_voxelize(
        points.data_ptr(), points_mask.data_ptr(), out.data_ptr(),
        work.data_ptr(), _build.plan_args(plan), len(plan), cell,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "voxelize")
    _build.launches["voxelize"] += 1
    return _result_views(out, plan)


def _result_views(out: torch.Tensor, plan: VoxelizePlan) -> VoxelizationResult:
    """The outputs as views of the byte buffer ``out`` at the plan's
    offsets (one view of the buffer per dtype, then one strided view each:
    fewer operations a call than an allocation each)."""
    M, F = plan.max_voxels, plan.features
    i32 = out.view(torch.int32)
    return VoxelizationResult(
        feats=out.view(torch.float32).as_strided((M, F), (F, 1)),
        coords=i32.as_strided((M, 3), (3, 1), plan.coords_offset // 4),
        mask=out.view(torch.bool).as_strided((M,), (1,), plan.mask_offset),
        num_voxels=i32.as_strided((), (), plan.num_voxels_offset // 4),
        num_points=i32.as_strided((M,), (1,), plan.num_points_offset // 4),
        num_distinct=out.view(torch.int64).as_strided(
            (), (), plan.num_distinct_offset // 8))


def voxelize_and_encode(points: torch.Tensor, points_mask: torch.Tensor,
                        voxel_size: Sequence[float], pc_range: Sequence[float],
                        grid_size: Tuple[int, int, int], max_voxels: int,
                        max_points_per_voxel: int = 10) -> VoxelizationResult:
    """Voxelize one padded cloud: points (P, F) float32 (x, y, z first),
    points_mask (P,) bool; grid_size (X, Y, Z).  CPU tensors take the plain
    version, CUDA tensors kernel K10 (float32 points, both contiguous, on
    the current device)."""
    if points.device.type == "cpu":
        return voxelize_and_encode_reference(
            points, points_mask, voxel_size, pc_range, grid_size, max_voxels,
            max_points_per_voxel)
    dev = points.device
    if dev.type != "cuda" or points_mask.device != dev \
            or dev.index != torch.cuda.current_device():
        raise ValueError("voxelize_and_encode: the points and their mask "
                         "must lie on the current CUDA device")
    if points.dtype != torch.float32 or points_mask.dtype != torch.bool:
        raise TypeError(f"voxelize_and_encode: float32 points and a bool "
                        f"mask, got {points.dtype} and {points_mask.dtype}")
    if points.dim() != 2 or points_mask.shape != points.shape[:1]:
        raise ValueError(f"voxelize_and_encode: points (P, F) and mask (P,), "
                         f"got {tuple(points.shape)} and "
                         f"{tuple(points_mask.shape)}")
    if not (points.is_contiguous() and points_mask.is_contiguous()):
        raise ValueError("voxelize_and_encode: the kernel takes contiguous "
                         "points and mask")
    P, F = points.shape
    plan = voxelize_plan(P, F, tuple(grid_size), max_voxels,
                         max_points_per_voxel)
    return _voxelize(points, points_mask,
                     _cell_args(tuple(voxel_size), tuple(pc_range)), plan)
