"""The hard voxelizer with the mean VFE, the port against the JAX package.

Clouds hold voxels with more points than ``max_points_per_voxel``, points
out of range, masked points, and (in the capped cases) more distinct voxels
than ``max_voxels``, so that the smallest-key cap is held.  Integers (coords,
mask, counts) must be equal; the voxel means agree to 1e-6 (a mean of at
most ``max_points_per_voxel`` float32 points summed in another order).
The flagship synthetic batch's cloud is voxelized at full size: its 300k
uniform points fill 298,949 distinct voxels, far above the 120,000 cap.
Cells are ``floor((p - x0) * (1 / v))`` with the float32 reciprocal, as XLA
compiles the JAX op's division.  On the CPU ``voxelize_and_encode`` is its
plain version, ``voxelize_and_encode_reference``, which is also held on its
own: at the RC model's radar parameters (2,048 points on the 180 x 180 x 1
pillar grid, 40,000 pillars, 20 points, a cluster over the point cap).
``cell_params``, the float32 origin and reciprocal that kernel K10 takes as
scalars, must give the plain version's cells on the flagship cloud's
coordinates next to a cell edge, the 5 that a true division would move
among them.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from unibev_tpu.flagship import PC_RANGE, VOXEL_SIZE
from unibev_tpu.ops.voxelize import voxelize_and_encode as jax_voxelize

from unibev_tpu_torch.flagship import (RADAR_POINTS, RADAR_VOXEL_SIZE,
                                       synthetic_batch)
from unibev_tpu_torch.ops.voxelize import (cell_params, voxelize_and_encode,
                                           voxelize_and_encode_reference)

VOXEL = (0.5, 0.5, 0.5)
RANGE = (-4.0, -4.0, -1.0, 4.0, 4.0, 1.0)
GRID = (16, 16, 4)


def _cloud(seed, P=3000):
    """Uniform points over a range 20% wider than RANGE (so some fall
    outside), a dense cluster of 40 points in each of three voxels, and a
    tenth of the points masked."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-1, 1, (P, 5)).astype(np.float32)
    pts[:, 0:2] *= 4.8
    pts[:, 2] *= 1.2
    for i, c in enumerate(((0.1, 0.1, 0.1), (-3.2, 2.6, -0.7), (3.9, -3.9, 0.9))):
        pts[40 * i:40 * (i + 1), :3] = np.asarray(c, np.float32) + rng.uniform(
            -0.05, 0.05, (40, 3)).astype(np.float32)
    mask = rng.rand(P) > 0.1
    return pts, mask


def _distinct(pts, mask, voxel, rng_, grid):
    """Occupied voxels of a cloud, counted with numpy."""
    inv = np.float32(1) / np.asarray(voxel, np.float32)
    g = np.floor((pts[:, :3] - np.asarray(rng_[:3], np.float32))
                 * inv).astype(np.int64)
    ok = mask & np.all((g >= 0) & (g < np.asarray(grid)), axis=1)
    return len(np.unique(g[ok] @ np.array([1, grid[0], grid[0] * grid[1]])))


def _check(got, want, atol=1e-6):
    for k in ("coords", "mask", "num_points"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)), err_msg=k)
    assert int(got.num_voxels) == int(want.num_voxels)
    np.testing.assert_allclose(got.feats.numpy(), np.asarray(want.feats),
                               atol=atol, rtol=1e-6)


@pytest.mark.parametrize("max_voxels,max_points", [(2000, 10), (300, 10),
                                                   (300, 3)],
                         ids=["below_cap", "capped", "capped_3pts"])
def test_voxelize_matches_jax(max_voxels, max_points):
    pts, mask = _cloud(0)
    want = jax_voxelize(jnp.asarray(pts), jnp.asarray(mask), VOXEL, RANGE,
                        GRID, max_voxels, max_points)
    got = voxelize_and_encode(torch.from_numpy(pts), torch.from_numpy(mask),
                              VOXEL, RANGE, GRID, max_voxels, max_points)
    _check(got, want)
    distinct = _distinct(pts, mask, VOXEL, RANGE, GRID)
    assert int(got.num_distinct) == distinct
    assert int(got.num_voxels) == min(distinct, max_voxels)
    # the cluster voxels hold more points than the cap keeps
    assert int(got.num_points.max()) == max_points
    if distinct > max_voxels:
        # the kept voxels are the smallest keys, ascending
        c = got.coords[got.mask].long()
        key = (c[:, 0] * GRID[1] + c[:, 1]) * GRID[0] + c[:, 2]
        assert bool((key[1:] > key[:-1]).all())


def test_flagship_cloud_fills_the_voxel_cap():
    """The flagship synthetic batch at full size (300k points on the
    [1440, 1440, 40] grid, 120,000 voxels): equal to the JAX voxelizer, with
    298,949 distinct voxels before the cap."""
    pts = synthetic_batch(np.random.RandomState(0), device="cpu")["points"][0]
    grid = tuple(int(round((PC_RANGE[i + 3] - PC_RANGE[i]) / VOXEL_SIZE[i]))
                 for i in range(3))
    mask = torch.ones(pts.shape[0], dtype=torch.bool)
    got = voxelize_and_encode(pts, mask, VOXEL_SIZE, PC_RANGE, grid, 120000)
    want = jax_voxelize(jnp.asarray(pts.numpy()), jnp.asarray(mask.numpy()),
                        VOXEL_SIZE, PC_RANGE, grid, 120000, 10)
    _check(got, want)
    assert int(got.num_distinct) == 298949 == _distinct(
        pts.numpy(), mask.numpy(), VOXEL_SIZE, PC_RANGE, grid)
    assert int(got.num_voxels) == 120000


RADAR_GRID = (180, 180, 1)


def _radar_cloud():
    """The synthetic batch's radar cloud (2,048 points, 7 columns) with 30
    points in one pillar, over the 20-point cap."""
    pts = synthetic_batch(np.random.RandomState(0), device="cpu",
                          R=RADAR_POINTS)["radar"][0].numpy().copy()
    rng = np.random.RandomState(1)
    pts[100:130, :2] = np.float32(10.3) + rng.uniform(
        0, 0.2, (30, 2)).astype(np.float32)
    return pts, np.ones(pts.shape[0], bool)


def test_reference_matches_jax_at_radar_parameters():
    """The plain version against JAX at the RC model's pillar grid: every
    point in range, one pillar over the cap, the rest far below both
    caps."""
    pts, mask = _radar_cloud()
    want = jax_voxelize(jnp.asarray(pts), jnp.asarray(mask), RADAR_VOXEL_SIZE,
                        PC_RANGE, RADAR_GRID, 40000, 20)
    got = voxelize_and_encode_reference(
        torch.from_numpy(pts), torch.from_numpy(mask), RADAR_VOXEL_SIZE,
        PC_RANGE, RADAR_GRID, 40000, 20)
    _check(got, want)
    distinct = _distinct(pts, mask, RADAR_VOXEL_SIZE, PC_RANGE, RADAR_GRID)
    assert int(got.num_voxels) == int(got.num_distinct) == distinct > 1900
    assert int(got.num_points.max()) == 20


def test_cell_params_give_the_plain_cells_on_edge_coordinates():
    """K10's float32 origin and reciprocal, in the kernel's arithmetic
    (float32 subtraction, then product), put each of the flagship cloud's
    points that lie within 1e-3 of a cell edge on some axis in the plain
    version's cell.  The plain version voxelizes those points with one
    voxel per cell and no cap, each point carrying its index as a
    feature: a point in another cell would change a voxel's count or mean."""
    origin, inv = cell_params(VOXEL_SIZE, PC_RANGE)
    np.testing.assert_array_equal(
        np.float32(origin), torch.tensor(PC_RANGE[:3]).numpy())
    np.testing.assert_array_equal(
        np.float32(inv), torch.tensor(VOXEL_SIZE).reciprocal().numpy())
    pts = synthetic_batch(np.random.RandomState(0), device="cpu")["points"][0]
    pts = pts.numpy()
    t = (pts[:, :3] - np.float32(origin)) * np.float32(inv)
    divided = np.floor((pts[:, :3] - np.float32(origin))
                       / np.asarray(VOXEL_SIZE, np.float32))
    near = (np.abs(t - np.round(t)) < 1e-3).any(1)
    moved = (divided != np.floor(t)).any(1)
    assert moved.sum() == 5 and near[moved].all()
    edge = pts[near].copy()
    n = edge.shape[0]
    edge[:, 3] = np.arange(n, dtype=np.float32)
    grid = (1440, 1440, 40)
    got = voxelize_and_encode_reference(
        torch.from_numpy(edge), torch.ones(n, dtype=torch.bool), VOXEL_SIZE,
        PC_RANGE, grid, n, n)
    g = np.floor((edge[:, :3] - np.float32(origin))
                 * np.float32(inv)).astype(np.int64)
    ok = np.all((g >= 0) & (g < np.asarray(grid)), axis=1)
    key = (g[:, 2] * grid[1] + g[:, 1]) * grid[0] + g[:, 0]
    keys, count = np.unique(key[ok], return_counts=True)
    sums = np.zeros(keys.size, np.float32)
    np.add.at(sums, np.searchsorted(keys, key[ok]), edge[ok, 3])
    v = keys.size
    assert 1000 < v == int(got.num_voxels)
    np.testing.assert_array_equal(
        got.coords[:v].numpy(),
        np.stack([keys // (grid[0] * grid[1]), keys // grid[0] % grid[1],
                  keys % grid[0]], 1))
    np.testing.assert_array_equal(got.num_points[:v].numpy(), count)
    np.testing.assert_array_equal(got.feats[:v, 3].numpy(),
                                  sums / count.astype(np.float32))
