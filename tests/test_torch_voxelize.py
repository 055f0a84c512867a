"""The hard voxelizer with the mean VFE, the port against the JAX package.

Clouds hold voxels with more points than ``max_points_per_voxel``, points
out of range, masked points, and (in the capped cases) more distinct voxels
than ``max_voxels``, so that the smallest-key cap is held.  Integers (coords,
mask, counts) must be equal; the voxel means agree to 1e-6 (a mean of at
most ``max_points_per_voxel`` float32 points summed in another order).
The flagship synthetic batch's cloud is voxelized at full size: its 300k
uniform points fill 298,949 distinct voxels, far above the 120,000 cap.
Cells are ``floor((p - x0) * (1 / v))`` with the float32 reciprocal, as XLA
compiles the JAX op's division.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from unibev_tpu.flagship import PC_RANGE, VOXEL_SIZE
from unibev_tpu.ops.voxelize import voxelize_and_encode as jax_voxelize

from unibev_tpu_torch.flagship import synthetic_batch
from unibev_tpu_torch.ops.voxelize import voxelize_and_encode

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
