"""The port's linear sum assignment (``core/bbox/lsa.py``) against the JAX
package's in-graph solver, scipy's optimum, and the JAX assigner.

Inputs come from numpy seeds.  The plain version runs the JAX loop's
float32 arithmetic in the same order with the same tie rule, so its
``col4row`` must equal ``jax.vmap`` of ``unibev_tpu.core.bbox.lsa.
linear_sum_assignment`` exactly: on continuous random costs and on integer
costs in [0, 8), full of ties.  Independently of both packages, its total
cost must be scipy's optimum (rtol 1e-6: float32 costs summed in float64
either way; ties make the assignment itself not unique).  A mask that is
not packed is solved on its valid rows' sub-matrix, as scipy solves that
sub-matrix.  Each shape compiles the JAX function once, so the shapes are
few.  The kernel K12 is held against the plain version on the card
(``tests/test_torch_kernels.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment as scipy_lsa

from unibev_tpu.core.bbox.assigners import HungarianAssigner3D as JaxAssigner
from unibev_tpu.core.bbox.lsa import linear_sum_assignment as jax_lsa

from unibev_tpu_torch.core.bbox.assigners import HungarianAssigner3D
from unibev_tpu_torch.core.bbox.lsa import (linear_sum_assignment,
                                            linear_sum_assignment_plain,
                                            solve_with_steps)
from unibev_tpu_torch.ops import _build

SHAPES = [(1, 1), (3, 5), (8, 24), (40, 900)]
RTOL = 1e-6


def _costs(kind, R, C, n, seed):
    """n (R, C) float32 problems: ``float`` continuous, ``int`` integers in
    [0, 8) (ties everywhere)."""
    rng = np.random.RandomState(seed)
    if kind == "float":
        return (rng.randn(n, R, C) * 3).astype(np.float32)
    return rng.randint(0, 8, (n, R, C)).astype(np.float32)


def _packed(R):
    """Every num_valid from 0 to R, one problem each: (num_valid, mask)."""
    num_valid = np.arange(R + 1, dtype=np.int32)
    return num_valid, np.arange(R)[None, :] < num_valid[:, None]


def _total(cost, rows, cols):
    return float(cost[rows, cols].astype(np.float64).sum())


@pytest.mark.parametrize("kind", ["float", "int"])
@pytest.mark.parametrize("R,C", SHAPES)
def test_plain_matches_jax_exactly(R, C, kind):
    num_valid, mask = _packed(R)
    cost = _costs(kind, R, C, R + 1, seed=R * 1000 + C)
    want = np.asarray(jax.jit(jax.vmap(jax_lsa))(jnp.asarray(cost),
                                                 jnp.asarray(num_valid)))
    got = linear_sum_assignment_plain(torch.from_numpy(cost),
                                      torch.from_numpy(mask))
    assert got.dtype == torch.int32 and got.shape == (R + 1, R)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[~mask] == -1).all()


@pytest.mark.parametrize("kind", ["float", "int"])
@pytest.mark.parametrize("R,C", SHAPES)
def test_plain_reaches_scipy_optimum(R, C, kind):
    _, mask = _packed(R)
    cost = _costs(kind, R, C, R + 1, seed=R * 1000 + C + 1)
    got = linear_sum_assignment_plain(torch.from_numpy(cost),
                                      torch.from_numpy(mask)).numpy()
    for p, n in enumerate(mask.sum(1)):
        cols = got[p, :n]
        assert len(set(cols.tolist())) == n and (cols >= 0).all()
        r, c = scipy_lsa(cost[p, :n])
        np.testing.assert_allclose(_total(cost[p], np.arange(n), cols),
                                   _total(cost[p], r, c), rtol=RTOL)


@pytest.mark.parametrize("kind", ["float", "int"])
def test_unpacked_masks_solve_the_valid_rows(kind):
    """Masks with holes: the valid rows' sub-matrix, as scipy solves it
    (the same assignment where the optimum is unique, the float costs)."""
    R, C, n = 8, 24, 6
    rng = np.random.RandomState(5)
    mask = rng.rand(n, R) < 0.6
    mask[0] = False
    mask[1] = True
    mask[2, ::2] = False
    cost = _costs(kind, R, C, n, seed=6)
    got = linear_sum_assignment_plain(torch.from_numpy(cost),
                                      torch.from_numpy(mask)).numpy()
    for p in range(n):
        rows = np.flatnonzero(mask[p])
        assert (got[p, ~mask[p]] == -1).all()
        if rows.size == 0:
            continue
        r, c = scipy_lsa(cost[p][rows])
        np.testing.assert_allclose(_total(cost[p], rows, got[p, rows]),
                                   _total(cost[p], rows[r], c), rtol=RTOL)
        if kind == "float":
            np.testing.assert_array_equal(got[p, rows[r]], c)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    cost = _costs("int", 8, 24, 3, seed=9)
    mask = np.ones((3, 8), bool)
    mask[1, 5:] = False
    before = dict(_build.launches)
    got = linear_sum_assignment(torch.from_numpy(cost), torch.from_numpy(mask))
    want, steps = solve_with_steps(torch.from_numpy(cost),
                                   torch.from_numpy(mask))
    assert torch.equal(got, want) and dict(_build.launches) == before
    # one Dijkstra step at least per valid row
    assert (steps >= torch.from_numpy(mask.sum(1))).all()


def test_plain_refuses_more_rows_than_columns():
    with pytest.raises(ValueError, match="rows <= columns"):
        linear_sum_assignment_plain(torch.zeros(1, 3, 2),
                                    torch.ones(1, 3, dtype=torch.bool))


def test_assigner_matches_jax_on_a_padded_batch():
    """(L * B, Q, G) problems with padded gt rows (packed), one problem with
    no valid row, as the head's loss assigns them."""
    rng = np.random.RandomState(11)
    n, Q, G = 6, 40, 12
    bbox_pred = rng.randn(n, Q, 10).astype(np.float32)
    cls_pred = rng.randn(n, Q, 10).astype(np.float32)
    gt = rng.randn(n, G, 9).astype(np.float32)
    gt[..., 3:6] = np.abs(gt[..., 3:6]) + 0.5
    labels = rng.randint(0, 10, (n, G))
    counts = np.array([12, 7, 0, 1, 11, 3])
    valid = np.arange(G)[None, :] < counts[:, None]
    gt[~valid] = 0.0          # padding rows, as the data path leaves them
    cfg = dict(cls_cost=dict(type="FocalLossCost", weight=2.0),
               reg_cost=dict(type="BBox3DL1CostBEVFormer", weight=0.25))
    res = jax.vmap(JaxAssigner(**cfg).assign)(*map(jnp.asarray, (
        bbox_pred, cls_pred, gt, labels, valid)))
    gt_inds, pos = HungarianAssigner3D(**cfg).assign(*map(torch.from_numpy, (
        bbox_pred, cls_pred, gt, labels, valid)))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(res.pos_mask))
    np.testing.assert_array_equal(gt_inds.numpy(), np.asarray(res.gt_inds))
    assert pos.sum(-1).tolist() == counts.tolist()
    assert gt_inds.dtype == torch.int64 and pos.dtype == torch.bool
