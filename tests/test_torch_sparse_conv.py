"""Sparse 3D convolution: the port's rulebook and conv against the JAX package.

* ``build_table``: the dense cell -> row table equals the JAX table's logical
  entries (sentinel = row capacity V);
* the plain version of K6 (``sparse_nbr_reference``) equals
  ``subm_neighbor_idx`` and ``strided_neighbor_idx`` for every kernel the
  middle encoder runs: k3 s2 with padding 1 and (0, 1, 1), and (3, 1, 1)
  s(2, 1, 1);
* ``downsample_with_table`` with a capacity below the active-site count
  (coords, mask, overflow and the new table equal: the smallest flat keys
  are kept);
* the plain version of K7 (``sparse_conv_reference``) against
  ``gather_conv`` (atol/rtol 1e-4) and against a dense ``conv3d`` oracle;
* ``to_dense`` equals the JAX ``to_dense``.

Index tables, coords, masks and counts are compared exactly.  Rows are
shuffled, so the tables do not depend on the active set being sorted.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp
from unibev_tpu.ops import sparse_conv as jsc

from test_sparse_conv import dense_of, make_sparse
from unibev_tpu_torch.ops import _build
from unibev_tpu_torch.ops.sparse_conv import (SparseGrid, build_table,
                                              downsample_with_table,
                                              sparse_conv,
                                              sparse_conv_reference,
                                              sparse_nbr, sparse_nbr_reference,
                                              strided_neighbor_idx,
                                              subm_neighbor_idx, to_dense)

TOL = dict(atol=1e-4, rtol=1e-4)
B, D, H, W, CIN, COUT = 2, 9, 12, 11, 5, 6
STRIDED = [((3, 3, 3), (2, 2, 2), (1, 1, 1)),
           ((3, 3, 3), (2, 2, 2), (0, 1, 1)),
           ((3, 1, 1), (2, 1, 1), (0, 0, 0))]
IDS = ["k3s2p1", "k3s2p011", "conv_out"]


@pytest.fixture(scope="module")
def sparse():
    """An active set of 300 of the 2376 cells in 400 shuffled rows, as
    numpy, JAX and port grids with their tables."""
    rng = np.random.RandomState(0)
    feats, coords, mask = make_sparse(rng, B, D, H, W, CIN, 300, 400)
    perm = rng.permutation(400)
    feats, coords, mask = feats[perm], coords[perm], mask[perm]
    jgrid = jsc.SparseGrid(jnp.asarray(coords), jnp.asarray(mask), (D, H, W), B)
    grid = SparseGrid(torch.from_numpy(coords), torch.from_numpy(mask),
                      (D, H, W), B)
    return dict(feats=feats, coords=coords, mask=mask, jgrid=jgrid,
                jtable=jsc.build_table(jgrid), grid=grid, table=build_table(grid))


def _out_shape(kernel, stride, padding):
    return tuple((s + 2 * p - k) // st + 1 for s, p, k, st in
                 zip((D, H, W), padding, kernel, stride))


def test_build_table_matches_jax(sparse):
    want = np.asarray(jsc.table_entries(sparse["jtable"]))
    got = sparse["table"]
    assert got.dtype == torch.int32 and got.shape == (B * D * H * W,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int((got != 400).sum()) == 300


def test_subm_rulebook_matches_jax(sparse):
    want = np.asarray(jsc.subm_neighbor_idx(sparse["jgrid"], sparse["jtable"]))
    got = subm_neighbor_idx(sparse["grid"], sparse["table"])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kernel,stride,padding", STRIDED, ids=IDS)
def test_downsample_and_strided_rulebook_match_jax(sparse, kernel, stride,
                                                   padding):
    """Capacity 60, below the active sites of every kernel here: the
    smallest flat keys are kept, the rest counted as overflow."""
    out_shape = _out_shape(kernel, stride, padding)
    cap = 60
    jco, jmo, jtab, jover = jsc.downsample_with_table(
        jnp.asarray(sparse["coords"]), jnp.asarray(sparse["mask"]), kernel,
        stride, padding, out_shape, cap, B, in_shape=(D, H, W),
        table_in=sparse["jtable"])
    co, mo, tab, over = downsample_with_table(sparse["grid"], sparse["table"],
                                              kernel, stride, padding,
                                              out_shape, cap)
    assert int(jover) > 0
    assert int(over) == int(jover)
    np.testing.assert_array_equal(co.numpy(), np.asarray(jco))
    np.testing.assert_array_equal(mo.numpy(), np.asarray(jmo))
    np.testing.assert_array_equal(tab.numpy(), np.asarray(jsc.table_entries(jtab)))

    want = jsc.strided_neighbor_idx(sparse["jgrid"], sparse["jtable"], jco, jmo,
                                    kernel, stride, padding)
    got = strided_neighbor_idx(sparse["grid"], sparse["table"], co, mo, kernel,
                               stride, padding)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_downsample_below_capacity_keeps_every_site(sparse):
    kernel, stride, padding = STRIDED[0]
    out_shape = _out_shape(kernel, stride, padding)
    co, mo, _, over = downsample_with_table(sparse["grid"], sparse["table"],
                                            kernel, stride, padding,
                                            out_shape, 1000)
    # spconv's output sites: every site whose window covers an active cell
    dense = torch.zeros(B, 1, D, H, W)
    c = torch.from_numpy(sparse["coords"][sparse["mask"]]).long()
    dense[c[:, 0], 0, c[:, 1], c[:, 2], c[:, 3]] = 1
    sites = F.max_pool3d(dense, kernel, stride, padding)[:, 0].nonzero()
    assert int(over) == 0
    np.testing.assert_array_equal(co[mo].numpy(), sites.numpy())
    assert bool((co[~mo] == -1).all())


def test_conv_matches_jax_gather_conv(sparse):
    rng = np.random.RandomState(1)
    nidx = subm_neighbor_idx(sparse["grid"], sparse["table"])
    w = (rng.randn(27 * CIN, COUT) * 0.1).astype(np.float32)
    want = jsc.gather_conv(jnp.asarray(sparse["feats"]), jnp.asarray(nidx.numpy()),
                           jnp.asarray(w), jnp.asarray(sparse["mask"]))
    got = sparse_conv_reference(torch.from_numpy(sparse["feats"]), nidx,
                                torch.from_numpy(w), sparse["grid"].mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kernel,stride,padding", [((3, 3, 3), (1, 1, 1),
                                                    (1, 1, 1))] + STRIDED,
                         ids=["subm"] + IDS)
def test_conv_matches_dense_conv3d(sparse, kernel, stride, padding):
    """A submanifold conv is the dense conv read at the active input sites;
    a strided one is the dense strided conv read at the output sites."""
    rng = np.random.RandomState(2)
    K = kernel[0] * kernel[1] * kernel[2]
    w = (rng.randn(K * CIN, COUT) * 0.1).astype(np.float32)
    grid, table = sparse["grid"], sparse["table"]
    if stride == (1, 1, 1):
        nidx = subm_neighbor_idx(grid, table)
        co, mo = grid.coords, grid.mask
    else:
        co, mo, _, _ = downsample_with_table(
            grid, table, kernel, stride, padding,
            _out_shape(kernel, stride, padding), 1000)
        nidx = strided_neighbor_idx(grid, table, co, mo, kernel, stride, padding)
    got = sparse_conv_reference(torch.from_numpy(sparse["feats"]), nidx,
                                torch.from_numpy(w), mo)
    dense = dense_of(sparse["feats"], sparse["coords"], sparse["mask"], B, D,
                     H, W, CIN)
    wt = torch.from_numpy(w.reshape(*kernel, CIN, COUT)).permute(4, 3, 0, 1, 2)
    ref = F.conv3d(torch.from_numpy(dense).permute(0, 4, 1, 2, 3), wt,
                   stride=stride, padding=padding).permute(0, 2, 3, 4, 1)
    c = co[mo].long()
    np.testing.assert_allclose(got[mo].numpy(),
                               ref[c[:, 0], c[:, 1], c[:, 2], c[:, 3]].numpy(),
                               **TOL)
    assert bool((got[~mo] == 0).all())


def test_to_dense_matches_jax(sparse):
    want = jsc.to_dense(jnp.asarray(sparse["feats"]), sparse["jgrid"])
    got = to_dense(torch.from_numpy(sparse["feats"]), sparse["grid"])
    assert got.shape == (B, D, H, W, CIN)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cpu_wrappers_take_the_plain_versions(sparse):
    grid, table = sparse["grid"], sparse["table"]
    before = dict(_build.launches)
    nidx = sparse_nbr(table, 400, (D, H, W), grid.coords, grid.mask,
                      (3, 3, 3), (1, 1, 1), (1, 1, 1))
    torch.testing.assert_close(nidx, sparse_nbr_reference(
        table, 400, (D, H, W), grid.coords, grid.mask, (3, 3, 3), (1, 1, 1),
        (1, 1, 1)), rtol=0, atol=0)
    feats = torch.from_numpy(sparse["feats"])
    w = torch.ones(27 * CIN, COUT)
    torch.testing.assert_close(sparse_conv(feats, nidx, w, grid.mask),
                               sparse_conv_reference(feats, nidx, w, grid.mask),
                               rtol=0, atol=0)
    assert dict(_build.launches) == before
