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
* ``to_dense`` equals the JAX ``to_dense``;
* on active sets that hold both edge cells of many 32-cell words (so x
  windows straddle two words, the per-sample cell count not a multiple of
  32, B = 2): the decoded compact table, both rulebooks, the downsample at a
  saturated capacity and the inverse rulebook equal the JAX package's;
* on the flagship cloud (300k points, 120,000 voxels on [41, 1440, 1440]):
  the four strided convs' overflows, and res 1's sites against a dense
  OR-pool written here;
* the plain versions of kernel K11, ``build_table_reference`` and
  ``downsample_with_table_reference`` (what ``build_table`` and
  ``downsample_with_table`` run on the CPU), called by name on the word-edge
  active sets at a capacity above every site count (padding rows with -1
  coords, no overflow): their tables, coords, masks and overflows equal the
  JAX package's.

Index tables, coords, masks and counts are compared exactly.  Rows are
shuffled, so the tables do not depend on the active set being sorted.
"""

import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp
from unibev_tpu.ops import sparse_conv as jsc

from test_sparse_conv import dense_of, make_sparse
from unibev_tpu_torch.flagship import PC_RANGE, VOXEL_SIZE, synthetic_batch
from unibev_tpu_torch.ops import _build
from unibev_tpu_torch.ops.voxelize import voxelize_and_encode
from unibev_tpu_torch.ops.sparse_conv import (SparseGrid, build_table,
                                              build_table_reference,
                                              downsample_with_table,
                                              downsample_with_table_reference,
                                              sparse_conv,
                                              sparse_conv_reference,
                                              sparse_nbr, sparse_nbr_reference,
                                              strided_neighbor_idx,
                                              subm_neighbor_idx, table_entries,
                                              to_dense)

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
    got = table_entries(sparse["table"])
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
    co, mo, tab, over = downsample_with_table(sparse["grid"], kernel, stride,
                                              padding, out_shape, cap)
    assert int(jover) > 0
    assert int(over) == int(jover)
    np.testing.assert_array_equal(co.numpy(), np.asarray(jco))
    np.testing.assert_array_equal(mo.numpy(), np.asarray(jmo))
    np.testing.assert_array_equal(table_entries(tab).numpy(),
                                  np.asarray(jsc.table_entries(jtab)))

    want = jsc.strided_neighbor_idx(sparse["jgrid"], sparse["jtable"], jco, jmo,
                                    kernel, stride, padding)
    got = strided_neighbor_idx(sparse["grid"], sparse["table"], co, mo, kernel,
                               stride, padding)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_downsample_below_capacity_keeps_every_site(sparse):
    kernel, stride, padding = STRIDED[0]
    out_shape = _out_shape(kernel, stride, padding)
    co, mo, _, over = downsample_with_table(sparse["grid"], kernel, stride,
                                            padding, out_shape, 1000)
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
            grid, kernel, stride, padding,
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


def _word_edge_grid():
    """300 rows at B = 2 on the (9, 12, 11) grid (1188 cells a sample, not a
    multiple of 32): every cell on either edge of a 32-cell word and 60
    random others, shuffled, 40 padding rows."""
    rng = np.random.RandomState(3)
    size = B * D * H * W
    cells = np.arange(size)
    edge = cells[(cells % 32 == 0) | (cells % 32 == 31)]
    rest = rng.choice(np.setdiff1d(cells, edge), 260 - edge.size, replace=False)
    live = np.concatenate([edge, rest])
    coords = np.stack([live // (D * H * W), live // (H * W) % D,
                       live // W % H, live % W], 1)
    coords = np.concatenate([coords, np.full((40, 4), -1)]).astype(np.int32)
    coords = coords[rng.permutation(300)]
    mask = coords[:, 0] >= 0
    # x windows that straddle two words: a live cell at bit 31, x < W - 1
    assert ((live % 32 == 31) & (live % W < W - 1)).sum() > 10
    return (jsc.SparseGrid(jnp.asarray(coords), jnp.asarray(mask), (D, H, W), B),
            SparseGrid(torch.from_numpy(coords), torch.from_numpy(mask),
                       (D, H, W), B))


@pytest.mark.parametrize("case", ["subm"] + IDS)
def test_compact_table_on_word_edges_matches_jax(case):
    """Decoded table, rulebook and (strided) downsample at capacity 40,
    below every kernel's site count, and inverse rulebook: all exact."""
    from unibev_tpu_torch.ops.sparse_conv import sparse_inv_nbr_reference
    jgrid, grid = _word_edge_grid()
    jtable, table = jsc.build_table(jgrid), build_table(grid)
    np.testing.assert_array_equal(table_entries(table).numpy(),
                                  np.asarray(jsc.table_entries(jtable)))
    if case == "subm":
        np.testing.assert_array_equal(
            subm_neighbor_idx(grid, table).numpy(),
            np.asarray(jsc.subm_neighbor_idx(jgrid, jtable)))
        return
    kernel, stride, padding = STRIDED[IDS.index(case)]
    out_shape, cap = _out_shape(kernel, stride, padding), 40
    jco, jmo, jtab, jover = jsc.downsample_with_table(
        jgrid.coords, jgrid.mask, kernel, stride, padding, out_shape, cap, B,
        in_shape=(D, H, W), table_in=jtable)
    co, mo, tab, over = downsample_with_table(grid, kernel, stride, padding,
                                              out_shape, cap)
    assert int(over) == int(jover) > 0
    np.testing.assert_array_equal(co.numpy(), np.asarray(jco))
    np.testing.assert_array_equal(mo.numpy(), np.asarray(jmo))
    np.testing.assert_array_equal(table_entries(tab).numpy(),
                                  np.asarray(jsc.table_entries(jtab)))
    np.testing.assert_array_equal(
        strided_neighbor_idx(grid, table, co, mo, kernel, stride,
                             padding).numpy(),
        np.asarray(jsc.strided_neighbor_idx(jgrid, jtable, jco, jmo, kernel,
                                            stride, padding)))
    inv = sparse_inv_nbr_reference(tab, cap, out_shape, grid.coords,
                                   grid.mask, kernel, stride, padding)
    np.testing.assert_array_equal(
        inv.numpy(), np.asarray(jsc.inverse_strided_idx(
            jgrid.coords, jgrid.mask, jtab, kernel, stride, padding,
            out_shape, cap)))


@pytest.mark.parametrize("case", ["table"] + IDS)
def test_k11_plain_versions_on_word_edges_match_jax(case):
    """The plain versions of K11 by name at B = 2 on the word-edge active
    set: the decoded table, and each strided conv's sites at capacity 1000
    (above every site count, so the tail rows are padding) with their table
    and overflow, exact."""
    jgrid, grid = _word_edge_grid()
    if case == "table":
        table = build_table_reference(grid)
        assert table.sentinel == grid.coords.shape[0] == table.rows.numel()
        np.testing.assert_array_equal(
            table_entries(table).numpy(),
            np.asarray(jsc.table_entries(jsc.build_table(jgrid))))
        return
    kernel, stride, padding = STRIDED[IDS.index(case)]
    out_shape, cap = _out_shape(kernel, stride, padding), 1000
    jco, jmo, jtab, jover = jsc.downsample_with_table(
        jgrid.coords, jgrid.mask, kernel, stride, padding, out_shape, cap, B,
        in_shape=(D, H, W), table_in=jsc.build_table(jgrid))
    co, mo, tab, over = downsample_with_table_reference(
        grid, kernel, stride, padding, out_shape, cap)
    assert over.dtype == torch.int64 and int(over) == int(jover) == 0
    assert 0 < int(mo.sum()) < cap and bool((co[~mo] == -1).all())
    assert tab.sentinel == cap == tab.rows.numel()
    np.testing.assert_array_equal(co.numpy(), np.asarray(jco))
    np.testing.assert_array_equal(mo.numpy(), np.asarray(jmo))
    np.testing.assert_array_equal(table_entries(tab).numpy(),
                                  np.asarray(jsc.table_entries(jtab)))


def _or_pool(occ, kernel, stride, padding):
    """The dense strided OR-pool of a (D, H, W) bool grid, axis by axis."""
    for a, (k, s, p) in enumerate(zip(kernel, stride, padding)):
        occ = F.pad(occ, [0, 0] * (2 - a) + [p, p])
        n = (occ.shape[a] - k) // s + 1
        occ = functools.reduce(torch.logical_or, [
            occ.narrow(a, t, s * (n - 1) + 1)[(slice(None),) * a
                                              + (slice(None, None, s),)]
            for t in range(k)])
    return occ


def test_flagship_cloud_downsamples():
    """The flagship synthetic cloud voxelized (120,000 of 298,949 voxels),
    then the SparseEncoder's four strided convs on the compact tables: the
    sites each finds beyond its capacity, and res 1's 90,000 sites equal
    the first of a dense OR-pool of the res-0 occupancy."""
    pts = synthetic_batch(np.random.RandomState(0), device="cpu")["points"][0]
    vox = voxelize_and_encode(pts, torch.ones(pts.shape[0], dtype=torch.bool),
                              VOXEL_SIZE, PC_RANGE, (1440, 1440, 40), 120000)
    coords = torch.cat([torch.zeros_like(vox.coords[:, :1]), vox.coords], 1)
    grid = SparseGrid(torch.where(vox.mask[:, None], coords, -1), vox.mask,
                      (41, 1440, 1440), 1)
    overflow = []
    for i, (kernel, stride, padding, cap) in enumerate([
            ((3, 3, 3), (2, 2, 2), (1, 1, 1), 90000),
            ((3, 3, 3), (2, 2, 2), (1, 1, 1), 60000),
            ((3, 3, 3), (2, 2, 2), (0, 1, 1), 40000),
            ((3, 1, 1), (2, 1, 1), (0, 0, 0), 40000)]):
        out_shape = tuple((s + 2 * p - k) // st + 1 for s, p, k, st in
                          zip(grid.shape, padding, kernel, stride))
        co, mo, _, over = downsample_with_table(grid, kernel, stride, padding,
                                                out_shape, cap)
        if i == 0:
            occ = torch.zeros(grid.shape, dtype=torch.bool)
            live = grid.coords[grid.mask].long()
            occ[live[:, 1], live[:, 2], live[:, 3]] = True
            sites = _or_pool(occ, kernel, stride, padding).nonzero()
            assert sites.shape[0] == cap + int(over)
            assert bool((co[:, 0][mo] == 0).all())
            np.testing.assert_array_equal(co[mo][:, 1:].numpy(),
                                          sites[:cap].numpy())
        overflow.append(int(over))
        grid = SparseGrid(co, mo, out_shape, 1)
    assert int(vox.num_distinct) == 298949
    assert overflow == [282206, 80806, 17064, 0]
