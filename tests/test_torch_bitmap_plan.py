"""The launch plans of the voxelizer K10 (``ops/voxelize.py::voxelize_plan``)
and of the compact tables K11 (``ops/sparse_conv.py::active_set_plan``), on
the CPU.

A plan is what a wrapper hands to its C entry point as int64s in the order
of its fields (``csrc/voxelize.cu`` and ``csrc/active_set.cu`` name them in
an enum): the workspace's regions (the bitmap, the scan state of the
single-pass scan, the counts, and K10's keys and slots or K11's map and
outputs) and the launch sizes.  The C entry points refuse a plan that
disagrees with their own check; here the plans
are held at every site of the flagship LC, L and RC models and of the tiny
LiDAR and radar models, against a restatement of those checks, with the
regions contiguous, 16-byte aligned, a status word per scan tile and room
for the ticket.  No CUDA is imported; the file runs in seconds.
"""

import os
import re

import pytest
import torch

import chip_smoke
from unibev_tpu_torch.flagship import (RADAR_POINTS, flagship_model_cfg,
                                       tiny_model_cfg)
from unibev_tpu_torch.ops import _build
from unibev_tpu_torch.ops.sparse_conv import (ActiveSetPlan, _table_views,
                                              active_set_plan)
from unibev_tpu_torch.ops.voxelize import (VoxelizePlan, _result_views,
                                           voxelize_plan)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "unibev_tpu_torch", "csrc")
TILE = 8192          # words a scan tile (kTileWords of csrc/bitmap.cuh)
TINY_RADAR = chip_smoke.TINY_RADAR


def _voxel_site(layer, points, features, pillars=False):
    """(P, F, grid, max_voxels, max_points) of a voxel layer, the grid as
    the detector computes it (z collapsed for pillars)."""
    r, v = layer["point_cloud_range"], layer["voxel_size"]
    grid = tuple(int(round((r[i + 3] - r[i]) / v[i])) for i in range(3))
    if pillars:
        grid = grid[:2] + (1,)
    mv = layer["max_voxels"]
    return (points, features, grid, mv[1] if isinstance(mv, (tuple, list))
            else mv, layer["max_num_points"])


FLAGSHIP = flagship_model_cfg(dtype=torch.float32)
FLAGSHIP_RC = flagship_model_cfg(use_lidar=False, use_radar=True,
                                 dtype=torch.float32)
TINY = tiny_model_cfg(use_lidar=True)
TINY_RC = tiny_model_cfg(use_radar=True)
K10_SITES = {
    "flagship_lidar": _voxel_site(FLAGSHIP["pts_voxel_layer"], 300000, 5),
    "flagship_radar": _voxel_site(FLAGSHIP_RC["radar_voxel_layer"],
                                  RADAR_POINTS, 7, pillars=True),
    "tiny_lidar": _voxel_site(TINY["pts_voxel_layer"], 1024, 5),
    "tiny_radar": _voxel_site(TINY_RC["radar_voxel_layer"], TINY_RADAR, 7,
                              pillars=True),
    "empty_cloud": (0, 5, (16, 16, 4), 300, 10),
}


def _encoder_sites(cfg, batch):
    """{name: active_set_plan's shape arguments} of one SparseEncoder
    forward: the res-0 table and the four strided convs, each on the
    previous one's active set, as chip_smoke.STRIDED_CONVS lays them out."""
    enc = cfg["pts_middle_encoder"]
    caps = enc["capacities"]
    shape = tuple(enc["sparse_shape"])
    sites = {"table0": (caps[0], batch, shape, 0, (1, 1, 1), (1, 1, 1),
                        (0, 0, 0), shape, 0)}
    convs = [((3, 3, 3), (2, 2, 2), p, c)
             for p, c in zip(chip_smoke.DOWN_PADDINGS, caps[1:])] + [
                 ((3, 1, 1), (2, 1, 1), (0, 0, 0), caps[-1])]
    rows = caps[0]
    for i, (kernel, stride, padding, capacity) in enumerate(convs):
        out = tuple((s + 2 * p - k) // st + 1 for s, p, k, st in
                    zip(shape, padding, kernel, stride))
        name = "conv_out" if i == 3 else f"down{i}"
        sites[name] = (rows, batch, shape, 1, kernel, stride, padding, out,
                       capacity)
        shape, rows = out, capacity
    return sites


K11_SITES = {f"{model}_{name}": args
             for model, cfg, batch in (("flagship", FLAGSHIP, 1),
                                       ("tiny", TINY, 1), ("tiny_b2", TINY, 2))
             for name, args in _encoder_sites(cfg, batch).items()}


def _k10(site):
    return voxelize_plan(*K10_SITES[site])


def _k11(site):
    return active_set_plan(*K11_SITES[site])


def test_the_sites_are_the_flagships():
    """The restated sites hold chip_smoke's flagship shapes."""
    assert K10_SITES["flagship_lidar"][2] == chip_smoke.VOXEL_GRID
    assert K10_SITES["flagship_radar"][2] == chip_smoke.RADAR_GRID
    assert K11_SITES["flagship_table0"][2] == chip_smoke.SPARSE_SHAPE
    assert [K11_SITES[f"flagship_{n}"][4:7] + K11_SITES[f"flagship_{n}"][8:]
            for n in ("down0", "down1", "down2", "conv_out")] \
        == [tuple(c) for c in chip_smoke.STRIDED_CONVS]
    assert _k11("flagship_table0").tiles == 325
    assert _k10("flagship_lidar").tiles == 317
    assert _build.BITMAP_TILE_WORDS == TILE


def _enum(source, name):
    """The names of a C enum, lower case without the k and underscores."""
    text = open(os.path.join(CSRC, source)).read()
    body = re.search(r"enum %s \{(.*?)\};" % name, text, re.S).group(1)
    names = [n.strip()[1:].lower() for n in body.split(",") if n.strip()]
    assert names[-1] == "planfields"
    return names[:-1]


@pytest.mark.parametrize("plan,source", [(VoxelizePlan, "voxelize.cu"),
                                         (ActiveSetPlan, "active_set.cu")])
def test_plan_fields_follow_the_c_enum(plan, source):
    assert _enum(source, plan.__name__) == [
        f.replace("_", "").lower() for f in plan._fields]


def _round(n, m):
    return -(-n // m) * m


def _state_words(tiles):
    """The scan state: 8 bytes a tile, the ticket and the total, in whole
    16-byte vectors (scan_state_words of csrc/bitmap.cuh)."""
    return _round(2 * tiles + 2, 4)


# the fields of a plan that restate its arguments
K10_SITES_FIELDS = ("points", "features", "X", "Y", "Z", "max_voxels",
                    "max_points")
K11_SITES_FIELDS = ("rows_in", "batch", "D", "H", "W", "mode", "kz", "ky",
                    "kx", "sz", "sy", "sx", "pz", "py", "px", "Do", "Ho",
                    "Wo", "capacity")


def _contiguous(regions, end):
    """Regions (start, length used, extent) of one buffer: each starts
    where the last ends and holds its use, the last ends at ``end``."""
    at = 0
    for start, used, extent in regions:
        assert start == at and used <= extent
        at = start + extent
    assert at == end


def _restated_k10(P, F, grid, M, K):
    """csrc/voxelize.cu's expected_plan, restated: the layout fields."""
    words = -(-(grid[0] * grid[1] * grid[2]) // 32)
    padded = _round(words, TILE)
    tiles = padded // TILE
    rows = min(M, P)
    state = padded
    dirs = state + _state_words(tiles)
    keys = dirs + padded // 8
    slots = keys + _round(P, 4)
    coords = _round(4 * M * F, 16)
    num_points = coords + _round(12 * M, 16)
    fill = -(-(dirs // 4 + rows * K) // 256)
    return dict(rows=rows, words=words, padded=padded, tiles=tiles,
                state_offset=state, dir_offset=dirs, keys_offset=keys,
                slots_offset=slots, work_words=slots + rows * K,
                zero_vectors=dirs // 4, slot_words=rows * K,
                coords_offset=coords, num_points_offset=num_points,
                num_voxels_offset=num_points + _round(4 * M, 16),
                num_distinct_offset=num_points + _round(4 * M, 16) + 16,
                mask_offset=num_points + _round(4 * M, 16) + 32,
                out_bytes=num_points + _round(4 * M, 16) + 32 + _round(M, 16),
                fill_blocks=min(fill, 4096), point_blocks=-(-P // 256),
                voxel_blocks=-(-M // 256))


@pytest.mark.parametrize("site", list(K10_SITES))
def test_k10_plan_against_the_c_check(site):
    plan = _k10(site)
    want = _restated_k10(*K10_SITES[site])
    assert {k: getattr(plan, k) for k in want} == want
    assert set(want) | set(K10_SITES_FIELDS) == set(plan._fields)


@pytest.mark.parametrize("site", list(K10_SITES))
def test_k10_regions_are_contiguous_and_aligned(site):
    plan = _k10(site)
    P, F, M, K = plan.points, plan.features, plan.max_voxels, plan.max_points
    # the workspace, int32 words: bitmap, scan state, a count per 8-word
    # sector, keys, slots
    regions = [(0, plan.words, plan.padded),
               (plan.state_offset, 2 * plan.tiles + 2,
                plan.dir_offset - plan.state_offset),
               (plan.dir_offset, plan.padded // 8,
                plan.keys_offset - plan.dir_offset),
               (plan.keys_offset, P, plan.slots_offset - plan.keys_offset),
               (plan.slots_offset, plan.rows * K,
                plan.work_words - plan.slots_offset)]
    _contiguous(regions, plan.work_words)
    assert all(start % 4 == 0 for start, _, _ in regions)
    # a status word (8 bytes) a tile, then the ticket and the total
    assert 4 * (plan.dir_offset - plan.state_offset) >= 8 * plan.tiles + 8
    # the fill zeroes the bitmap and the scan state, nothing more
    assert 4 * plan.zero_vectors == plan.dir_offset
    # the outputs, bytes: feats, coords, num_points, num_voxels,
    # num_distinct, mask
    starts = [0, plan.coords_offset, plan.num_points_offset,
              plan.num_voxels_offset, plan.num_distinct_offset,
              plan.mask_offset, plan.out_bytes]
    used = [4 * M * F, 12 * M, 4 * M, 4, 8, M]
    _contiguous([(a, u, b - a) for a, u, b in zip(starts, used, starts[1:])],
                plan.out_bytes)
    assert all(a % 16 == 0 for a in starts)


@pytest.mark.parametrize("site", ["flagship_lidar", "flagship_radar"])
def test_k10_outputs_are_views_at_the_plan_offsets(site):
    plan = _k10(site)
    out = torch.zeros(plan.out_bytes, dtype=torch.uint8)
    res = _result_views(out, plan)
    M, F = plan.max_voxels, plan.features
    want = dict(feats=(0, (M, F), torch.float32),
                coords=(plan.coords_offset, (M, 3), torch.int32),
                num_points=(plan.num_points_offset, (M,), torch.int32),
                num_voxels=(plan.num_voxels_offset, (), torch.int32),
                num_distinct=(plan.num_distinct_offset, (), torch.int64),
                mask=(plan.mask_offset, (M,), torch.bool))
    for name, (offset, shape, dtype) in want.items():
        t = getattr(res, name)
        assert t.data_ptr() - out.data_ptr() == offset, name
        assert tuple(t.shape) == shape and t.dtype == dtype, name
        assert t.is_contiguous()


def _restated_k11(V, batch, shape, mode, kernel, stride, padding, out_shape,
                  capacity):
    """csrc/active_set.cu's expected_plan, restated: the layout fields."""
    size = batch * out_shape[0] * out_shape[1] * out_shape[2]
    words = -(-size // 32)
    padded = _round(words, TILE)
    tiles = padded // TILE
    base = padded + _state_words(tiles)
    rows = base + padded
    fill = min(-(-(base // 4) // 256), 4096)
    want = dict(words=words, padded=padded, tiles=tiles, state_offset=padded,
                base_offset=base, rows_offset=rows, zero_vectors=base // 4,
                fill_blocks=fill, row_blocks=-(-V // 256))
    if mode == 0:
        end = rows + _round(V, 4)
        return dict(want, aggregate=0, group=0, coords_offset=end,
                    overflow_offset=end, mask_offset=end, work_words=end,
                    emit_blocks=0)
    sites = 1
    for k, s in zip(kernel, stride):
        sites *= -(-k // s)
    group = 32
    while group > 1 and group * capacity > 32 * words:
        group //= 2
    coords = rows + _round(capacity, 4)
    mask = coords + 4 * capacity + 4
    lanes = -(-words // group) * 32
    return dict(want, aggregate=int(V * sites > 4 * words), group=group,
                coords_offset=coords, overflow_offset=coords + 4 * capacity,
                mask_offset=mask,
                work_words=mask + _round(-(-capacity // 4), 4),
                emit_blocks=-(-max(lanes, capacity) // 256))


@pytest.mark.parametrize("site", list(K11_SITES))
def test_k11_plan_against_the_c_check(site):
    plan = _k11(site)
    want = _restated_k11(*K11_SITES[site])
    assert {k: getattr(plan, k) for k in want} == want
    assert set(want) | set(K11_SITES_FIELDS) == set(plan._fields)


@pytest.mark.parametrize("site", list(K11_SITES))
def test_k11_regions_are_contiguous_and_aligned(site):
    plan = _k11(site)
    cap = plan.capacity
    n_rows = cap if plan.mode else plan.rows_in
    regions = [(0, plan.words, plan.padded),
               (plan.state_offset, 2 * plan.tiles + 2,
                plan.base_offset - plan.state_offset),
               (plan.base_offset, plan.words, plan.padded),
               (plan.rows_offset, n_rows,
                plan.coords_offset - plan.rows_offset)]
    if plan.mode:
        regions += [(plan.coords_offset, 4 * cap, 4 * cap),
                    (plan.overflow_offset, 2, 4),
                    (plan.mask_offset, -(-cap // 4),
                     plan.work_words - plan.mask_offset)]
    _contiguous(regions, plan.work_words)
    assert all(start % 4 == 0 for start, _, _ in regions)
    assert 4 * (plan.base_offset - plan.state_offset) >= 8 * plan.tiles + 8
    assert 4 * plan.zero_vectors == plan.base_offset
    # the table and the outputs are views of the one workspace
    work = torch.zeros(plan.work_words, dtype=torch.int32)
    table, coords, mask, overflow = _table_views(work, plan)
    assert table.bits.data_ptr() == work.data_ptr()
    assert table.base.data_ptr() == work[plan.base_offset:].data_ptr()
    assert table.rows.data_ptr() == work[plan.rows_offset:].data_ptr()
    assert table.bits.shape == table.base.shape == (plan.words,)
    assert table.rows.shape == (n_rows,) and table.sentinel == n_rows
    if plan.mode:
        assert coords.shape == (cap, 4) and coords.dtype == torch.int32
        assert coords.data_ptr() == work[plan.coords_offset:].data_ptr()
        assert mask.shape == (cap,) and mask.dtype == torch.bool
        assert mask.data_ptr() == work[plan.mask_offset:].data_ptr()
        assert overflow.shape == () and overflow.dtype == torch.int64
        assert overflow.data_ptr() == work[plan.overflow_offset:].data_ptr()
    else:
        assert coords is None and mask is None and overflow is None


def test_plans_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError):
        voxelize_plan(100, 5, (2 ** 11, 2 ** 11, 2 ** 9), 300, 10)
    with pytest.raises(ValueError):
        voxelize_plan(100, 2, (16, 16, 4), 300, 10)
    shape = (9, 14, 13)
    with pytest.raises(ValueError):      # no capacity
        active_set_plan(100, 2, shape, 1, (3, 3, 3), (2, 2, 2), (1, 1, 1),
                        (5, 7, 7), 0)
    with pytest.raises(ValueError):      # 5 sites an axis may hold a cell
        active_set_plan(100, 2, shape, 1, (9, 3, 3), (2, 2, 2), (1, 1, 1),
                        (2, 7, 7), 50)
    with pytest.raises(ValueError):      # 2^31 words
        active_set_plan(100, 2 ** 10, (2 ** 10, 2 ** 10, 2 ** 10), 0,
                        (1, 1, 1), (1, 1, 1), (0, 0, 0),
                        (2 ** 10, 2 ** 10, 2 ** 10), 0)


def test_profiles_hold_the_launches_a_call():
    """chip_smoke's profiles hold K10 to 5 traced launches a call and K11
    to 4, one scan launch each, told apart by the kernel's number."""
    for kernel, stages, number in (("voxelize", 5, 10), ("active_set", 4, 11)):
        rows = chip_smoke.PROFILED_PER_CALL[kernel]
        assert sum(per for _, per in rows) == stages
        assert ((f"scan_tiles<{number},",), 1) in rows
        assert ((f"fill_words<{number}>",), 1) in rows
