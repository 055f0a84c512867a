"""The fused DCN forward's launch plan, and the launch counts that
``chip_smoke.py`` asserts on the card.

Both are plain Python and run here.  ``dcn_fwd_plan`` (ops/deform_conv.py) is
the plan the ``dcn_fwd`` wrapper hands to the kernel, and the kernel refuses a
plan whose shared memory disagrees with its own layout
(csrc/deform_conv.cu::fwd_layout).  It is checked on every DCN layer that the
port's ResNet builds for each of the 17 configs (built on the meta device) and
on the ragged shapes of the card tests.  The launch counts are derived in
``chip_smoke.py`` from its call-site tables; here they are held to the
counts per path: the fused forward replaced the im2col + matmul route, so
predict launches ``dcn_fwd`` once per DCN layer and no im2col, and a train
step launches ``dcn_fwd`` twice per layer (forward and checkpoint recompute)
and the im2col once (the backward's columns).  The backward kernels K3 and
K4 run once per call and add into their tables themselves, so a step
launches no row scatter-add K5.
"""

import glob
import os

import numpy as np
import pytest
import torch

import chip_smoke
from unibev_tpu.config.config import Config
from unibev_tpu_torch.models.backbones.resnet import DeformConv2d, ResNet
from unibev_tpu_torch.ops._build import MAX_SMEM_BYTES
from unibev_tpu_torch.ops.deform_conv import dcn_fwd_plan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs/unibev/**/*.py"),
                           recursive=True))
ITEMSIZES = {"bf16": 2, "f32": 4}


def _dcn_layers(path):
    """(Cin, Cout, stride) of each DCN layer of the config's camera
    backbone, as the port builds it."""
    bb = Config.fromfile(path).model["img_backbone"]
    with torch.device("meta"):
        net = ResNet(depth=bb["depth"], num_stages=bb["num_stages"],
                     stage_with_dcn=bb["stage_with_dcn"], dcn=bb.get("dcn"))
    return [(m.weight.shape[1], m.weight.shape[0], m.stride)
            for m in net.modules() if isinstance(m, DeformConv2d)]


def _check_plan(cin, cout, itemsize):
    plan = dcn_fwd_plan(cin, cout, 9, itemsize)
    # the square tile, or the wide one exactly where it covers Cout alone
    wide = 256 < cout <= 512
    assert (plan.rows, plan.bn) == ((64, 512) if wide else (128, 256))
    assert plan.warps == 16 and plan.rows * plan.bn == 64 * 32 * plan.warps
    assert plan.smem_bytes <= MAX_SMEM_BYTES
    assert plan.channel_tiles * plan.bn >= cout
    if cout <= 512:
        assert plan.channel_tiles == 1        # each column sampled once
    assert plan.chunks * plan.kc >= cin > (plan.chunks - 1) * plan.kc
    assert plan.kc * itemsize == 128           # one swizzled 128-byte row
    # a thread samples whole 16-byte vectors of an item's column tile
    assert plan.rows * plan.kc * itemsize // 16 % (32 * plan.warps) == 0
    return plan


def test_configs_count():
    assert len(CONFIGS) == 17


@pytest.mark.parametrize("path", CONFIGS,
                         ids=[os.path.basename(p) for p in CONFIGS])
def test_plan_fits_every_dcn_layer_of_the_configs(path):
    """ResNet-101 stages 3-4: 23 layers 256 -> 256 and 3 layers 512 -> 512,
    stride 1; in bf16 (the card's path) and f32 (its tests) each plan fits
    the H100's shared memory with one channel tile: 128 x 256 at stage 3,
    64 x 512 at stage 4."""
    layers = _dcn_layers(path)
    assert sorted(set(layers)) == [(256, 256, 1), (512, 512, 1)]
    assert [layers.count(s) for s in sorted(set(layers))] == [23, 3]
    for cin, cout, _ in set(layers):
        for itemsize in ITEMSIZES.values():
            plan = _check_plan(cin, cout, itemsize)
            assert plan.bn == cout and plan.channel_tiles == 1


# (Cin, Cout): the card tests' ragged widths, and a narrow Cin under the
# flagship's Cout
@pytest.mark.parametrize("cin,cout", [(40, 24), (5, 24), (40, 20), (5, 20),
                                      (64, 256), (40, 300), (64, 512)])
@pytest.mark.parametrize("dtype", list(ITEMSIZES))
def test_plan_of_ragged_shapes(cin, cout, dtype):
    plan = _check_plan(cin, cout, ITEMSIZES[dtype])
    assert plan.channel_tiles == 1 and plan.chunks == -(-cin // plan.kc)


def test_plan_of_the_flagship_stage3():
    """The numbers ``fwd_layout`` gives in bf16: at stage 3, 64 channels per
    stage, 1,024 bytes of alignment slack, three 49,152-byte stages, 64
    bytes of mbarriers and a flag, 23,040 bytes of geometry; at stage 4,
    two 73,728-byte stages and 11,520 bytes of geometry; Cout 520 takes
    three square tiles."""
    assert dcn_fwd_plan(256, 256, 9, 2) == (128, 256, 1, 16, 64, 4, 171584)
    assert dcn_fwd_plan(512, 512, 9, 2) == (64, 512, 1, 16, 64, 8, 160064)
    assert dcn_fwd_plan(64, 520, 9, 2)[:3] == (128, 256, 3)


# The kernel's schedule (csrc/deform_conv.cu, dcn_fwd_kernel and launch_fwd),
# restated: U = tiles x items units, G blocks, block b runs units [b U / G,
# (b + 1) U / G) tile-major; a shared tile's sums go to slot 2 b of block
# b's first segment or 2 b + 1 of its last, and the last block to arrive
# adds the slots of blocks owner(first unit) .. owner(last unit) of the
# tile.
MIN_ITEMS = 4


def _blocks(units, cap):
    return max(1, min(cap, units // MIN_ITEMS))


def _start(g, units, G):
    return g * units // G


def _owner(u, units, G):
    return ((u + 1) * G - 1) // units


def _segments(tiles, items, G):
    """(block, tile, first item, items, slot or None) of every segment."""
    units = tiles * items
    out = []
    for g in range(G):
        u, end = _start(g, units, G), _start(g + 1, units, G)
        begin = u
        while u < end:
            t, i0 = divmod(u, items)
            n = min(items - i0, end - u)
            slot = None if n == items else 2 * g + (0 if u == begin else 1)
            out.append((g, t, i0, n, slot))
            u += n
    return out


def _reader_slots(t, tiles, items, G):
    units = tiles * items
    lo, hi = _owner(t * items, units, G), _owner(t * items + items - 1, units, G)
    return [2 * g + (0 if _start(g, units, G) // items == t else 1)
            for g in range(lo, hi + 1)]


# (tiles, items per tile, the most blocks): flagship stage 3 (272 tiles, 4
# chunks x 9 taps, 132 SMs) and stage 4 (136 tiles of 64 pixels, 8 x 9),
# the card tests' shapes and a mma-fragment tile, odd counts
SCHEDULES = [(272, 36, 132), (136, 72, 132), (3, 9, 132), (2, 9, 132),
             (6, 18, 132), (1, 9, 132), (7, 5, 3), (5, 72, 66), (40, 36, 7)]


@pytest.mark.parametrize("tiles,items,cap", SCHEDULES,
                         ids=[f"{t}x{i}/{c}" for t, i, c in SCHEDULES])
def test_schedule_covers_each_item_once(tiles, items, cap):
    """Every (tile, item) runs exactly once; a block runs at least
    MIN_ITEMS items (where there are so many) and at most two segments of
    it share a tile with another block; the slots the last block adds are
    the slots the sharing blocks wrote, each once."""
    G = _blocks(tiles * items, cap)
    segs = _segments(tiles, items, G)
    seen = np.zeros((tiles, items), dtype=int)
    for g, t, i0, n, _ in segs:
        seen[t, i0:i0 + n] += 1
    assert (seen == 1).all()
    per_block = np.bincount([s[0] for s in segs], [s[3] for s in segs], G)
    assert per_block.min() >= min(MIN_ITEMS, tiles * items)
    written = {}
    for g, t, _, _, slot in segs:
        if slot is not None:
            assert slot // 2 == g
            written.setdefault(t, []).append(slot)
    assert all(len([s for s in segs if s[0] == g and s[4] is not None]) <= 2
               for g in range(G))
    for t in range(tiles):
        if t in written:
            assert _reader_slots(t, tiles, items, G) == sorted(written[t])
            assert len(set(written[t])) == len(written[t])


def test_schedule_is_one_wave_at_the_flagship_sites():
    """Stage 3 and stage 4 each run 132 blocks of 74-75 items (a grid of
    one block per tile would take three waves of 36-item blocks at stage 3
    and two of 72-item blocks at stage 4)."""
    for tiles, items, cap in ((272, 36, 132), (136, 72, 132)):
        G = _blocks(tiles * items, cap)
        sizes = {_start(g + 1, tiles * items, G) - _start(g, tiles * items, G)
                 for g in range(G)}
        assert G == cap and sizes == {74, 75}


# path: (the launches chip_smoke.py expects, the counts per path)
PATHS = {
    "LC predict": (chip_smoke.expected_predict_launches(),
                   dict(msda_fwd=18, dcn_fwd=26, sparse_nbr=8, sparse_conv=21)),
    "C predict": (chip_smoke.expected_predict_launches(lidar=False),
                  dict(msda_fwd=12, dcn_fwd=26)),
    "L predict": (chip_smoke.expected_predict_launches(camera=False),
                  dict(msda_fwd=12, sparse_nbr=8, sparse_conv=21)),
    "C train step": (chip_smoke.expected_train_launches(),
                     dict(msda_fwd=12, dcn_fwd=52, dcn_im2col=26, msda_bwd=12,
                          dcn_bwd=26)),
    "LC train step": (chip_smoke.expected_train_launches(lidar=True),
                      dict(msda_fwd=18, dcn_fwd=52, dcn_im2col=26, msda_bwd=18,
                           dcn_bwd=26, sparse_nbr=8, sparse_conv=41,
                           sparse_inv_nbr=4, sparse_conv_wgrad=21)),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_chip_smoke_launch_counts(path):
    expected, table = PATHS[path]
    assert expected == table
