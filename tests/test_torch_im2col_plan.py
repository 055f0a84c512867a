"""The launch plan of the DCN backward's column kernel ``dcn_im2col``, its
index mapping, and the plain columns against the JAX package's.

``im2col_plan`` (ops/deform_conv.py) is what the wrapper hands to the
kernel: the access width (16 bytes, or the scalar width where a row of Cin
is not a whole number of 16-byte vectors or x or cols is not 16-byte
aligned), the threads that share one (output pixel, tap), the output pixels
a block and the grid.  The C entry point refuses a plan that disagrees with
its own check (csrc/deform_conv.cu, ``unibev_dcn_im2col``).  The plan is
held on every DCN layer of the 17 configs (built on the meta device, at the
flagship's map sizes), at the widths that narrow or leave lanes idle, and
at unaligned addresses.  The kernel's mapping of threads to (pixel, tap,
vector) is restated and must write each once, in one contiguous stretch a
block.  ``deform_im2col_reference`` (one ``grid_sample`` per tap) is held
against JAX ``_mdcn_clean`` with an identity weight, which returns the
columns themselves: f32, 1e-4 of the largest absolute value.
"""

import glob
import os

import numpy as np
import pytest
import torch

import chip_smoke
import jax.numpy as jnp
from unibev_tpu.config.config import Config
from unibev_tpu.ops.deform_conv import _mdcn_clean
from unibev_tpu_torch.models.backbones.resnet import DeformConv2d, ResNet
from unibev_tpu_torch.ops._build import group_lanes
from unibev_tpu_torch.ops.deform_conv import (IM2COL_MAX_SMEM, IM2COL_THREADS,
                                              IM2COL_UNITS,
                                              deform_im2col_reference,
                                              im2col_plan)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs/unibev/**/*.py"),
                           recursive=True))
ITEMSIZES = {"bf16": 2, "f32": 4}
BATCH = 2     # kColBatch: vectors whose loads a thread issues at once


def _dcn_layers(path):
    """(Cin, Cout, stride) of each DCN layer of the config's camera
    backbone, as the port builds it."""
    bb = Config.fromfile(path).model["img_backbone"]
    with torch.device("meta"):
        net = ResNet(depth=bb["depth"], num_stages=bb["num_stages"],
                     stage_with_dcn=bb["stage_with_dcn"], dcn=bb.get("dcn"))
    return [(m.weight.shape[1], m.weight.shape[0], m.stride)
            for m in net.modules() if isinstance(m, DeformConv2d)]


# Cin -> (B, H, W) of the flagship site (chip_smoke.DCN_SITES)
SITE_MAPS = {s[5]: s[2:5] for s in chip_smoke.DCN_SITES}


def _plan(Cin, itemsize, B=6, H=58, W=100, stride=1, taps=9, x_address=0,
          cols_address=0):
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    return im2col_plan(B, H, W, Cin, Ho, Wo, taps, itemsize, x_address,
                       cols_address)


def _check_plan(plan, Cin, itemsize, taps, n_pix):
    chunks = Cin * itemsize // plan.vec_bytes
    assert plan.vec_bytes in (16, itemsize)
    assert chunks * plan.vec_bytes == Cin * itemsize
    assert plan.lanes == group_lanes(chunks) and plan.lanes <= 32
    assert plan.chunks_per_lane == -(-chunks // plan.lanes)
    assert plan.threads == IM2COL_THREADS and plan.threads % plan.lanes == 0
    assert plan.smem_bytes == plan.pixels * taps * 20 <= IM2COL_MAX_SMEM
    assert plan.blocks * plan.pixels >= n_pix > (plan.blocks - 1) * plan.pixels
    # about IM2COL_UNITS accesses a thread a tile, at most
    groups = plan.threads // plan.lanes
    units = -(-plan.pixels * taps // groups) * plan.chunks_per_lane
    assert units <= IM2COL_UNITS + plan.chunks_per_lane * 2


def test_configs_count():
    assert len(CONFIGS) == 17


@pytest.mark.parametrize("path", CONFIGS,
                         ids=[os.path.basename(p) for p in CONFIGS])
def test_plan_fits_every_dcn_layer_of_the_configs(path):
    """ResNet-101 stages 3-4 (256 and 512 channels, stride 1) at the
    flagship's maps: 16-byte accesses, a warp per (pixel, tap), 14 pixels a
    block at stage 3 (one vector a lane a tap) and 7 at stage 4 (two) in
    bf16; in f32 twice the vectors, half the pixels."""
    for cin, _, stride in _dcn_layers(path):
        B, H, W = SITE_MAPS[cin]
        for itemsize in ITEMSIZES.values():
            plan = _plan(cin, itemsize, B, H, W, stride)
            _check_plan(plan, cin, itemsize, 9, B * H * W)
            assert plan.vec_bytes == 16 and plan.lanes == 32
            per_lane = cin * itemsize // 16 // 32
            assert plan.chunks_per_lane == per_lane
            assert plan.pixels == 4096 // (32 * 9 * per_lane)


def test_plan_of_the_flagship_sites():
    """Stage 3 (6 x 58 x 100 pixels, Cin 256) and stage 4 (6 x 29 x 50,
    Cin 512) in bf16: 2,486 and 1,243 blocks, each with a ragged last
    tile."""
    assert _plan(256, 2) == (16, 32, 1, 14, 256, 2486, 2520)
    assert _plan(512, 2, 6, 29, 50) == (16, 32, 2, 7, 256, 1243, 1260)
    assert 34800 % 14 == 10 and 8700 % 7 == 6


# Cin: (vec_bytes, lanes, chunks_per_lane) in bf16 and in f32
WIDTHS = {
    5: ((2, 8, 1), (4, 8, 1)),        # scalar: 10 / 20 bytes a row
    6: ((2, 8, 1), (4, 8, 1)),        # scalar: 12 / 24 bytes
    8: ((16, 1, 1), (16, 2, 1)),      # one / two 16-byte vectors
    256: ((16, 32, 1), (16, 32, 2)),
    520: ((16, 32, 3), (16, 32, 5)),  # 65 / 130 vectors: uneven lanes
    512: ((16, 32, 2), (16, 32, 4)),
}


@pytest.mark.parametrize("cin", list(WIDTHS))
@pytest.mark.parametrize("dtype", list(ITEMSIZES))
def test_plan_widths(cin, dtype):
    itemsize = ITEMSIZES[dtype]
    plan = _plan(cin, itemsize, 2, 11, 13)
    _check_plan(plan, cin, itemsize, 9, 2 * 11 * 13)
    assert plan[:3] == WIDTHS[cin][list(ITEMSIZES).index(dtype)]
    assert plan.pixels == min(4096 // (plan.lanes * 9 * plan.chunks_per_lane),
                              128)


@pytest.mark.parametrize("off", [2, 8])
@pytest.mark.parametrize("which", ["x", "cols"])
def test_unaligned_addresses_take_the_scalar_width(off, which):
    """x or cols 2 or 8 bytes past a 16-byte boundary: one element an
    access, a warp of lanes over the row; 16 bytes past it: vectors."""
    base = 1 << 20
    for itemsize in (2, 4):
        if off % itemsize:
            continue
        addrs = dict(x_address=base, cols_address=base)
        addrs[which + "_address"] = base + off
        plan = _plan(256, itemsize, **addrs)
        _check_plan(plan, 256, itemsize, 9, 34800)
        assert plan.vec_bytes == itemsize and plan.lanes == 32
        assert plan.chunks_per_lane == 256 // 32
        addrs[which + "_address"] = base + 16
        assert _plan(256, itemsize, **addrs).vec_bytes == 16


def test_plan_of_other_tap_counts():
    """A 5 x 5 kernel and a 1 x 1: the geometry stays within 48 KB."""
    for taps in (25, 1):
        plan = _plan(64, 2, taps=taps)
        _check_plan(plan, 64, 2, taps, 34800)
    assert _plan(8, 2, taps=25).pixels == IM2COL_MAX_SMEM // (20 * 25)


def _block_units(items, nvec, lanes, threads=IM2COL_THREADS):
    """The (item, vector) units each thread of a block writes, in the order
    ``dcn_im2col_kernel`` writes them: kColBatch at a time, the thread's
    next unit advanced after each load (vector += lanes, and past the row's
    end the next item of its group)."""
    shift = lanes.bit_length() - 1
    groups = threads >> shift
    out = []
    for tid in range(threads):
        lane = tid & (lanes - 1)
        i = tid >> shift if lane < nvec else items
        v = lane
        units = []
        while i < items:
            batch = []
            for _ in range(BATCH):
                batch.append((i, v))
                if i >= items:
                    continue
                v += lanes
                if v >= nvec:
                    v = lane
                    i += groups
            units += [u for u in batch if u[0] < items]
        out.append(units)
    return out


# (name, n_pix, Cin, itemsize): the two flagship sites in both dtypes,
# and ragged widths and pixel counts
MAPPINGS = [("stage3", 34800, 256, 2), ("stage4", 8700, 512, 2),
            ("stage3_f32", 34800, 256, 4), ("stage4_f32", 8700, 512, 4),
            ("cin520", 90, 520, 2), ("cin5", 286, 5, 2), ("cin6_f32", 286, 6, 4),
            ("cin8", 77, 8, 2), ("one_pixel", 1, 40, 2)]


@pytest.mark.parametrize("name,n_pix,cin,itemsize", MAPPINGS,
                         ids=[m[0] for m in MAPPINGS])
def test_mapping_covers_each_vector_once(name, n_pix, cin, itemsize):
    """Blocks take consecutive tiles of ``pixels`` output pixels (the last
    ragged); within a tile every (pixel, tap, vector) is written once, so a
    block writes one contiguous stretch of cols; a thread writes at most
    ~16 vectors and every warp's stores in a batch step are contiguous
    (32 consecutive vectors) where the row is a warp's multiple."""
    taps = 9
    plan = im2col_plan(1, 1, 1, cin, 1, n_pix, taps, itemsize)
    nvec = cin * itemsize // plan.vec_bytes
    starts = [b * plan.pixels for b in range(plan.blocks)]
    rows = [min(plan.pixels, n_pix - s) for s in starts]
    assert sum(rows) == n_pix and min(rows) >= 1
    for r in sorted({rows[0], rows[-1]}):
        items = r * taps
        per_thread = _block_units(items, nvec, plan.lanes)
        seen = np.zeros((items, nvec), dtype=int)
        for units in per_thread:
            for i, v in units:
                seen[i, v] += 1
        assert (seen == 1).all()
        assert max(map(len, per_thread)) <= IM2COL_UNITS + 2 * plan.chunks_per_lane
        if nvec % 32 == 0:
            # the warps' j-th stores: 32 consecutive vectors of one item
            for w in range(IM2COL_THREADS // 32):
                lists = per_thread[32 * w:32 * w + 32]
                for j in range(min(map(len, lists))):
                    flat = [i * nvec + v for i, v in (t[j] for t in lists)]
                    assert flat == list(range(flat[0], flat[0] + 32))


def _jax_columns(x, offset, mask, stride, dilation):
    K, Cin = 9, x.shape[-1]
    eye = jnp.eye(K * Cin, dtype=jnp.float32)
    out = _mdcn_clean(jnp.asarray(x), jnp.asarray(offset), jnp.asarray(mask),
                      eye, (3, 3), stride, dilation, dilation)
    return np.asarray(out).reshape(-1, K * Cin)


@pytest.mark.parametrize("stride,dilation", [(1, 1), (2, 1), (1, 2)])
def test_plain_columns_match_jax(stride, dilation):
    """The plain im2col against JAX ``_mdcn_clean`` with a (K Cin) x (K
    Cin) identity weight (its columns), f32; offsets large enough to move
    taps off the map, and one tap with mask 0."""
    rng = np.random.RandomState(3)
    B, H, W, Cin = 2, 11, 13, 6
    Ho = (H + 2 * dilation - 2 * dilation - 1) // stride + 1
    Wo = (W + 2 * dilation - 2 * dilation - 1) // stride + 1
    x = rng.randn(B, H, W, Cin).astype(np.float32)
    offset = (rng.randn(B, Ho, Wo, 18) * 2.5).astype(np.float32)
    mask = rng.rand(B, Ho, Wo, 9).astype(np.float32)
    mask[0, 1, 2, 4] = 0
    assert (np.abs(offset) > 3).any()
    want = _jax_columns(x, offset, mask, stride, dilation)
    got = deform_im2col_reference(
        torch.from_numpy(x), torch.from_numpy(offset), torch.from_numpy(mask),
        stride=stride, padding=dilation, dilation=dilation).numpy()
    assert got.shape == want.shape == (B * Ho * Wo, 9 * Cin)
    tol = 1e-4 * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
