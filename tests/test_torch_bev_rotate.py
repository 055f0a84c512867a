"""The rotation of BEV maps (``ops/bev_rotate.py``), torchvision's
``rotate`` (nearest, no expansion, zero fill) as BEVFormer aligns the
previous frame's map: exact where pixel centres map onto pixel centres, in
torchvision's sign convention (a positive angle turns the map
counter-clockwise as displayed, rows down and columns right), and equal to
the benchmark reference's step-by-step copy of torchvision's tensor path.
"""

from __future__ import annotations

import math

import pytest
import torch

from benchmark.reference.ops.rotate import rotate
from unibev_tpu_torch.ops.bev_rotate import rotate_bev, source_cells

H = W = 200
CENTER = (100, 100)


def _angles(*deg):
    return torch.tensor(deg, dtype=torch.float64)


def _maps(B=1, C=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(B, H, W, C, generator=g)


def test_zero_degrees_is_the_identity_exactly():
    x = _maps(2)
    assert torch.equal(rotate_bev(x, _angles(0.0, -0.0), CENTER), x)
    assert torch.equal(rotate_bev(x.bfloat16(), _angles(0.0, 0.0), CENTER),
                       x.bfloat16())


def test_ninety_degrees_about_the_centre_is_a_transpose_and_a_flip():
    """Pixel centres map to pixel centres: +90 degrees (counter-clockwise as
    displayed) takes out[i, j] = x[j, W - 1 - i], the transpose with its
    rows flipped; -90 the transpose with its columns flipped; 180 both
    flips."""
    x = _maps(1, 4)
    ccw = x[0].transpose(0, 1).flip(0)
    cw = x[0].transpose(0, 1).flip(1)
    half = x[0].flip(0).flip(1)
    got = rotate_bev(x.expand(3, H, W, 4), _angles(90.0, -90.0, 180.0),
                     CENTER)
    assert torch.equal(got[0], ccw)
    assert torch.equal(got[1], cw)
    assert torch.equal(got[2], half)


@pytest.mark.parametrize("deg", [30.0, -47.5, 123.25])
def test_a_point_off_the_centre_lands_where_the_convention_puts_it(deg):
    """One lit cell 60 cells right of and 20 above the centre: each output
    cell it lights has its centre, turned back by the angle, inside the lit
    cell, and the lit cell's centre turned forward (counter-clockwise as
    displayed: up is -y) lies in one of them."""
    r, c = 100 - 20, 100 + 60
    x = torch.zeros(1, H, W, 1)
    x[0, r, c, 0] = 1.0
    out = rotate_bev(x, _angles(deg), CENTER)[0, ..., 0]
    lit = out.nonzero().tolist()
    assert 1 <= len(lit) <= 4
    th = math.radians(deg)
    for i, j in lit:
        px, py = j + 0.5 - CENTER[0], i + 0.5 - CENTER[1]
        # the inverse rotation (clockwise as displayed)
        sx = px * math.cos(th) - py * math.sin(th)
        sy = px * math.sin(th) + py * math.cos(th)
        assert math.floor(sx + CENTER[0]) == c
        assert math.floor(sy + CENTER[1]) == r
    px, py = c + 0.5 - CENTER[0], r + 0.5 - CENTER[1]
    fx = px * math.cos(th) + py * math.sin(th)
    fy = -px * math.sin(th) + py * math.cos(th)
    near = (math.floor(fy + CENTER[1]), math.floor(fx + CENTER[0]))
    assert min(abs(i - near[0]) + abs(j - near[1]) for i, j in lit) <= 1


def test_cells_rotated_out_of_the_map_read_zero():
    x = torch.ones(1, H, W, 2)
    out = rotate_bev(x, _angles(45.0), CENTER)[0, ..., 0]
    src = source_cells(_angles(45.0), H, W, CENTER)[0].view(H, W)
    assert torch.equal(out == 0, src < 0)
    # the corners' sources lie outside; the centre's inside
    for i, j in ((0, 0), (0, W - 1), (H - 1, 0), (H - 1, W - 1)):
        assert out[i, j] == 0
    assert out[H // 2, W // 2] == 1
    # a map shifted off the centre of rotation loses a band too
    far = rotate_bev(x, _angles(10.0), (0, 0))[0, ..., 0]
    assert 0 < int((far == 0).sum()) < H * W


def test_keep_zeroes_the_maps_of_samples_without_history():
    x = _maps(2)
    out = rotate_bev(x, _angles(3.0, 3.0), CENTER,
                     keep=torch.tensor([True, False]))
    assert torch.equal(out[0], rotate_bev(x[:1], _angles(3.0), CENTER)[0])
    assert not out[1].any()


@pytest.mark.parametrize("deg", [3.0, -2.7, 17.123456, 89.99, 359.9, 1e-3])
def test_equals_torchvisions_tensor_path(deg):
    """The reference's copy of torchvision's steps (one float32 matrix
    product, grid_sample's nearest rounding) picks the same cells here."""
    x = _maps(1, 5, seed=1)
    want = rotate(x[0].permute(2, 0, 1), deg, CENTER).permute(1, 2, 0)
    assert torch.equal(rotate_bev(x, _angles(deg), CENTER)[0], want)
