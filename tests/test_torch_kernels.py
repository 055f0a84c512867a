"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device (marker ``cuda``) and skips on a CPU-only
machine; the file imports no JAX, so it runs where only PyTorch is
installed::

    python -m pytest tests/test_torch_kernels.py -m cuda -q

Tolerances are relative to max |plain| (at least 1): f32 1e-4 for the
DCN columns and the fused DCN forward ``dcn_fwd``, 1e-5 for MSDA (the same terms summed in another
order, TF32 off); bf16 2^-6 (outputs rounded to bf16, relative 2^-8, with
margin).  The backwards (K3, K4, one launch a call) add d_value / d_x into
float32 tables with vector atomics in no fixed order: f32 1e-4, bf16 2^-6
(bf16 inputs, outputs rounded to bf16).  The scatter-add K5 is held alone at
1e-5, and exactly at the radar pillar scatter's shapes (each canvas row
takes at most one pillar; the masked pillars' index, one past the canvas,
is skipped).  d_loc and
d_offset jump across cell edges, where the kernels and grid_sample may round
a position to different sides: they are compared at points 1e-3 pixels or
more inside a cell (``cell_interior`` / ``tap_interior``).  The sparse-conv
rulebook K6 and the inverse rulebook K8 must equal their plain versions
exactly; the sparse conv K7 and the weight gradient K9 f32 1e-4, bf16 2^-6
(the same products summed in another order; K9's float32 atomics sum its
row spans in no fixed order).  The voxelizer K10 must give its plain
version's coords, mask, counts and caps exactly and its voxel means within
1e-6 (at most max_points float32 points, summed in another order by the
plain version's atomics on the card); the compact-table kernel K11 its
plain versions' bitmaps, counts, coords, masks and overflows exactly, and
the rank -> row map on the live ranks (the plain build_table orders its
padding rows with an unstable sort; no lookup reads past the live ranks).
The assignment kernel K12 must give its plain version's col4row exactly
(the same float32 arithmetic in the same order, ties to the lowest
column).  The frozen-BN pass K13 computes its plain version's float32
operations in the same order and rounds once: f32 1e-6, bf16 one rounding
(2^-8); its gradient (plain PyTorch from the output) against autograd
through the plain version, f32 1e-6.
"""

import numpy as np
import pytest
import torch

from torch_port_utils import cuda_device  # noqa: F401
from unibev_tpu_torch.core.bbox.lsa import (linear_sum_assignment,
                                            linear_sum_assignment_plain)
from unibev_tpu_torch.flagship import (PC_RANGE, RADAR_POINTS,
                                       RADAR_VOXEL_SIZE, VOXEL_SIZE,
                                       synthetic_batch)
from unibev_tpu_torch.models.backbones.resnet import FrozenBatchNorm
from unibev_tpu_torch.ops import _build, deform_conv
from unibev_tpu_torch.ops.deform_conv import (
    dcn_fwd, deform_im2col, deform_im2col_backward,
    deform_im2col_backward_reference, deform_im2col_reference,
    modulated_deform_conv2d, modulated_deform_conv2d_reference, tap_interior)
from unibev_tpu_torch.ops.frozen_bn import (frozen_bn_act,
                                            frozen_bn_act_reference)
from unibev_tpu_torch.ops.msda import (cell_interior, ms_deform_attn,
                                       ms_deform_attn_backward,
                                       ms_deform_attn_backward_reference,
                                       ms_deform_attn_reference,
                                       msda_bwd_plan, msda_fwd_route)
from unibev_tpu_torch.ops.scatter import (scatter_add_rows,
                                          scatter_add_rows_reference)
from unibev_tpu_torch.ops.sparse_conv import (
    SparseGrid, build_table, build_table_reference, downsample_with_table,
    downsample_with_table_reference, sparse_conv, sparse_conv_reference,
    sparse_conv_wgrad, sparse_conv_wgrad_reference, sparse_inv_nbr,
    sparse_inv_nbr_reference, sparse_nbr, sparse_nbr_reference, table_entries)
from unibev_tpu_torch.ops.voxelize import (voxelize_and_encode,
                                           voxelize_and_encode_reference)

BWD_REL = {torch.float32: 1e-4, torch.bfloat16: 2 ** -6}

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _close(got, want, rel):
    tol = rel * max(1.0, want.float().abs().max().item())
    assert (got.float() - want.float()).abs().max().item() <= tol


def _launched_since(before):
    """{kernel: launches} counted since the snapshot ``before``."""
    return {k: v - before.get(k, 0) for k, v in _build.launches.items()
            if v != before.get(k, 0)}


def _msda_inputs(device, dtype, levels, P, B=2, Q=300, heads=8, D=32, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    V = sum(h * w for h, w in levels)
    L = len(levels)
    value = torch.randn(B, V, heads, D, device=device, generator=g).to(dtype)
    loc = torch.rand(B, Q, heads, L, P, 2, device=device, generator=g) * 1.2 - 0.1
    attn = torch.softmax(torch.randn(B, Q, heads, L * P, device=device,
                                     generator=g), -1)
    return value, loc, attn.view(B, Q, heads, L, P).to(dtype)


def _dcn_inputs(device, dtype, B=2, H=11, W=13, Cin=40, Cout=24, stride=2,
                seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    x = torch.randn(B, H, W, Cin, device=device, generator=g).to(dtype)
    off = (torch.randn(B, Ho, Wo, 18, device=device, generator=g) * 2.5).to(dtype)
    mask = torch.rand(B, Ho, Wo, 9, device=device, generator=g).to(dtype)
    w = (torch.randn(9 * Cin, Cout, device=device, generator=g) * 0.05).to(dtype)
    return x, off, mask, w


# name: (levels, points, heads, D)
MSDA_CASES = {
    "sca": (((29, 50),), 8, 8, 32),
    "L2": (((29, 50), (7, 9)), 4, 8, 32),
    "bev": (((200, 200),), 4, 8, 32),
    "sca_d8": (((29, 50),), 8, 8, 8),
    # 8-byte rows in bf16: no 16-byte access
    "sca_d4": (((29, 50),), 8, 8, 4),
    "bev_d4": (((200, 200),), 4, 8, 4),
}


@pytest.mark.parametrize("case", list(MSDA_CASES))
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2 ** -6)],
                         ids=["f32", "bf16"])
def test_msda_kernel_matches_plain(cuda_device, case, dtype, rel):
    levels, P, heads, D = MSDA_CASES[case]
    value, loc, attn = _msda_inputs(cuda_device, dtype, levels, P, heads=heads,
                                    D=D)
    vec = msda_fwd_route(D, value.element_size(), value.data_ptr())
    assert vec == min(16, D * value.element_size())
    before = _build.launches["msda_fwd"]
    got = ms_deform_attn(value, levels, loc, attn)
    torch.cuda.synchronize()
    assert _build.launches["msda_fwd"] == before + 1
    assert got.dtype == dtype and got.shape == (2, 300, heads * D)
    _close(got, ms_deform_attn_reference(value, levels, loc, attn), rel)


@pytest.mark.parametrize("dtype,offset,vec", [
    (torch.bfloat16, 2, 2), (torch.bfloat16, 4, 4), (torch.bfloat16, 8, 8),
    (torch.float32, 4, 4), (torch.float32, 8, 8)])
def test_msda_kernel_takes_unaligned_value(cuda_device, dtype, offset, vec):
    """A contiguous value that starts ``offset`` bytes past a 16-byte
    boundary (a view into a larger buffer) takes the narrower accesses of
    the same kernel."""
    levels = ((29, 50),)
    value, loc, attn = _msda_inputs(cuda_device, dtype, levels, 8)
    skip = offset // value.element_size()
    buf = torch.empty(value.numel() + skip, dtype=dtype, device=cuda_device)
    view = buf[skip:].view(value.shape)
    view.copy_(value)
    assert view.is_contiguous() and view.data_ptr() % 16 == offset
    assert msda_fwd_route(32, view.element_size(), view.data_ptr()) == vec
    got = ms_deform_attn(view, levels, loc, attn)
    torch.cuda.synchronize()
    rel = 1e-5 if dtype is torch.float32 else 2 ** -6
    _close(got, ms_deform_attn_reference(value, levels, loc, attn), rel)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2 ** -6)],
                         ids=["f32", "bf16"])
def test_dcn_kernel_matches_plain(cuda_device, stride, dtype, rel):
    """The im2col kernel (the backward's columns) and the fused forward
    behind ``modulated_deform_conv2d``, one launch each."""
    x, off, mask, w = _dcn_inputs(cuda_device, dtype, stride=stride)
    before = dict(_build.launches)
    cols = deform_im2col(x, off, mask, stride=stride)
    out = modulated_deform_conv2d(x, off, mask, w, stride=stride)
    torch.cuda.synchronize()
    assert _build.launches["dcn_im2col"] == before.get("dcn_im2col", 0) + 1
    assert _build.launches["dcn_fwd"] == before.get("dcn_fwd", 0) + 1
    _close(cols, deform_im2col_reference(x, off, mask, stride=stride), rel)
    _close(out, modulated_deform_conv2d_reference(x, off, mask, w, stride=stride),
           rel)


# name: (B, H, W, Cin, Cout, stride, dilation): ragged pixel counts (not a
# multiple of the 64-pixel tile), Cin 5 (plain loads of x), Cout 20 (plain
# weight loads and output stores), and the flagship's two sites at B = 1
DCN_FWD_CASES = {
    "s1": (2, 11, 13, 40, 24, 1, 1),
    "s2": (2, 11, 13, 40, 24, 2, 1),
    "dil2": (2, 11, 13, 40, 24, 1, 2),
    "cin5": (2, 11, 13, 5, 24, 1, 1),
    "cout20": (2, 11, 13, 40, 20, 1, 1),
    "cin5_cout20_s2": (2, 11, 13, 5, 20, 2, 1),
    "stage3": (1, 58, 100, 256, 256, 1, 1),
    "stage4": (1, 29, 50, 512, 512, 1, 1),
    "cout300": (2, 11, 13, 40, 300, 1, 1),
    "cout520": (1, 9, 10, 64, 520, 1, 1),
}


@pytest.mark.parametrize("case", list(DCN_FWD_CASES))
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2 ** -6)],
                         ids=["f32", "bf16"])
def test_dcn_fwd_kernel_matches_plain(cuda_device, case, dtype, rel):
    """``dcn_fwd`` against the plain forward; some taps land wholly outside
    the map (large offsets) and one offset is NaN, which samples nothing."""
    B, H, W, Cin, Cout, stride, dil = DCN_FWD_CASES[case]
    g = torch.Generator(device=cuda_device).manual_seed(5)
    Ho = (H + 2 * dil - 2 * dil - 1) // stride + 1
    Wo = (W + 2 * dil - 2 * dil - 1) // stride + 1
    x = torch.randn(B, H, W, Cin, device=cuda_device, generator=g).to(dtype)
    off = (torch.randn(B, Ho, Wo, 18, device=cuda_device, generator=g)
           * 2.5).to(dtype)
    off[0, 0, 1, 6:10] = 1000.0               # taps 3 and 4: off the map
    off[-1, -1, -1, 0:2] = -1000.0
    mask = torch.rand(B, Ho, Wo, 9, device=cuda_device, generator=g).to(dtype)
    w = (torch.randn(9 * Cin, Cout, device=cuda_device, generator=g)
         * (9 * Cin) ** -0.5).to(dtype)
    off[0, 1, 1, 4] = float("nan")            # tap 2 samples nothing
    kw = dict(stride=stride, padding=dil, dilation=dil)
    before = _build.launches["dcn_fwd"]
    got = dcn_fwd(x, off, mask, w, **kw)
    torch.cuda.synchronize()
    assert _build.launches["dcn_fwd"] == before + 1
    assert got.dtype == dtype and got.shape == (B, Ho, Wo, Cout)
    off[0, 1, 1, 4] = 1000.0                  # as far out: the plain version's
    _close(got, modulated_deform_conv2d_reference(x, off, mask, w, **kw), rel)


@pytest.mark.parametrize("case", ["stage3", "stage4", "cout300"])
def test_dcn_fwd_is_deterministic(cuda_device, case):
    """Blocks that share a tile add their sums in a fixed order: two calls
    give the same bits, and the arrival counts left behind are zeros."""
    B, H, W, Cin, Cout, _, _ = DCN_FWD_CASES[case]
    g = torch.Generator(device=cuda_device).manual_seed(7)
    x = torch.randn(B, H, W, Cin, device=cuda_device, generator=g).bfloat16()
    off = (torch.randn(B, H, W, 18, device=cuda_device, generator=g)
           * 2).bfloat16()
    mask = torch.rand(B, H, W, 9, device=cuda_device, generator=g).bfloat16()
    w = (torch.randn(9 * Cin, Cout, device=cuda_device, generator=g)
         * (9 * Cin) ** -0.5).bfloat16()
    first = dcn_fwd(x, off, mask, w)
    assert torch.equal(dcn_fwd(x, off, mask, w), first)
    assert not deform_conv._ARRIVALS[x.device].any()


@pytest.mark.parametrize("Cout", [256, 512])
def test_dcn_fwd_mma_fragments(cuda_device, Cout):
    """``dcn_fwd``'s bf16 wgmma tiles on exact products: offsets 0 and
    a mask on the centre tap alone make the columns x itself.  Identity
    weights pass x through, a permutation of the columns moves each channel
    to its own output, one-hot pixels pass the weight rows through; 144
    pixels, Cout 256 (the square tile) and 512 (the wide one).  A wrong
    swizzle, descriptor or accumulator layout misplaces values."""
    g = torch.Generator(device=cuda_device).manual_seed(6)
    B, H, W, C = 1, 12, 12, 64
    x = torch.randn(B, H, W, C, device=cuda_device, generator=g).bfloat16()
    off = torch.zeros(B, H, W, 18, device=cuda_device, dtype=torch.bfloat16)
    mask = torch.zeros(B, H, W, 9, device=cuda_device, dtype=torch.bfloat16)
    mask[..., 4] = 1
    perm = torch.randperm(Cout, generator=torch.Generator().manual_seed(0))
    perm = perm[:C].to(cuda_device)
    w = torch.zeros(9 * C, Cout, device=cuda_device, dtype=torch.bfloat16)
    w[4 * C + torch.arange(C, device=cuda_device), perm] = 1
    want = torch.zeros(B, H, W, Cout, device=cuda_device, dtype=torch.bfloat16)
    want[..., perm] = x
    assert torch.equal(dcn_fwd(x, off, mask, w), want)
    w = torch.randn(9 * C, Cout, device=cuda_device, generator=g).bfloat16()
    hot = torch.arange(H * W, device=cuda_device) % C
    onehot = torch.nn.functional.one_hot(hot, C).bfloat16().view(B, H, W, C)
    assert torch.equal(dcn_fwd(onehot, off, mask, w),
                       w[4 * C + hot].view(B, H, W, Cout))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_scatter_kernel_matches_plain(cuda_device, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    M, L, tr = 5000, 96, 700
    idx = torch.randint(0, tr, (M,), device=cuda_device, generator=g,
                        dtype=torch.int32)
    contrib = torch.randn(M, L, device=cuda_device, generator=g).to(dtype)
    contrib[::7] = 0
    before = _build.launches["scatter_add_rows"]
    got = scatter_add_rows(idx, contrib, tr)
    got = scatter_add_rows(idx, contrib, tr, out=got)
    torch.cuda.synchronize()
    assert _build.launches["scatter_add_rows"] == before + 2
    want = scatter_add_rows_reference(idx, contrib, tr)
    _close(got, 2 * want, 1e-5)


def _radar_site(device, dtype, live=2048, rows=40000, cells=32400, C=64):
    """K5's inputs at the full-width RC model's pillar scatter: ``rows``
    pillar rows of C channels, ``live`` of them at distinct canvas cells,
    the rest masked (index ``cells``, past the canvas)."""
    g = torch.Generator(device=device).manual_seed(0)
    idx = torch.full((rows,), cells, dtype=torch.int32, device=device)
    idx[:live] = torch.randperm(cells, generator=g, device=device)[:live].int()
    contrib = torch.randn(rows, C, device=device, generator=g).to(dtype)
    contrib[live:] = 0          # the PFN zeroes masked pillars
    return idx, contrib, cells


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_scatter_kernel_at_the_radar_site_is_exact(cuda_device, dtype):
    idx, contrib, cells = _radar_site(cuda_device, dtype)
    before = _build.launches["scatter_add_rows"]
    got = scatter_add_rows(idx, contrib, cells)
    torch.cuda.synchronize()
    assert _build.launches["scatter_add_rows"] == before + 1
    assert torch.equal(got, scatter_add_rows_reference(idx, contrib, cells))
    # masked rows with data are skipped, not added to any row
    contrib[2048:] = 1.0
    assert torch.equal(scatter_add_rows(idx, contrib, cells),
                       scatter_add_rows_reference(idx, contrib, cells))


def test_pillar_scatter_on_the_card_matches_the_cpu(cuda_device):
    """PointPillarsScatter: one K5 launch forward, a gather backward (no
    kernel), both exact against the CPU's plain version."""
    from unibev_tpu_torch.models.radar import PointPillarsScatter
    g = torch.Generator().manual_seed(1)
    B, H, W, C, V = 2, 12, 20, 16, 150
    cells = torch.stack([torch.randperm(H * W, generator=g)[:V]
                         for _ in range(B)]).view(-1)
    coords = torch.stack([torch.arange(B).repeat_interleave(V),
                          torch.zeros(B * V, dtype=torch.long),
                          cells // W, cells % W], 1).int()
    mask = torch.rand(B * V, generator=g) > 0.3
    coords[~mask] = -1
    feats = torch.randn(B * V, C, generator=g)
    cot = torch.randn(B, C, H, W, generator=g)
    scatter = PointPillarsScatter(C, (H, W))
    outs = []
    for dev in ("cpu", cuda_device):
        x = feats.detach().to(dev).requires_grad_()
        before = dict(_build.launches)
        y = scatter(x, coords.to(dev), mask.to(dev), B)
        (y * cot.to(dev)).sum().backward()
        torch.cuda.synchronize()
        grew = {k: v - before.get(k, 0) for k, v in _build.launches.items()
                if v != before.get(k, 0)}
        assert grew == ({} if dev == "cpu" else {"scatter_add_rows": 1})
        outs.append((y.detach().cpu(), x.grad.cpu()))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


@pytest.mark.parametrize("levels,P", [(((29, 50),), 8), (((29, 50), (7, 9)), 4),
                                      (((200, 200),), 4)], ids=["sca", "L2", "bev"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_msda_backward_kernel_matches_plain(cuda_device, levels, P, dtype):
    value, loc, attn = _msda_inputs(cuda_device, dtype, levels, P)
    loc[0, 0, 0, 0, 0] = float("nan")          # samples nothing, gets no grad
    g = torch.randn(2, 300, 8 * 32, device=cuda_device).to(dtype)
    before = dict(_build.launches)
    got = ms_deform_attn_backward(value, levels, loc, attn, g)
    torch.cuda.synchronize()
    assert _launched_since(before) == {"msda_bwd": 1}     # one launch a call
    assert got[1][0, 0, 0, 0, 0].abs().sum() == 0 and got[2][0, 0, 0, 0, 0] == 0
    loc[0, 0, 0, 0, 0] = 5.0                   # as far out: the plain version's
    want = ms_deform_attn_backward_reference(value, levels, loc, attn, g)
    interior = cell_interior(loc, levels)
    masks = (1, interior, 1)
    for a, b, m, dt in zip(got, want, masks, (dtype, torch.float32, dtype)):
        assert a.dtype == dt and a.shape == b.shape
        _close(a * m, b * m, BWD_REL[dtype])


# the cat_128 config's MSDA sites at its encoders' head width, D = 16
# (8 heads x 16 channels): name: (levels, points)
D16_SITES = {"tsa": (((200, 200),), 4), "camera_sca": (((29, 50),), 8),
             "pts_sca": (((180, 180),), 8)}


@pytest.mark.parametrize("site", list(D16_SITES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_msda_kernels_at_head_width_16(cuda_device, site, dtype):
    """K1 and K3 at D = 16: 32-byte head rows in bf16, 64-byte in f32, both
    read 16 bytes at a time by K1; K3 gives each item 2 lanes of 2 chunks."""
    levels, P = D16_SITES[site]
    value, loc, attn = _msda_inputs(cuda_device, dtype, levels, P, D=16)
    size = value.element_size()
    assert msda_fwd_route(16, size, value.data_ptr()) == 16
    before = dict(_build.launches)
    got = ms_deform_attn(value, levels, loc, attn)
    torch.cuda.synchronize()
    assert _launched_since(before) == {"msda_fwd": 1}
    assert got.shape == (2, 300, 8 * 16)
    _close(got, ms_deform_attn_reference(value, levels, loc, attn),
           1e-5 if dtype is torch.float32 else 2 ** -6)

    g = torch.randn(2, 300, 8 * 16, device=cuda_device).to(dtype)
    plan = msda_bwd_plan(2, value.shape[1], 300, 8, 16, size, value.data_ptr(),
                         g.data_ptr())
    assert (plan.vec_bytes, plan.lanes, plan.chunks_per_lane) == (
        4 * size, 2, 2)
    before = dict(_build.launches)
    got = ms_deform_attn_backward(value, levels, loc, attn, g)
    torch.cuda.synchronize()
    assert _launched_since(before) == {"msda_bwd": 1}
    want = ms_deform_attn_backward_reference(value, levels, loc, attn, g)
    masks = (1, cell_interior(loc, levels), 1)
    for a, b, m in zip(got, want, masks):
        assert a.shape == b.shape
        _close(a * m, b * m, BWD_REL[dtype])


@pytest.mark.parametrize("dtype,offset,vec", [
    (torch.bfloat16, 2, 2), (torch.bfloat16, 4, 4), (torch.bfloat16, 8, 8),
    (torch.float32, 4, 4), (torch.float32, 8, 8)])
def test_msda_kernels_at_head_width_16_take_unaligned_value(cuda_device, dtype,
                                                            offset, vec):
    """A D = 16 value ``offset`` bytes past a 16-byte boundary: K1 and K3
    take the narrower accesses (K3 at most 4 channels a chunk)."""
    levels = ((29, 50),)
    value, loc, attn = _msda_inputs(cuda_device, dtype, levels, 8, D=16)
    skip = offset // value.element_size()
    buf = torch.empty(value.numel() + skip, dtype=dtype, device=cuda_device)
    view = buf[skip:].view(value.shape)
    view.copy_(value)
    assert view.is_contiguous() and view.data_ptr() % 16 == offset
    assert msda_fwd_route(16, view.element_size(), view.data_ptr()) == vec
    rel = 1e-5 if dtype is torch.float32 else 2 ** -6
    got = ms_deform_attn(view, levels, loc, attn)
    torch.cuda.synchronize()
    _close(got, ms_deform_attn_reference(value, levels, loc, attn), rel)
    g = torch.randn(2, 300, 8 * 16, device=cuda_device).to(dtype)
    plan = msda_bwd_plan(2, value.shape[1], 300, 8, 16, view.element_size(),
                         view.data_ptr(), g.data_ptr())
    assert plan.vec_bytes == min(vec, 4 * view.element_size())
    got = ms_deform_attn_backward(view, levels, loc, attn, g)
    want = ms_deform_attn_backward_reference(value, levels, loc, attn, g)
    masks = (1, cell_interior(loc, levels), 1)
    for a, b, m in zip(got, want, masks):
        _close(a * m, b * m, BWD_REL[dtype])


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_dcn_backward_kernel_matches_plain(cuda_device, stride, dtype):
    x, off, mask, _ = _dcn_inputs(cuda_device, dtype, stride=stride)
    d_cols = torch.randn(deform_im2col_reference(x, off, mask, stride=stride).shape,
                         device=cuda_device).to(dtype)
    before = dict(_build.launches)
    got = deform_im2col_backward(x, off, mask, d_cols, stride=stride)
    torch.cuda.synchronize()
    assert _launched_since(before) == {"dcn_bwd": 1}      # one launch a call
    want = deform_im2col_backward_reference(x, off, mask, d_cols, stride=stride)
    masks = (1, tap_interior(off, stride=stride), 1)
    for a, b, m in zip(got, want, masks):
        assert a.dtype == dtype and a.shape == b.shape
        _close(a * m, b * m, BWD_REL[dtype])


def _backward_case(op, device, dtype):
    """(kernel call, plain call, the input's leading batch) of one backward
    op on small inputs: MSDA on a 29 x 50 map (K3) or a stride-1 DCN (K4)."""
    if op == "msda":
        levels = ((29, 50),)
        value, loc, attn = _msda_inputs(device, dtype, levels, 8)
        g = torch.randn(2, 300, 8 * 32, device=device).to(dtype)
        return ((value, loc, attn, g),
                lambda v, l, a, gr: ms_deform_attn_backward(v, levels, l, a, gr),
                lambda v, l, a, gr: ms_deform_attn_backward_reference(
                    v, levels, l, a, gr),
                lambda l: cell_interior(l, levels))
    x, off, mask, _ = _dcn_inputs(device, dtype, stride=1)
    d_cols = torch.randn(2 * 11 * 13, 9 * 40, device=device).to(dtype)
    return ((x, off, mask, d_cols), deform_im2col_backward,
            deform_im2col_backward_reference, tap_interior)


@pytest.mark.parametrize("op", ["msda", "dcn"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_backward_of_points_wholly_outside_the_map(cuda_device, op, dtype):
    """Every point (tap) of batch element 1 lies far outside the map: its
    d_value (d_x) rows stay exactly zero, its d_loc (d_offset) and d_attn
    (d_mask) are zero and finite; element 0 matches the plain version."""
    inputs, kernel, plain, interior = _backward_case(op, cuda_device, dtype)
    where = inputs[1]
    where[1] = 7.0 if op == "msda" else 500.0   # loc or offset, element 1
    got = kernel(*inputs)
    torch.cuda.synchronize()
    want = plain(*inputs)
    masks = (1, interior(where), 1)
    for a, b, m in zip(got, want, masks):
        assert torch.isfinite(a).all()
        assert (a[1] == 0).all()
        _close(a * m, b * m, BWD_REL[dtype])


@pytest.mark.parametrize("op", ["msda", "dcn"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_backward_of_a_zero_grad(cuda_device, op, dtype):
    """A zero grad_out (d_cols) adds nothing: the table, and so d_value
    (d_x), and the other two gradients are all zeros."""
    inputs, kernel, _, _ = _backward_case(op, cuda_device, dtype)
    inputs = (*inputs[:3], torch.zeros_like(inputs[3]))
    for a, t in zip(kernel(*inputs), inputs):
        assert a.shape == t.shape and (a == 0).all()


def test_autograd_goes_through_the_kernels(cuda_device):
    """Gradients of the ops on CUDA tensors (K1/K3, and dcn_fwd with the
    im2col/K4 backward) against autograd through the plain versions, f32;
    no row scatter-add K5."""
    value, loc, attn = _msda_inputs(cuda_device, torch.float32, ((29, 50),), 8)
    x, off, mask, w = _dcn_inputs(cuda_device, torch.float32, stride=1)
    cases = [(ms_deform_attn, ms_deform_attn_reference, (value, loc, attn),
              lambda f, a: f(a[0], ((29, 50),), a[1], a[2])),
             (modulated_deform_conv2d, modulated_deform_conv2d_reference,
              (x, off, mask, w), lambda f, a: f(*a))]
    before = dict(_build.launches)
    for kernel_fn, plain_fn, inputs, call in cases:
        grads = []
        for fn in (kernel_fn, plain_fn):
            leaves = [t.detach().clone().requires_grad_() for t in inputs]
            out = call(fn, leaves)
            g = torch.ones_like(out).mul_(torch.arange(
                out.shape[-1], device=out.device) % 3 - 1)
            grads.append(torch.autograd.grad(out, leaves, g))
        masks = [1] * len(inputs)
        masks[1] = (cell_interior(loc, ((29, 50),)) if kernel_fn is ms_deform_attn
                    else tap_interior(off))
        for a, b, m in zip(*grads, masks):
            _close(a * m, b * m, 1e-4)
    torch.cuda.synchronize()
    after = dict(_build.launches)
    for k in ("msda_fwd", "msda_bwd", "dcn_fwd", "dcn_im2col", "dcn_bwd"):
        assert after.get(k, 0) > before.get(k, 0), k
    assert after.get("scatter_add_rows", 0) == before.get("scatter_add_rows", 0)


@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2 ** -6)],
                         ids=["f32", "bf16"])
def test_dcn_autograd_launches_fwd_then_im2col(cuda_device, dtype, rel):
    """``modulated_deform_conv2d`` on CUDA: one ``dcn_fwd`` launch in the
    forward and no im2col; one ``dcn_im2col`` launch in the backward, which
    rebuilds the columns for d_weight.  d_x, d_offset (on interior taps),
    d_mask and d_weight against autograd through the plain version in
    float32 on the same values."""
    x, off, mask, w = _dcn_inputs(cuda_device, dtype, stride=1)
    leaves = [t.detach().clone().requires_grad_() for t in (x, off, mask, w)]
    g = torch.randn(2, 11, 13, 24, device=cuda_device).to(dtype)
    before = dict(_build.launches)
    out = modulated_deform_conv2d(*leaves)
    torch.cuda.synchronize()
    mid = dict(_build.launches)
    assert mid.get("dcn_fwd", 0) == before.get("dcn_fwd", 0) + 1
    assert mid.get("dcn_im2col", 0) == before.get("dcn_im2col", 0)
    got = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    after = dict(_build.launches)
    assert after.get("dcn_im2col", 0) == mid.get("dcn_im2col", 0) + 1
    assert after.get("dcn_fwd", 0) == mid.get("dcn_fwd", 0)
    assert after.get("dcn_bwd", 0) == mid.get("dcn_bwd", 0) + 1
    plain = [t.detach().float().requires_grad_() for t in (x, off, mask, w)]
    want = torch.autograd.grad(modulated_deform_conv2d_reference(*plain), plain,
                               g.float())
    masks = (1, tap_interior(off), 1, 1)
    for a, b, m in zip(got, want, masks):
        assert a.dtype == dtype and a.shape == b.shape
        _close(a * m, b * m, rel)


# name: (B, H, W, Cin, stride, dilation, dtype, bytes x starts past a
# 16-byte boundary): 16-byte vectors with idle lanes (Cin 40 bf16: 5 a row),
# uneven lanes (Cin 520: 65 vectors over 32), the scalar width for a row
# that is not whole vectors (Cin 5, Cin 6 f32) or an unaligned x, and the
# flagship stage 3 at B = 1
IM2COL_CASES = {
    "cin40": (2, 11, 13, 40, 1, 1, torch.bfloat16, 0),
    "cin40_s2": (2, 11, 13, 40, 2, 1, torch.bfloat16, 0),
    "cin40_dil2": (2, 11, 13, 40, 1, 2, torch.bfloat16, 0),
    "cin520": (1, 9, 10, 520, 1, 1, torch.bfloat16, 0),
    "cin5": (2, 11, 13, 5, 1, 1, torch.bfloat16, 0),
    "cin40_x_off2": (2, 11, 13, 40, 1, 1, torch.bfloat16, 2),
    "stage3": (1, 58, 100, 256, 1, 1, torch.bfloat16, 0),
    "cin40_f32": (2, 11, 13, 40, 1, 1, torch.float32, 0),
    "cin6_f32": (2, 11, 13, 6, 2, 1, torch.float32, 0),
    "cin40_f32_x_off8": (2, 11, 13, 40, 1, 1, torch.float32, 8),
    "stage4_f32": (1, 29, 50, 512, 1, 1, torch.float32, 0),
}


def _im2col_case(device, case, seed=11):
    """x (possibly a view past a 16-byte boundary), offsets with taps off
    the map and a NaN, a mask with zeros, and the keyword arguments."""
    B, H, W, Cin, stride, dil, dtype, off_bytes = IM2COL_CASES[case]
    g = torch.Generator(device=device).manual_seed(seed)
    Ho = (H - 1) // stride + 1
    Wo = (W - 1) // stride + 1
    x = torch.randn(B, H, W, Cin, device=device, generator=g).to(dtype)
    if off_bytes:
        skip = off_bytes // x.element_size()
        buf = torch.empty(x.numel() + skip, dtype=dtype, device=device)
        view = buf[skip:].view(x.shape)
        view.copy_(x)
        assert view.data_ptr() % 16 == off_bytes
        x = view
    off = (torch.randn(B, Ho, Wo, 18, device=device, generator=g)
           * 2.5).to(dtype)
    off[0, 0, 1, 6:10] = 1000.0                # taps 3 and 4: off the map
    off[-1, -1, -1, 0:2] = -1.5                # corners half outside
    mask = torch.rand(B, Ho, Wo, 9, device=device, generator=g).to(dtype)
    mask[0, 1] = 0                             # a row of pixels reads nothing
    mask[..., 5] = 0                           # and tap 5 nowhere
    return x, off, mask, dict(stride=stride, padding=dil, dilation=dil)


@pytest.mark.parametrize("case", list(IM2COL_CASES))
def test_im2col_kernel_matches_plain(cuda_device, case):
    """``dcn_im2col`` against the plain columns, one launch a call, with
    the plan's width; a NaN offset samples nothing (zeros)."""
    x, off, mask, kw = _im2col_case(cuda_device, case)
    off[0, 2, 1, 4] = float("nan")             # tap 2 of one pixel
    plan = deform_conv.im2col_plan(
        x.shape[0], x.shape[1], x.shape[2], x.shape[3], off.shape[1],
        off.shape[2], 9, x.element_size(), x.data_ptr(), 0)
    unaligned = x.data_ptr() % 16 or x.shape[3] * x.element_size() % 16
    assert plan.vec_bytes == (x.element_size() if unaligned else 16)
    before = dict(_build.launches)
    got = deform_im2col(x, off, mask, **kw)
    torch.cuda.synchronize()
    assert _launched_since(before) == {"dcn_im2col": 1}
    assert got.dtype == x.dtype and got.shape == (off[..., 0].numel(),
                                                  9 * x.shape[3])
    cols = got.view(*off.shape[:3], 9, -1)
    assert (cols[0, 2, 1, 2] == 0).all() and (cols[0, 1] == 0).all()
    assert (cols[..., 5, :] == 0).all()
    off[0, 2, 1, 4] = 1000.0                   # as far out: the plain version's
    rel = 1e-4 if x.dtype is torch.float32 else 2 ** -6
    _close(got, deform_im2col_reference(x, off, mask, **kw), rel)


@pytest.mark.parametrize("case", ["cin40", "cin40_s2", "cin40_dil2", "cin5",
                                  "stage3"])
def test_im2col_integer_offsets_are_exact(cuda_device, case):
    """Whole-pixel offsets and mask 1: every column is a value of x (or 0
    off the map), bit for bit in bf16."""
    x, off, _, kw = _im2col_case(cuda_device, case)
    B, H, W, Cin = x.shape
    g = torch.Generator(device=cuda_device).manual_seed(2)
    off = torch.randint(-3, 4, off.shape, device=cuda_device,
                        generator=g).to(x.dtype)
    mask = torch.ones(*off.shape[:3], 9, device=cuda_device, dtype=x.dtype)
    got = deform_im2col(x, off, mask, **kw).view(*off.shape[:3], 9, Cin)
    s, d = kw["stride"], kw["dilation"]
    Ho, Wo = off.shape[1:3]
    k = torch.arange(9, device=cuda_device)
    sy = (torch.arange(Ho, device=cuda_device)[:, None, None] * s - d
          + (k // 3) * d + off[..., 0::2].long())        # (B, Ho, Wo, 9)
    sx = (torch.arange(Wo, device=cuda_device)[None, :, None] * s - d
          + (k % 3) * d + off[..., 1::2].long())
    inside = (sy >= 0) & (sy < H) & (sx >= 0) & (sx < W)
    b = torch.arange(B, device=cuda_device)[:, None, None, None]
    want = x[b, sy.clamp(0, H - 1), sx.clamp(0, W - 1)] * inside[..., None]
    assert torch.equal(got, want.to(x.dtype))


@pytest.mark.parametrize("case", ["cin40", "cin40_s2", "cin40_dil2", "cin5",
                                  "stage4_f32"])
def test_dcn_fwd_and_im2col_sample_the_same_columns(cuda_device, case):
    """In f32, ``dcn_fwd(x, off, mask, W)`` equals ``im2col @ W`` to 1e-5:
    the two kernels sample the same columns (tap_geometry, the same
    blend)."""
    x, off, mask, kw = _im2col_case(cuda_device, case)
    x, off, mask = x.float(), off.float(), mask.float()
    Cin = x.shape[3]
    g = torch.Generator(device=cuda_device).manual_seed(4)
    w = torch.randn(9 * Cin, 24, device=cuda_device, generator=g) * (9 * Cin) ** -0.5
    want = torch.matmul(deform_im2col(x, off, mask, **kw), w)
    got = dcn_fwd(x, off, mask, w, **kw)
    _close(got.reshape(want.shape), want, 1e-5)


def test_im2col_refuses_another_plan(cuda_device, monkeypatch):
    """The entry point refuses an access width, lanes or pixels a block
    that disagree with its own check, and the wrapper raises on it."""
    x, off, mask, _ = _im2col_case(cuda_device, "cin40")
    B, H, W, Cin = x.shape
    Ho, Wo = off.shape[1:3]
    cols = torch.empty(B * Ho * Wo, 9 * Cin, device=cuda_device,
                       dtype=x.dtype)
    plan = deform_conv.im2col_plan(B, H, W, Cin, Ho, Wo, 9, 2, x.data_ptr(),
                                   cols.data_ptr())
    stream = torch.cuda.current_stream().cuda_stream

    def call(p):
        return _build.lib().unibev_dcn_im2col(
            x.data_ptr(), off.data_ptr(), mask.data_ptr(), cols.data_ptr(), B,
            H, W, Cin, Ho, Wo, 3, 3, 1, 1, 1, 1, p.vec_bytes // 2, p.lanes,
            p.pixels, stream)

    assert call(plan) == 0
    for kw in (dict(vec_bytes=2), dict(lanes=16), dict(pixels=plan.pixels + 1),
               dict(vec_bytes=8)):
        assert call(plan._replace(**kw)) != 0, kw
    torch.cuda.synchronize()
    real = deform_conv.im2col_plan
    monkeypatch.setattr(deform_conv, "im2col_plan",
                        lambda *a: real(*a)._replace(lanes=4))
    with pytest.raises(RuntimeError, match="dcn_im2col"):
        deform_im2col(x, off, mask)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    value, loc, attn = _msda_inputs(cuda_device, torch.float32, ((29, 50),), 8)
    with pytest.raises(TypeError):
        ms_deform_attn(value.half(), ((29, 50),), loc, attn.half())
    with pytest.raises(ValueError):
        ms_deform_attn(value, ((29, 49),), loc, attn)
    with pytest.raises(ValueError):
        ms_deform_attn(value, ((29, 50),), loc.cpu(), attn)
    with pytest.raises(ValueError):
        ms_deform_attn_backward(value, ((29, 50),), loc, attn,
                                torch.zeros(2, 300, 7, device=cuda_device))
    x, off, mask, _ = _dcn_inputs(cuda_device, torch.float32)
    with pytest.raises(ValueError):
        deform_im2col(x, off, mask, stride=1)
    with pytest.raises(ValueError):
        deform_im2col(x.transpose(1, 2), off, mask, stride=2)
    w = torch.zeros(9 * 40, 24, device=cuda_device)
    with pytest.raises(ValueError):
        dcn_fwd(x, off, mask, w[:-1], stride=2)
    with pytest.raises(TypeError):
        dcn_fwd(x, off, mask, w.bfloat16(), stride=2)
    idx = torch.zeros(4, dtype=torch.int64, device=cuda_device)
    with pytest.raises(TypeError):
        scatter_add_rows(idx, torch.zeros(4, 8, device=cuda_device), 3)
    with pytest.raises(ValueError):
        scatter_add_rows(idx.int(), torch.zeros(4, 8, device=cuda_device), 3,
                         out=torch.zeros(3, 8, device=cuda_device).double())


def test_plain_versions_agree_with_themselves_on_cpu_and_card(cuda_device):
    """The plain versions are the card-side reference: they must give the
    CPU's answer on the card (TF32 off)."""
    value, loc, attn = _msda_inputs("cpu", torch.float32, ((29, 50),), 8)
    want = ms_deform_attn_reference(value, ((29, 50),), loc, attn)
    got = ms_deform_attn_reference(value.to(cuda_device), ((29, 50),),
                                   loc.to(cuda_device), attn.to(cuda_device))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-5)


def _sparse_grid(device, B=2, shape=(9, 14, 13), n=400, V=500, seed=0):
    """n distinct active cells in V shuffled rows, the rest padding."""
    g = torch.Generator().manual_seed(seed)
    D, H, W = shape
    cells = torch.randperm(B * D * H * W, generator=g)[:n]
    coords = torch.stack([cells // (D * H * W), (cells // (H * W)) % D,
                          (cells // W) % H, cells % W], 1).int()
    coords = torch.cat([coords, torch.full((V - n, 4), -1, dtype=torch.int32)])
    perm = torch.randperm(V, generator=g)
    coords = coords[perm].contiguous().to(device)
    return SparseGrid(coords, coords[:, 0] >= 0, shape, B)


@pytest.mark.parametrize("kernel,stride,padding", [
    ((3, 3, 3), (1, 1, 1), (1, 1, 1)), ((3, 3, 3), (2, 2, 2), (1, 1, 1)),
    ((3, 3, 3), (2, 2, 2), (0, 1, 1)), ((3, 1, 1), (2, 1, 1), (0, 0, 0))],
    ids=["subm", "k3s2p1", "k3s2p011", "conv_out"])
def test_sparse_nbr_kernel_matches_plain(cuda_device, kernel, stride, padding):
    grid = _sparse_grid(cuda_device)
    table = build_table(grid)
    V = grid.coords.shape[0]
    if stride == (1, 1, 1):
        co, mo = grid.coords, grid.mask
    else:
        out_shape = tuple((s + 2 * p - k) // st + 1 for s, p, k, st in
                          zip(grid.shape, padding, kernel, stride))
        co, mo, _, _ = downsample_with_table(grid, kernel, stride, padding,
                                             out_shape, 300)
    before = _build.launches["sparse_nbr"]
    got = sparse_nbr(table, V, grid.shape, co, mo, kernel, stride, padding)
    torch.cuda.synchronize()
    assert _build.launches["sparse_nbr"] == before + 1
    want = sparse_nbr_reference(table, V, grid.shape, co, mo, kernel, stride,
                                padding)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert bool((want < V).any()) and bool((want == V).any())


def _word_edge_grid(device, B=2, shape=(9, 14, 13), V=700, seed=1):
    """Every cell on either edge of a 32-cell word (1638 cells a sample, not
    a multiple of 32, so words straddle the samples) and as many random
    others, in V shuffled rows with padding."""
    g = torch.Generator().manual_seed(seed)
    D, H, W = shape
    cells = torch.arange(B * D * H * W)
    edge = cells[(cells % 32 == 0) | (cells % 32 == 31)]
    rest = cells[(cells % 32 != 0) & (cells % 32 != 31)]
    rest = rest[torch.randperm(rest.numel(), generator=g)[:edge.numel()]]
    live = torch.cat([edge, rest])
    coords = torch.stack([live // (D * H * W), (live // (H * W)) % D,
                          (live // W) % H, live % W], 1).int()
    coords = torch.cat([coords, torch.full((V - live.numel(), 4), -1,
                                           dtype=torch.int32)])
    coords = coords[torch.randperm(V, generator=g)].contiguous().to(device)
    return SparseGrid(coords, coords[:, 0] >= 0, shape, B)


@pytest.mark.parametrize("kernel,stride,padding", [
    ((3, 3, 3), (1, 1, 1), (1, 1, 1)), ((3, 3, 3), (2, 2, 2), (1, 1, 1)),
    ((3, 3, 3), (2, 2, 2), (0, 1, 1)), ((3, 1, 1), (2, 1, 1), (0, 0, 0))],
    ids=["subm", "k3s2p1", "k3s2p011", "conv_out"])
def test_rulebook_kernels_on_word_edges(cuda_device, kernel, stride, padding):
    """K6 (and K8 for a strided conv) bit for bit against their plain
    versions on compact tables at B = 2: shuffled rows, rows on the first
    and last cell of words, x windows across two words, and a capacity 100
    below the output sites (a dropped site reads the sentinel)."""
    grid = _word_edge_grid(cuda_device)
    table = build_table(grid)
    V = grid.coords.shape[0]
    co, mo = grid.coords, grid.mask
    if stride != (1, 1, 1):
        out_shape, co, mo, tab = _strided(grid, kernel, stride, padding)
        inv_args = (tab, 100, out_shape, grid.coords, grid.mask, kernel,
                    stride, padding)
        got = sparse_inv_nbr(*inv_args)
        want = sparse_inv_nbr_reference(*inv_args)
        assert torch.equal(got, want)
        assert bool((want < 100).any()) and bool((want == 100).any())
    args = (table, V, grid.shape, co, mo, kernel, stride, padding)
    got, want = sparse_nbr(*args), sparse_nbr_reference(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert bool((want < V).any()) and bool((want == V).any())


# (Cin, Cout, taps): the flagship's forward widths, their transposes (the
# d_feats of the strided convs), narrow and ragged widths
@pytest.mark.parametrize("cin,cout,taps", [
    (5, 16, 27), (8, 8, 27), (16, 32, 27), (40, 24, 27), (128, 128, 27),
    (32, 16, 27), (64, 32, 27), (128, 64, 27), (24, 40, 27), (128, 128, 3)])
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2 ** -6)],
                         ids=["f32", "bf16"])
def test_sparse_conv_kernel_matches_plain(cuda_device, cin, cout, taps, dtype,
                                          rel):
    """500 rows (not a multiple of K7's 64-row tile), rows 64-127 all
    sentinels (a tile with no live tap)."""
    grid = _sparse_grid(cuda_device)
    table = build_table(grid)
    V = grid.coords.shape[0]
    kernel = (3, 3, 3) if taps == 27 else (3, 1, 1)
    nidx = sparse_nbr(table, V, grid.shape, grid.coords, grid.mask, kernel,
                      (1, 1, 1), tuple(k // 2 for k in kernel))
    nidx[64:128] = V
    g = torch.Generator(device=cuda_device).manual_seed(1)
    feats = torch.randn(V, cin, device=cuda_device, generator=g).to(dtype)
    w = (torch.randn(taps * cin, cout, device=cuda_device, generator=g)
         * (taps * cin) ** -0.5).to(dtype)
    before = _build.launches["sparse_conv"]
    got = sparse_conv(feats, nidx, w, grid.mask)
    torch.cuda.synchronize()
    assert _build.launches["sparse_conv"] == before + 1
    assert got.dtype == dtype and got.shape == (V, cout)
    _close(got, sparse_conv_reference(feats, nidx, w, grid.mask), rel)
    assert bool((got[~grid.mask] == 0).all())


def test_sparse_conv_mma_fragments(cuda_device):
    """K7's bf16 tensor-core tile on exact products, 16 x 16 x 16: identity
    weights pass the gathered rows through, identity rows pass the weights
    through, and permuted rows land on their own outputs; a wrong mma or
    ldmatrix fragment layout misplaces values."""
    g = torch.Generator(device=cuda_device).manual_seed(4)
    x = torch.randn(16, 16, device=cuda_device, generator=g).bfloat16()
    eye = torch.eye(16, device=cuda_device, dtype=torch.bfloat16)
    nidx = torch.arange(16, dtype=torch.int32, device=cuda_device)[:, None]
    mask = torch.ones(16, dtype=torch.bool, device=cuda_device)
    perm = torch.randperm(16, generator=torch.Generator().manual_seed(0))
    perm = perm.to(cuda_device)
    assert torch.equal(sparse_conv(x, nidx, eye, mask), x)
    assert torch.equal(sparse_conv(eye, nidx, x, mask), x)
    assert torch.equal(sparse_conv(x, nidx[perm].contiguous(), eye, mask),
                       x[perm])


def test_sparse_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    grid = _sparse_grid(cuda_device)
    table = build_table(grid)
    args = (grid.shape, grid.coords, grid.mask, (3, 3, 3), (1, 1, 1), (1, 1, 1))
    with pytest.raises(TypeError):          # the dense int32 table
        sparse_nbr(table_entries(table), 500, *args)
    with pytest.raises(TypeError):
        sparse_nbr(table._replace(bits=table.bits.long()), 500, *args)
    with pytest.raises(ValueError):
        sparse_nbr(table._replace(size=table.size + 32), 500, *args)
    with pytest.raises(ValueError):
        sparse_nbr(table, 500, grid.shape, grid.coords.t().contiguous(),
                   *args[2:])
    nidx = sparse_nbr(table, 500, *args)
    feats = torch.randn(500, 8, device=cuda_device)
    w = torch.randn(27 * 8, 16, device=cuda_device)
    with pytest.raises(TypeError):
        sparse_conv(feats.half(), nidx, w, grid.mask)
    with pytest.raises(ValueError):
        sparse_conv(feats, nidx, w[:-1], grid.mask)
    with pytest.raises(ValueError):
        sparse_conv(feats, nidx, w, grid.mask.cpu())
    g = torch.randn(500, 16, device=cuda_device)
    with pytest.raises(TypeError):
        sparse_conv_wgrad(feats, nidx, g.bfloat16())
    with pytest.raises(ValueError):
        sparse_conv_wgrad(feats, nidx, g[:-1])
    with pytest.raises(TypeError):
        sparse_inv_nbr(table_entries(table), 100, (5, 7, 7), *args[1:3],
                       (3, 3, 3), (2, 2, 2), (1, 1, 1))
    with pytest.raises(TypeError):
        sparse_inv_nbr(table._replace(rows=table.rows.long()), 100,
                       (5, 7, 7), *args[1:3], (3, 3, 3), (2, 2, 2), (1, 1, 1))


STRIDED = [((3, 3, 3), (2, 2, 2), (1, 1, 1)), ((3, 3, 3), (2, 2, 2), (0, 1, 1)),
           ((3, 1, 1), (2, 1, 1), (0, 0, 0))]


def _strided(grid, kernel, stride, padding, cap=100):
    """(out_shape, coords, mask, table) of a strided conv's output sites, the
    capacity below the site count."""
    out_shape = tuple((s + 2 * p - k) // st + 1 for s, p, k, st in
                      zip(grid.shape, padding, kernel, stride))
    co, mo, tab, over = downsample_with_table(grid, kernel, stride, padding,
                                              out_shape, cap)
    assert int(over) > 0
    return out_shape, co, mo, tab


@pytest.mark.parametrize("kernel,stride,padding", STRIDED,
                         ids=["k3s2p1", "k3s2p011", "conv_out"])
def test_sparse_inv_nbr_kernel_matches_plain(cuda_device, kernel, stride,
                                             padding):
    grid = _sparse_grid(cuda_device)
    out_shape, _, _, tab = _strided(grid, kernel, stride, padding)
    args = (tab, 100, out_shape, grid.coords, grid.mask, kernel, stride, padding)
    before = _build.launches["sparse_inv_nbr"]
    got = sparse_inv_nbr(*args)
    torch.cuda.synchronize()
    assert _build.launches["sparse_inv_nbr"] == before + 1
    want = sparse_inv_nbr_reference(*args)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert bool((want < 100).any()) and bool((want == 100).any())


@pytest.mark.parametrize("cin,cout,taps", [(5, 16, 27), (16, 32, 27),
                                           (40, 24, 27), (64, 128, 27),
                                           (128, 128, 3), (16, 12, 27),
                                           (16, 10, 27), (256, 16, 27)])
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2 ** -6)],
                         ids=["f32", "bf16"])
def test_sparse_conv_wgrad_kernel_matches_plain(cuda_device, cin, cout, taps,
                                                dtype, rel):
    """Besides the flagship's widths, bf16 takes g by plain loads at Cout 12
    and 10 (rows not 16-byte multiples), adds into dW one float at a time
    at Cout 10 (rows not float4 multiples), and runs two input-channel
    chunks of the grid at Cin 256."""
    grid = _sparse_grid(cuda_device, n=3000, V=3500, shape=(20, 30, 31))
    table = build_table(grid)
    V = grid.coords.shape[0]
    kernel = (3, 3, 3) if taps == 27 else (3, 1, 1)
    nidx = sparse_nbr(table, V, grid.shape, grid.coords, grid.mask, kernel,
                      (1, 1, 1), tuple(k // 2 for k in kernel))
    g = torch.Generator(device=cuda_device).manual_seed(2)
    feats = torch.randn(V, cin, device=cuda_device, generator=g).to(dtype)
    cot = torch.randn(V, cout, device=cuda_device, generator=g).to(dtype)
    before = _build.launches["sparse_conv_wgrad"]
    got = sparse_conv_wgrad(feats, nidx, cot)
    torch.cuda.synchronize()
    assert _build.launches["sparse_conv_wgrad"] == before + 1
    assert got.dtype == torch.float32 and got.shape == (taps * cin, cout)
    _close(got, sparse_conv_wgrad_reference(feats, nidx, cot), rel)


@pytest.mark.parametrize("cin,cout", [(16, 16), (5, 16), (32, 128),
                                       (64, 32), (128, 128), (128, 40)])
def test_sparse_conv_wgrad_mma_fragments(cuda_device, cin, cout):
    """K9's bf16 tensor-core tile on exact products: with g the identity,
    dW is the gathered rows transposed; with the features the identity, dW
    is g's rows; with permuted rows the columns follow the permutation.
    Each sum holds one product that is not zero, so any order gives it
    exactly, and a wrong ldmatrix.trans or mma fragment layout misplaces
    values (rows span two of the kernel's 64-row items at 128)."""
    n = max(cin, cout)
    g = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randn(n, cin, device=cuda_device, generator=g).bfloat16()
    y = torch.randn(n, cout, device=cuda_device, generator=g).bfloat16()
    eye = torch.eye(n, device=cuda_device, dtype=torch.bfloat16)
    nidx = torch.arange(n, dtype=torch.int32, device=cuda_device)[:, None]
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(0))
    perm = perm.to(cuda_device)
    assert torch.equal(sparse_conv_wgrad(x, nidx, eye[:, :cout].contiguous()),
                       x[:cout].t().float())
    assert torch.equal(sparse_conv_wgrad(eye[:, :cin].contiguous(), nidx, y),
                       y[:cin].float())
    assert torch.equal(
        sparse_conv_wgrad(x, nidx[perm].contiguous(),
                          eye[:, :cout].contiguous()),
        x[perm][:cout].t().float())


@pytest.mark.parametrize("cin,cout", [(16, 16), (128, 128)])
def test_sparse_conv_wgrad_ignores_g_of_dropped_rows(cuda_device, cin, cout):
    """An output row whose taps are all sentinels (dropped by a capacity)
    adds nothing: NaN in its g leaves dW finite and equal to the plain
    version with those rows zeroed, as the old kernel gave.  The first 600
    rows are dropped ones, so that whole spans hold no live tap."""
    grid = _sparse_grid(cuda_device, n=3000, V=3500, shape=(20, 30, 31))
    table = build_table(grid)
    V = grid.coords.shape[0]
    nidx = sparse_nbr(table, V, grid.shape, grid.coords, grid.mask, (3, 3, 3),
                      (1, 1, 1), (1, 1, 1))
    nidx = torch.cat([torch.full_like(nidx[:600], V), nidx])
    dropped = torch.cat([torch.ones_like(grid.mask[:600]), ~grid.mask])
    assert bool((nidx[dropped] == V).all()) and int(dropped.sum()) == 1100
    g = torch.Generator(device=cuda_device).manual_seed(6)
    feats = torch.randn(V, cin, device=cuda_device, generator=g).bfloat16()
    cot = torch.randn(V + 600, cout, device=cuda_device,
                      generator=g).bfloat16()
    want = sparse_conv_wgrad_reference(feats, nidx, cot)
    cot[dropped] = float("nan")
    got = sparse_conv_wgrad(feats, nidx, cot)
    assert bool(torch.isfinite(got).all())
    _close(got, want, 2 ** -6)


@pytest.mark.parametrize("cout,taps", [(16, 27), (16, 3), (24, 27)])
def test_sparse_conv_wgrad_cin5(cuda_device, cout, taps):
    """conv_input's Cin = 5 (10-byte rows: plain loads into the 16-channel
    tile, the padded channels never written to dW), bf16, against the plain
    version; an odd Cout of 24 takes the 32-wide tile."""
    grid = _sparse_grid(cuda_device, n=3000, V=3500, shape=(20, 30, 31))
    table = build_table(grid)
    V = grid.coords.shape[0]
    kernel = (3, 3, 3) if taps == 27 else (3, 1, 1)
    nidx = sparse_nbr(table, V, grid.shape, grid.coords, grid.mask, kernel,
                      (1, 1, 1), tuple(k // 2 for k in kernel))
    g = torch.Generator(device=cuda_device).manual_seed(7)
    feats = torch.randn(V, 5, device=cuda_device, generator=g).bfloat16()
    cot = torch.randn(V, cout, device=cuda_device, generator=g).bfloat16()
    got = sparse_conv_wgrad(feats, nidx, cot)
    assert got.shape == (taps * 5, cout)
    _close(got, sparse_conv_wgrad_reference(feats, nidx, cot), 2 ** -6)


def test_sparse_conv_wgrad_refuses_another_plan(cuda_device):
    """The entry point refuses a span, item or shared-memory size that
    disagrees with its own layout, and tiles that are not its own."""
    from unibev_tpu_torch.ops.sparse_conv import wgrad_plan
    feats = torch.zeros(300, 16, device=cuda_device, dtype=torch.bfloat16)
    g = torch.zeros(300, 16, device=cuda_device, dtype=torch.bfloat16)
    nidx = torch.zeros(300, 27, device=cuda_device, dtype=torch.int32)
    dw = torch.zeros(27 * 16, 16, device=cuda_device)
    plan = wgrad_plan(300, 27, 16, 16, 2, _build.sm_count(feats.device.index))
    stream = torch.cuda.current_stream().cuda_stream

    def call(**kw):
        p = plan._replace(**kw)
        return _build.lib().unibev_sparse_conv_wgrad(
            feats.data_ptr(), nidx.data_ptr(), g.data_ptr(), dw.data_ptr(),
            300, 27, 16, 16, 300, 1, p.kc, p.bn, p.span, p.chunk,
            p.smem_bytes, stream)

    assert call() == 0
    for kw in (dict(smem_bytes=plan.smem_bytes + 16), dict(kc=32),
               dict(bn=64), dict(chunk=96), dict(span=plan.span + 64)):
        assert call(**kw) != 0, kw
    torch.cuda.synchronize()


@pytest.mark.parametrize("case", ["subm"] + ["k3s2p1", "k3s2p011", "conv_out"])
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2 ** -6)],
                         ids=["f32", "bf16"])
def test_sparse_conv_backward_goes_through_the_kernels(cuda_device, case,
                                                       dtype, rel):
    """d_feats and d_weight of ``sparse_conv`` on CUDA (K7 forward, K7 and
    K9 backward, K8 for a strided conv's inverse rulebook) against autograd
    through the plain forward in float32 on the same (for bf16, bf16-exact)
    values."""
    grid = _sparse_grid(cuda_device)
    table = build_table(grid)
    V = grid.coords.shape[0]
    if case == "subm":
        kernel, mo, inv = (3, 3, 3), grid.mask, None
        nidx = sparse_nbr(table, V, grid.shape, grid.coords, grid.mask, kernel,
                          (1, 1, 1), (1, 1, 1))
    else:
        kernel, stride, padding = STRIDED[["k3s2p1", "k3s2p011",
                                           "conv_out"].index(case)]
        out_shape, co, mo, tab = _strided(grid, kernel, stride, padding)
        nidx = sparse_nbr(table, V, grid.shape, co, mo, kernel, stride, padding)
        inv = sparse_inv_nbr(tab, 100, out_shape, grid.coords, grid.mask,
                             kernel, stride, padding)
    K = nidx.shape[1]
    g = torch.Generator(device=cuda_device).manual_seed(3)
    feats = torch.randn(V, 24, device=cuda_device, generator=g).to(dtype)
    w = (torch.randn(K * 24, 40, device=cuda_device, generator=g)
         * K ** -0.5).to(dtype)
    cot = torch.randn(nidx.shape[0], 40, device=cuda_device,
                      generator=g).to(dtype)
    grads = []
    before = dict(_build.launches)
    for fn, cast in ((lambda f, ww: sparse_conv(f, nidx, ww, mo, inv), dtype),
                     (lambda f, ww: sparse_conv_reference(f, nidx, ww, mo),
                      torch.float32)):
        f = feats.to(cast).requires_grad_()
        ww = w.to(cast).requires_grad_()
        grads.append(torch.autograd.grad(fn(f, ww), (f, ww), cot.to(cast)))
    torch.cuda.synchronize()
    assert _build.launches["sparse_conv"] == before.get("sparse_conv", 0) + 2
    assert _build.launches["sparse_conv_wgrad"] == before.get(
        "sparse_conv_wgrad", 0) + 1
    for a, b in zip(*grads):
        assert a.dtype == dtype
        _close(a, b, rel)


def _clustered_cloud(device, clusters=3, per=40, P=3000, seed=0):
    """As tests/test_torch_voxelize.py::_cloud builds it: P uniform points
    over a range 20% wider than (-4, -4, -1, 4, 4, 1) (so some fall
    outside), ``clusters`` dense clusters of ``per`` points each in one
    0.5 m voxel, and a tenth of the points masked."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-1, 1, (P, 5)).astype(np.float32)
    pts[:, 0:2] *= 4.8
    pts[:, 2] *= 1.2
    centres = rng.randint(0, [16, 16, 4], (clusters, 3)) * 0.5 + 0.25 \
        - np.array([4.0, 4.0, 1.0])
    for i, c in enumerate(centres):
        pts[per * i:per * (i + 1), :3] = c + rng.uniform(-0.2, 0.2, (per, 3))
    mask = rng.rand(P) > 0.1
    return (torch.from_numpy(pts).to(device),
            torch.from_numpy(mask).to(device))


def _check_voxels(got, want):
    for k in ("coords", "mask", "num_points", "num_voxels", "num_distinct"):
        g, w = getattr(got, k), getattr(want, k)
        assert g.dtype == w.dtype and torch.equal(g, w), k
    assert got.feats.dtype == torch.float32
    _close(got.feats, want.feats, 1e-6)


# name: (clusters, points a cluster, max_voxels, max_points)
VOXEL_CASES = {
    "below_cap": (3, 40, 2000, 10),
    "capped": (3, 40, 300, 10),
    "capped_3pts": (3, 40, 300, 3),
    # 60 clusters over the point cap, more voxels than the cap keeps
    "many_clusters": (60, 25, 200, 10),
}


@pytest.mark.parametrize("case", list(VOXEL_CASES))
def test_voxelize_kernel_matches_plain(cuda_device, case):
    clusters, per, max_voxels, max_points = VOXEL_CASES[case]
    pts, mask = _clustered_cloud(cuda_device, clusters, per)
    args = ((0.5, 0.5, 0.5), (-4.0, -4.0, -1.0, 4.0, 4.0, 1.0), (16, 16, 4),
            max_voxels, max_points)
    before = _build.launches["voxelize"]
    got = voxelize_and_encode(pts, mask, *args)
    torch.cuda.synchronize()
    assert _build.launches["voxelize"] == before + 1
    want = voxelize_and_encode_reference(pts, mask, *args)
    _check_voxels(got, want)
    assert int(want.num_points.max()) == max_points
    if max_voxels < 2000:
        assert int(want.num_distinct) > max_voxels == int(want.num_voxels)
    # and on the CPU, where the plain version sums in input order
    _check_voxels(voxelize_and_encode_reference(pts.cpu(), mask.cpu(), *args),
                  type(got)(*(t.cpu() for t in got)))


def test_voxelize_kernel_on_the_flagship_cloud(cuda_device):
    """300k uniform points on the [1440, 1440, 40] grid: 298,949 distinct
    voxels, 120,000 kept."""
    pts = synthetic_batch(np.random.RandomState(0),
                          device=cuda_device)["points"][0]
    mask = torch.ones(pts.shape[0], dtype=torch.bool, device=cuda_device)
    args = (VOXEL_SIZE, PC_RANGE, (1440, 1440, 40), 120000, 10)
    got = voxelize_and_encode(pts, mask, *args)
    _check_voxels(got, voxelize_and_encode_reference(pts, mask, *args))
    assert int(got.num_distinct) == 298949 and int(got.num_voxels) == 120000


def test_voxelize_kernel_at_the_radar_site(cuda_device):
    """The RC model's pillars: 2,048 radar points (7 columns) on the 180 x
    180 x 1 grid, 40,000 pillars of 20 points, 30 points in one pillar."""
    pts = synthetic_batch(np.random.RandomState(0), device=cuda_device,
                          R=RADAR_POINTS)["radar"][0].clone()
    pts[100:130, :2] = 10.3 + 0.2 * torch.rand(
        30, 2, generator=torch.Generator().manual_seed(0)).to(cuda_device)
    mask = torch.ones(pts.shape[0], dtype=torch.bool, device=cuda_device)
    args = (RADAR_VOXEL_SIZE, PC_RANGE, (180, 180, 1), 40000, 20)
    got = voxelize_and_encode(pts, mask, *args)
    want = voxelize_and_encode_reference(pts, mask, *args)
    _check_voxels(got, want)
    assert int(want.num_points.max()) == 20


def test_voxelize_refuses_what_the_kernel_does_not_take(cuda_device):
    pts, mask = _clustered_cloud(cuda_device)
    args = ((0.5, 0.5, 0.5), (-4.0, -4.0, -1.0, 4.0, 4.0, 1.0), (16, 16, 4),
            300, 10)
    with pytest.raises(TypeError):
        voxelize_and_encode(pts.bfloat16(), mask, *args)
    with pytest.raises(TypeError):
        voxelize_and_encode(pts, mask.int(), *args)
    with pytest.raises(ValueError):
        voxelize_and_encode(pts.t().contiguous().t(), mask, *args)
    with pytest.raises(ValueError):
        voxelize_and_encode(pts, mask.cpu(), *args)
    with pytest.raises(ValueError):
        voxelize_and_encode(pts, mask, *args[:2], (2 ** 11, 2 ** 11, 2 ** 9),
                            300, 10)


def _check_table(got, want, live):
    """Bitmaps and counts equal; the rank -> row maps on the ``live``
    ranks."""
    assert got.size == want.size and got.sentinel == want.sentinel
    assert got.rows.shape == want.rows.shape
    for k in ("bits", "base"):
        g, w = getattr(got, k), getattr(want, k)
        assert g.dtype == w.dtype == torch.int32 and torch.equal(g, w), k
    assert torch.equal(got.rows[:live], want.rows[:live])


@pytest.mark.parametrize("grid_fn", ["word_edge", "sparse"])
def test_build_table_kernel_matches_plain(cuda_device, grid_fn):
    grid = (_word_edge_grid if grid_fn == "word_edge" else _sparse_grid)(
        cuda_device)
    before = _build.launches["active_set"]
    got = build_table(grid)
    torch.cuda.synchronize()
    assert _build.launches["active_set"] == before + 1
    live = int(grid.mask.sum())
    _check_table(got, build_table_reference(grid), live)
    assert bool((got.rows[live:] == grid.coords.shape[0]).all())
    assert torch.equal(table_entries(got),
                       table_entries(build_table_reference(grid)))


@pytest.mark.parametrize("capacity", ["saturated", "exact", "roomy"])
@pytest.mark.parametrize("kernel,stride,padding", STRIDED,
                         ids=["k3s2p1", "k3s2p011", "conv_out"])
def test_downsample_kernel_matches_plain(cuda_device, kernel, stride, padding,
                                         capacity):
    """On the word-edge active set at B = 2: a capacity of 10 (far below
    the site count), the site count itself, and 4x the rows."""
    grid = _word_edge_grid(cuda_device)
    out_shape = tuple((s + 2 * p - k) // st + 1 for s, p, k, st in
                      zip(grid.shape, padding, kernel, stride))
    sites = int(downsample_with_table_reference(grid, kernel, stride, padding,
                                                out_shape, 1)[3]) + 1
    cap = dict(saturated=10, exact=sites,
               roomy=4 * grid.coords.shape[0])[capacity]
    before = _build.launches["active_set"]
    co, mo, tab, over = downsample_with_table(grid, kernel, stride, padding,
                                              out_shape, cap)
    torch.cuda.synchronize()
    assert _build.launches["active_set"] == before + 1
    wco, wmo, wtab, wover = downsample_with_table_reference(
        grid, kernel, stride, padding, out_shape, cap)
    assert over.dtype == torch.int64 and over.shape == ()
    assert int(over) == int(wover) == max(sites - cap, 0)
    assert co.dtype == torch.int32 and torch.equal(co, wco)
    assert torch.equal(mo, wmo)
    _check_table(tab, wtab, cap)
    # the kernels that read the new table read it as they read the plain one
    args = (cap, out_shape, grid.coords, grid.mask, kernel, stride, padding)
    assert torch.equal(sparse_inv_nbr(tab, *args), sparse_inv_nbr(wtab, *args))


@pytest.mark.parametrize("kernel,stride,padding", STRIDED,
                         ids=["k3s2p1", "k3s2p011", "conv_out"])
def test_downsample_kernel_on_a_sparse_grid(cuda_device, kernel, stride,
                                            padding):
    """80 live rows of 100 on a (17, 64, 64) grid at B = 2: fewer candidate
    sites than 4 per output word, where each lane sets its own bits (the
    dense grids above OR a warp's bits per word first); capacity 60, below
    the site count."""
    grid = _sparse_grid(cuda_device, shape=(17, 64, 64), n=80, V=100)
    out_shape = tuple((s + 2 * p - k) // st + 1 for s, p, k, st in
                      zip(grid.shape, padding, kernel, stride))
    args = (grid, kernel, stride, padding, out_shape, 60)
    co, mo, tab, over = downsample_with_table(*args)
    wco, wmo, wtab, wover = downsample_with_table_reference(*args)
    assert int(over) == int(wover) > 0
    assert torch.equal(co, wco) and torch.equal(mo, wmo)
    _check_table(tab, wtab, 60)


def test_active_set_refuses_what_the_kernel_does_not_take(cuda_device):
    grid = _sparse_grid(cuda_device)
    with pytest.raises(TypeError):
        build_table(grid._replace(coords=grid.coords.long()))
    with pytest.raises(ValueError):
        build_table(grid._replace(mask=grid.mask.cpu()))
    with pytest.raises(ValueError):
        build_table(grid._replace(coords=grid.coords.t().contiguous().t()))
    with pytest.raises(ValueError):
        downsample_with_table(grid, (3, 3, 3), (2, 2, 2), (1, 1, 1), (5, 7, 7),
                              0)


def _cells_grid(device, cells, shape, B=1, V=None, seed=0):
    """The rows of the given flat cells (distinct) on the (B, *shape) grid,
    shuffled, in V rows (padding after the live ones)."""
    D, H, W = shape
    cells = torch.as_tensor(cells, dtype=torch.int64)
    V = cells.numel() if V is None else V
    coords = torch.stack([cells // (D * H * W), (cells // (H * W)) % D,
                          (cells // W) % H, cells % W], 1).int()
    coords = torch.cat([coords, torch.full((V - cells.numel(), 4), -1,
                                           dtype=torch.int32)])
    g = torch.Generator().manual_seed(seed)
    coords = coords[torch.randperm(V, generator=g)].contiguous().to(device)
    return SparseGrid(coords, coords[:, 0] >= 0, shape, B)


def _random_cells(n, cells, seed=0):
    """n distinct cells of ``cells``."""
    g = torch.Generator().manual_seed(seed)
    if cells <= 2 ** 22:
        return torch.randperm(cells, generator=g)[:n]
    return torch.unique(torch.randint(0, cells, (2 * n,), generator=g))[:n]


# The single-pass scan at its edges, through build_table's bitmap: name ->
# ((D, H, W), batch, the live cells).  8192 words (262,144 cells) a tile.
SCAN_CASES = {
    # 128 words, the bitmap padded to one tile
    "one_tile": ((4, 32, 32), 1, lambda n: _random_cells(1500, n)),
    # 12,288 words: two tiles, the second half empty
    "two_tiles": ((3, 256, 512), 1, lambda n: _random_cells(60000, n)),
    # the flagship res-0 grid: 2,656,800 words, 325 tiles (up to 11 steps
    # of look-back)
    "flagship_tiles": ((41, 1440, 1440), 1,
                       lambda n: _random_cells(120000, n)),
    # every set bit in the last of three tiles
    "last_tile": ((3, 512, 512), 1,
                  lambda n: 2 * 262144 + _random_cells(100000, 262144)),
    # every cell set: 262,144 set bits a tile, bases up to 524,288
    "all_ones": ((2, 512, 512), 1, lambda n: torch.arange(n)),
}


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_single_pass_scan_at_its_edges(cuda_device, case):
    """K11's table (the scan's per-word base, one launch) bit for bit
    against the plain version's, and the map on the live ranks."""
    shape, B, live = SCAN_CASES[case]
    cells = live(B * shape[0] * shape[1] * shape[2])
    grid = _cells_grid(cuda_device, cells, shape, B, V=cells.numel() + 7)
    got, want = build_table(grid), build_table_reference(grid)
    torch.cuda.synchronize()
    _check_table(got, want, cells.numel())
    last = int(want.bits[-1]) & 0xffffffff
    assert int(want.base[-1]) + bin(last).count("1") == cells.numel()


@pytest.mark.parametrize("kernel,stride,padding", STRIDED,
                         ids=["k3s2p1", "k3s2p011", "conv_out"])
def test_downsample_kernel_on_a_grid_of_several_tiles(cuda_device, kernel,
                                                      stride, padding):
    """K11's active set where the output bitmap is several scan tiles (B =
    2 of (33, 200, 200): 2 at k3 s2, 5 at conv_out), the capacity half the
    site count."""
    grid = _sparse_grid(cuda_device, shape=(33, 200, 200), n=20000, V=21000)
    out_shape = tuple((s + 2 * p - k) // st + 1 for s, p, k, st in
                      zip(grid.shape, padding, kernel, stride))
    sites = int(downsample_with_table_reference(grid, kernel, stride, padding,
                                                out_shape, 1)[3]) + 1
    args = (grid, kernel, stride, padding, out_shape, sites // 2)
    co, mo, tab, over = downsample_with_table(*args)
    wco, wmo, wtab, wover = downsample_with_table_reference(*args)
    assert int(over) == int(wover) == sites - sites // 2
    assert torch.equal(co, wco) and torch.equal(mo, wmo)
    _check_table(tab, wtab, sites // 2)


GRAPH_SHAPE = (41, 128, 128)      # 671,744 cells: 3 scan tiles
GRAPH_CAPACITIES = (3000, 2000, 1500, 1000)


def _graph_chain(points, mask):
    """The encoder's K10 and K11 calls on one cloud: the voxels, the res-0
    table and the four strided convs' active sets and tables."""
    vox = voxelize_and_encode(points, mask, (0.1, 0.1, 0.2),
                              (-6.4, -6.4, -4.0, 6.4, 6.4, 4.2),
                              (128, 128, 41), 4000, 10)
    zero = torch.zeros_like(vox.coords[:, :1])
    coords = torch.where(vox.mask[:, None], torch.cat([zero, vox.coords], 1),
                         -1).contiguous()
    grid = SparseGrid(coords, vox.mask, GRAPH_SHAPE, 1)
    out = [vox, build_table(grid)]
    convs = [((3, 3, 3), (2, 2, 2), p, c) for p, c in
             zip(((1, 1, 1), (1, 1, 1), (0, 1, 1)), GRAPH_CAPACITIES[1:])]
    convs.append(((3, 1, 1), (2, 1, 1), (0, 0, 0), GRAPH_CAPACITIES[-1]))
    for kernel, stride, padding, capacity in convs:
        out_shape = tuple((s + 2 * p - k) // st + 1 for s, p, k, st in
                          zip(grid.shape, padding, kernel, stride))
        co, mo, tab, over = downsample_with_table(grid, kernel, stride,
                                                  padding, out_shape, capacity)
        out.append((co, mo, tab, over))
        grid = SparseGrid(co, mo, out_shape, 1)
    return out


def _graph_cloud(seed, P=5000):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-1, 1, (P, 5)).astype(np.float32)
    pts[:, :2] *= 6.4
    pts[:, 2] = pts[:, 2] * 4.0 + 0.1
    return torch.from_numpy(pts), torch.from_numpy(rng.rand(P) > 0.05)


def _check_chain(got, points, mask):
    want = _graph_chain(points, mask)       # CPU: the plain versions
    _check_voxels(type(want[0])(*(t.cpu() for t in got[0])), want[0])
    _check_table(type(want[1])(*(t.cpu() if torch.is_tensor(t) else t
                                 for t in got[1])), want[1],
                 int(want[0].mask.sum()))
    for (co, mo, tab, over), (wco, wmo, wtab, wover), cap in zip(
            got[2:], want[2:], GRAPH_CAPACITIES[1:] + GRAPH_CAPACITIES[-1:]):
        assert torch.equal(co.cpu(), wco) and torch.equal(mo.cpu(), wmo)
        assert int(over) == int(wover)
        _check_table(type(wtab)(*(t.cpu() if torch.is_tensor(t) else t
                                  for t in tab)), wtab, cap)


def test_k10_k11_replay_in_a_cuda_graph(cuda_device):
    """K10 and the five K11 calls of a forward captured in one CUDA graph
    after a warm-up, then replayed twice on new clouds copied into the
    captured inputs: each replay equals the plain versions, so every call
    resets its bitmap, scan state and slots inside the stream."""
    points, mask = (t.to(cuda_device) for t in _graph_cloud(0))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _graph_chain(points, mask)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = _graph_chain(points, mask)
    for seed in (1, 2):
        new_points, new_mask = _graph_cloud(seed)
        points.copy_(new_points)
        mask.copy_(new_mask)
        graph.replay()
        torch.cuda.synchronize()
        _check_chain(got, new_points, new_mask)


def _lsa_case(kind, device):
    """6 problems of 140 gt rows (the data path's max_gt) x 900 queries,
    valid counts 0, 1, 35, 139, 140 (packed) and one mask with holes; float
    costs, or integers in [0, 8), full of ties."""
    rng = np.random.RandomState(0)
    valid = np.zeros((6, 140), bool)
    for p, n in enumerate((0, 1, 35, 139, 140)):
        valid[p, :n] = True
    valid[5] = rng.rand(140) < 0.3
    cost = (rng.rand(6, 140, 900) * 4 if kind == "float"
            else rng.randint(0, 8, (6, 140, 900)))
    return (torch.tensor(cost, dtype=torch.float32, device=device),
            torch.tensor(valid, device=device))


@pytest.mark.parametrize("kind", ["float", "int"])
def test_lsa_kernel_matches_plain(cuda_device, kind):
    """K12's col4row equals the plain version's exactly (same float32
    arithmetic in the same order, ties to the lowest column)."""
    cost, valid = _lsa_case(kind, cuda_device)
    before = dict(_build.launches)
    got = linear_sum_assignment(cost, valid)
    torch.cuda.synchronize()
    assert _launched_since(before) == {"lsa": 1}
    want = linear_sum_assignment_plain(cost.cpu(), valid.cpu())
    assert got.dtype == torch.int32
    assert torch.equal(got.cpu(), want)


def test_lsa_kernel_on_small_problems(cuda_device):
    """One and two columns a thread, a problem of one cell, rows = columns."""
    rng = np.random.RandomState(1)
    for R, C in ((1, 1), (5, 5), (24, 300), (64, 512)):
        cost = torch.tensor(rng.randint(0, 4, (3, R, C)), dtype=torch.float32)
        valid = torch.tensor(rng.rand(3, R) < 0.8)
        got = linear_sum_assignment(cost.to(cuda_device), valid.to(cuda_device))
        assert torch.equal(got.cpu(), linear_sum_assignment_plain(cost, valid))


def _lsa_masks(kind, P, R, rng):
    """(P, R) masks: all valid, or holes that make K12's row ring skip rows
    (every other row, runs of five, the last row alone, one in ten)."""
    if kind == "all":
        return np.ones((P, R), bool)
    masks = [np.arange(R) % 2 == 1, np.arange(R) // 5 % 2 == 0,
             np.arange(R) == R - 1, rng.rand(R) < 0.1]
    return np.stack([masks[p % len(masks)] for p in range(P)])


# (P, R, C, costs, mask): more valid rows than K12's ring of staged rows;
# holes in the mask; C % 4 != 0 (rows at odd offsets); C = 2048 with more
# than 682 rows (over 48 KB of shared memory); rows = columns (long chains)
LSA_EDGE_CASES = {
    "ring_overrun": (3, 64, 900, "float", "all"),
    "holes": (4, 140, 900, "float", "holes"),
    "c301": (4, 40, 301, "float", "holes"),
    "c2048_float": (2, 768, 2048, "float", "all"),
    "c2048_int": (2, 768, 2048, "int", "holes"),
    "square_int": (2, 256, 256, "int", "all"),
}


@pytest.mark.parametrize("case", list(LSA_EDGE_CASES))
def test_lsa_kernel_on_ring_and_width_edges(cuda_device, case):
    """K12's col4row equals the plain version's where its staged rows, its
    shared memory and its general path reach their edges."""
    P, R, C, kind, mask = LSA_EDGE_CASES[case]
    rng = np.random.RandomState(3)
    cost = torch.tensor(rng.rand(P, R, C) * 4 if kind == "float"
                        else rng.randint(0, 8, (P, R, C)), dtype=torch.float32)
    valid = torch.tensor(_lsa_masks(mask, P, R, rng))
    before = dict(_build.launches)
    got = linear_sum_assignment(cost.to(cuda_device), valid.to(cuda_device))
    torch.cuda.synchronize()
    assert _launched_since(before) == {"lsa": 1}
    assert torch.equal(got.cpu(), linear_sum_assignment_plain(cost, valid))


def test_lsa_replays_in_a_cuda_graph(cuda_device):
    """K12 captured in a CUDA graph after a warm-up, then replayed on new
    costs and masks copied into the captured inputs: each replay equals the
    plain version, so the kernel resets its state inside the launch."""
    cost, valid = _lsa_case("float", cuda_device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        linear_sum_assignment(cost, valid)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = linear_sum_assignment(cost, valid)
    rng = np.random.RandomState(4)
    for kind in ("float", "int"):
        new_cost = torch.tensor(rng.rand(*cost.shape) * 4 if kind == "float"
                                else rng.randint(0, 8, cost.shape),
                                dtype=torch.float32)
        new_valid = torch.tensor(rng.rand(*valid.shape) < 0.5)
        cost.copy_(new_cost)
        valid.copy_(new_valid)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(),
                           linear_sum_assignment_plain(new_cost, new_valid))


def test_lsa_refuses_what_the_kernel_does_not_take(cuda_device):
    cost, valid = _lsa_case("int", cuda_device)
    with pytest.raises(TypeError):
        linear_sum_assignment(cost.double(), valid)
    with pytest.raises(TypeError):
        linear_sum_assignment(cost, valid.int())
    with pytest.raises(ValueError):
        linear_sum_assignment(cost.transpose(1, 2), valid)
    with pytest.raises(ValueError):
        linear_sum_assignment(cost[:, :, ::2], valid)
    with pytest.raises(ValueError):
        linear_sum_assignment(torch.zeros(1, 2, 4096, device=cuda_device),
                              torch.ones(1, 2, dtype=torch.bool,
                                         device=cuda_device))
    with pytest.raises(ValueError):
        linear_sum_assignment(cost, valid.cpu())


# K13's shapes: the smallest C, a bottleneck's width on an odd map, the
# widest C on a map smaller than one wave
FBN_SHAPES = [(2, 8, 5, 7), (3, 256, 13, 17), (1, 2048, 3, 5)]
FBN_REL = {torch.float32: 1e-6, torch.bfloat16: 2 ** -8}


def _fbn_case(form, shape, dtype, buf_dtype, device, seed=0):
    gen = torch.Generator().manual_seed(seed)

    def bn():
        m = FrozenBatchNorm(shape[1])
        for name in ("weight", "bias", "running_mean"):
            getattr(m, name).copy_(torch.randn(shape[1], generator=gen))
        m.running_var.copy_(0.5 + 1.5 * torch.rand(shape[1], generator=gen))
        return m.to(device=device, dtype=buf_dtype)

    def act():
        return torch.randn(shape, generator=gen).to(device, dtype).contiguous(
            memory_format=torch.channels_last)
    x, kw = act(), {}
    if form == "b":
        kw["residual"] = act()
    if form == "c":
        kw = dict(down=act(), down_bn=bn())
    return x, bn(), kw


@pytest.mark.parametrize("form", ["a", "b", "c"])
@pytest.mark.parametrize("dtype,buf_dtype",
                         [(torch.bfloat16, torch.bfloat16),
                          (torch.bfloat16, torch.float32),
                          (torch.float32, torch.float32),
                          (torch.float32, torch.bfloat16)],
                         ids=["bf16", "bf16-f32bn", "f32", "f32-bf16bn"])
def test_frozen_bn_act_matches_plain(cuda_device, form, dtype, buf_dtype):
    for shape in FBN_SHAPES:
        x, bn, kw = _fbn_case(form, shape, dtype, buf_dtype, cuda_device)
        x[0, 0, 0, 0] = float("nan")
        before = _build.launches["frozen_bn_act"]
        got = frozen_bn_act(x, bn, **kw)
        assert _build.launches["frozen_bn_act"] == before + 1
        want = frozen_bn_act_reference(x, bn, **kw)
        assert got.dtype == dtype
        assert got.is_contiguous(memory_format=torch.channels_last)
        assert torch.isnan(got[0, 0, 0, 0])
        got[0, 0, 0, 0] = want[0, 0, 0, 0] = 0
        _close(got, want, FBN_REL[dtype])


@pytest.mark.parametrize("form", ["a", "b", "c"])
def test_frozen_bn_act_gradients_match_plain(cuda_device, form):
    x, bn, kw = _fbn_case(form, FBN_SHAPES[1], torch.float32, torch.float32,
                          cuda_device, seed=1)
    g = torch.randn(x.shape, device=cuda_device)
    names = ["x"] + [k for k in ("residual", "down") if k in kw]
    grads = []
    for fn in (frozen_bn_act, frozen_bn_act_reference):
        leaves = [t.detach().clone().requires_grad_()
                  for t in [x] + [kw[k] for k in names[1:]]]
        extra = dict(zip(names[1:], leaves[1:]))
        if "down_bn" in kw:
            extra["down_bn"] = kw["down_bn"]
        out = fn(leaves[0], bn, **extra)
        grads.append(torch.autograd.grad(out, leaves, g))
    for got, want in zip(*grads):
        _close(got, want, 1e-6)


def test_frozen_bn_act_refuses_what_the_kernel_does_not_take(cuda_device):
    x, bn, _ = _fbn_case("a", (2, 16, 4, 6), torch.bfloat16, torch.bfloat16,
                         cuda_device)
    with pytest.raises(ValueError):                 # NCHW memory
        frozen_bn_act(x.contiguous(), bn)
    with pytest.raises(ValueError):                 # C not a multiple of 8
        x12, bn12, _ = _fbn_case("a", (2, 12, 4, 6), torch.bfloat16,
                                 torch.bfloat16, cuda_device)
        frozen_bn_act(x12, bn12)
    with pytest.raises(ValueError):                 # residual of another dtype
        frozen_bn_act(x, bn, residual=x.float())
    with pytest.raises(ValueError):                 # buffers of mixed dtypes
        bn.running_var = bn.running_var.float()
        frozen_bn_act(x, bn)
    with pytest.raises(TypeError):
        frozen_bn_act(x.half(), bn)
