"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device (marker ``cuda``) and skips on a CPU-only
machine; the file imports no JAX, so it runs where only PyTorch is
installed::

    python -m pytest tests/test_torch_kernels.py -m cuda -q

Tolerances are relative to max |plain| (at least 1): f32 1e-4 for the
DCN columns and product, 1e-5 for MSDA (the same terms summed in another
order, TF32 off); bf16 2^-6 (outputs rounded to bf16, relative 2^-8, with
margin).  The backwards (K3, K4, each followed by the scatter-add K5) sum
their contributions with float32 atomics in no fixed order: f32 1e-4, bf16
2^-6 (each contribution row is rounded to bf16 before the sum).  The chunk
budget is shrunk so that every backward runs several chunks.  d_loc and
d_offset jump across cell edges, where the kernels and grid_sample may round
a position to different sides: they are compared at points 1e-3 pixels or
more inside a cell (``cell_interior`` / ``tap_interior``).  The sparse-conv
rulebook K6 and the inverse rulebook K8 must equal their plain versions
exactly; the sparse conv K7 and the weight gradient K9 f32 1e-4, bf16 2^-6
(the same products summed in another order; K9's float32 atomics sum its
row spans in no fixed order).
"""

import numpy as np
import pytest
import torch

from torch_port_utils import cuda_device  # noqa: F401
from unibev_tpu_torch.ops import _build, scatter
from unibev_tpu_torch.ops.deform_conv import (
    deform_im2col, deform_im2col_backward, deform_im2col_backward_reference,
    deform_im2col_reference, modulated_deform_conv2d,
    modulated_deform_conv2d_reference, tap_interior)
from unibev_tpu_torch.ops.msda import (cell_interior, ms_deform_attn,
                                       ms_deform_attn_backward,
                                       ms_deform_attn_backward_reference,
                                       ms_deform_attn_reference)
from unibev_tpu_torch.ops.scatter import (scatter_add_rows,
                                          scatter_add_rows_reference)
from unibev_tpu_torch.ops.sparse_conv import (
    SparseGrid, build_table, downsample_with_table, sparse_conv,
    sparse_conv_reference, sparse_conv_wgrad, sparse_conv_wgrad_reference,
    sparse_inv_nbr, sparse_inv_nbr_reference, sparse_nbr, sparse_nbr_reference)

BWD_REL = {torch.float32: 1e-4, torch.bfloat16: 2 ** -6}

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _close(got, want, rel):
    tol = rel * max(1.0, want.float().abs().max().item())
    assert (got.float() - want.float()).abs().max().item() <= tol


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


@pytest.mark.parametrize("levels,P", [(((29, 50),), 8), (((29, 50), (7, 9)), 4),
                                      (((200, 200),), 4)], ids=["sca", "L2", "bev"])
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2 ** -6)],
                         ids=["f32", "bf16"])
def test_msda_kernel_matches_plain(cuda_device, levels, P, dtype, rel):
    value, loc, attn = _msda_inputs(cuda_device, dtype, levels, P)
    before = _build.launches["msda_fwd"]
    got = ms_deform_attn(value, levels, loc, attn)
    torch.cuda.synchronize()
    assert _build.launches["msda_fwd"] == before + 1
    assert got.dtype == dtype and got.shape == (2, 300, 8 * 32)
    _close(got, ms_deform_attn_reference(value, levels, loc, attn), rel)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2 ** -6)],
                         ids=["f32", "bf16"])
def test_dcn_kernel_matches_plain(cuda_device, stride, dtype, rel):
    x, off, mask, w = _dcn_inputs(cuda_device, dtype, stride=stride)
    before = _build.launches["dcn_im2col"]
    cols = deform_im2col(x, off, mask, stride=stride)
    out = modulated_deform_conv2d(x, off, mask, w, stride=stride)
    torch.cuda.synchronize()
    assert _build.launches["dcn_im2col"] == before + 2
    _close(cols, deform_im2col_reference(x, off, mask, stride=stride), rel)
    _close(out, modulated_deform_conv2d_reference(x, off, mask, w, stride=stride),
           rel)


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


@pytest.mark.parametrize("levels,P", [(((29, 50),), 8), (((29, 50), (7, 9)), 4),
                                      (((200, 200),), 4)], ids=["sca", "L2", "bev"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_msda_backward_kernel_matches_plain(cuda_device, monkeypatch, levels,
                                            P, dtype):
    monkeypatch.setattr(scatter, "BWD_CHUNK_BYTES", 1e6)
    value, loc, attn = _msda_inputs(cuda_device, dtype, levels, P)
    loc[0, 0, 0, 0, 0] = float("nan")          # samples nothing, gets no grad
    g = torch.randn(2, 300, 8 * 32, device=cuda_device).to(dtype)
    before = _build.launches["msda_bwd"]
    got = ms_deform_attn_backward(value, levels, loc, attn, g)
    torch.cuda.synchronize()
    assert _build.launches["msda_bwd"] > before + 1      # several chunks
    assert got[1][0, 0, 0, 0, 0].abs().sum() == 0 and got[2][0, 0, 0, 0, 0] == 0
    loc[0, 0, 0, 0, 0] = 5.0                   # as far out: the plain version's
    want = ms_deform_attn_backward_reference(value, levels, loc, attn, g)
    interior = cell_interior(loc, levels)
    masks = (1, interior, 1)
    for a, b, m, dt in zip(got, want, masks, (dtype, torch.float32, dtype)):
        assert a.dtype == dt and a.shape == b.shape
        _close(a * m, b * m, BWD_REL[dtype])


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_dcn_backward_kernel_matches_plain(cuda_device, monkeypatch, stride,
                                           dtype):
    monkeypatch.setattr(scatter, "BWD_CHUNK_BYTES", 2e5)
    x, off, mask, _ = _dcn_inputs(cuda_device, dtype, stride=stride)
    d_cols = torch.randn(deform_im2col_reference(x, off, mask, stride=stride).shape,
                         device=cuda_device).to(dtype)
    before = _build.launches["dcn_bwd"]
    got = deform_im2col_backward(x, off, mask, d_cols, stride=stride)
    torch.cuda.synchronize()
    assert _build.launches["dcn_bwd"] > before + 1       # several chunks
    want = deform_im2col_backward_reference(x, off, mask, d_cols, stride=stride)
    masks = (1, tap_interior(off, stride=stride), 1)
    for a, b, m in zip(got, want, masks):
        assert a.dtype == dtype and a.shape == b.shape
        _close(a * m, b * m, BWD_REL[dtype])


def test_autograd_goes_through_the_kernels(cuda_device):
    """Gradients of the ops on CUDA tensors (K1/K3/K5 and K2/K4/K5) against
    autograd through the plain versions, f32."""
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
    for k in ("msda_fwd", "msda_bwd", "dcn_im2col", "dcn_bwd",
              "scatter_add_rows"):
        assert after.get(k, 0) > before.get(k, 0), k


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


def _sparse_grid(device, B=2, shape=(9, 14, 13), n=400, V=512, seed=0):
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
        co, mo, _, _ = downsample_with_table(grid, table, kernel, stride,
                                             padding, out_shape, 300)
    before = _build.launches["sparse_nbr"]
    got = sparse_nbr(table, V, grid.shape, co, mo, kernel, stride, padding)
    torch.cuda.synchronize()
    assert _build.launches["sparse_nbr"] == before + 1
    want = sparse_nbr_reference(table, V, grid.shape, co, mo, kernel, stride,
                                padding)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert bool((want < V).any()) and bool((want == V).any())


@pytest.mark.parametrize("cin,cout,taps", [(5, 16, 27), (16, 32, 27),
                                           (40, 24, 27), (128, 128, 3)])
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2 ** -6)],
                         ids=["f32", "bf16"])
def test_sparse_conv_kernel_matches_plain(cuda_device, cin, cout, taps, dtype,
                                          rel):
    grid = _sparse_grid(cuda_device)
    table = build_table(grid)
    V = grid.coords.shape[0]
    kernel = (3, 3, 3) if taps == 27 else (3, 1, 1)
    nidx = sparse_nbr(table, V, grid.shape, grid.coords, grid.mask, kernel,
                      (1, 1, 1), tuple(k // 2 for k in kernel))
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


def test_sparse_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    grid = _sparse_grid(cuda_device)
    table = build_table(grid)
    args = (grid.shape, grid.coords, grid.mask, (3, 3, 3), (1, 1, 1), (1, 1, 1))
    with pytest.raises(TypeError):
        sparse_nbr(table.long(), 512, *args)
    with pytest.raises(ValueError):
        sparse_nbr(table, 512, grid.shape, grid.coords.t().contiguous(),
                   *args[2:])
    nidx = sparse_nbr(table, 512, *args)
    feats = torch.randn(512, 8, device=cuda_device)
    w = torch.randn(27 * 8, 16, device=cuda_device)
    with pytest.raises(TypeError):
        sparse_conv(feats.half(), nidx, w, grid.mask)
    with pytest.raises(ValueError):
        sparse_conv(feats, nidx, w[:-1], grid.mask)
    with pytest.raises(ValueError):
        sparse_conv(feats, nidx, w, grid.mask.cpu())
    g = torch.randn(512, 16, device=cuda_device)
    with pytest.raises(TypeError):
        sparse_conv_wgrad(feats, nidx, g.bfloat16())
    with pytest.raises(ValueError):
        sparse_conv_wgrad(feats, nidx, g[:-1])
    with pytest.raises(TypeError):
        sparse_inv_nbr(table.long(), 100, (5, 7, 7), *args[1:3], (3, 3, 3),
                       (2, 2, 2), (1, 1, 1))


STRIDED = [((3, 3, 3), (2, 2, 2), (1, 1, 1)), ((3, 3, 3), (2, 2, 2), (0, 1, 1)),
           ((3, 1, 1), (2, 1, 1), (0, 0, 0))]


def _strided(grid, table, kernel, stride, padding, cap=100):
    """(out_shape, coords, mask, table) of a strided conv's output sites, the
    capacity below the site count."""
    out_shape = tuple((s + 2 * p - k) // st + 1 for s, p, k, st in
                      zip(grid.shape, padding, kernel, stride))
    co, mo, tab, over = downsample_with_table(grid, table, kernel, stride,
                                              padding, out_shape, cap)
    assert int(over) > 0
    return out_shape, co, mo, tab


@pytest.mark.parametrize("kernel,stride,padding", STRIDED,
                         ids=["k3s2p1", "k3s2p011", "conv_out"])
def test_sparse_inv_nbr_kernel_matches_plain(cuda_device, kernel, stride,
                                             padding):
    grid = _sparse_grid(cuda_device)
    out_shape, _, _, tab = _strided(grid, build_table(grid), kernel, stride,
                                    padding)
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
                                           (128, 128, 3)])
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2 ** -6)],
                         ids=["f32", "bf16"])
def test_sparse_conv_wgrad_kernel_matches_plain(cuda_device, cin, cout, taps,
                                                dtype, rel):
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


@pytest.mark.parametrize("case", ["subm"] + ["k3s2p1", "k3s2p011", "conv_out"])
def test_sparse_conv_backward_goes_through_the_kernels(cuda_device, case):
    """d_feats and d_weight of ``sparse_conv`` on CUDA (K7 forward, K7 and
    K9 backward, K8 for a strided conv's inverse rulebook) against autograd
    through the plain forward, f32."""
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
        out_shape, co, mo, tab = _strided(grid, table, kernel, stride, padding)
        nidx = sparse_nbr(table, V, grid.shape, co, mo, kernel, stride, padding)
        inv = sparse_inv_nbr(tab, 100, out_shape, grid.coords, grid.mask,
                             kernel, stride, padding)
    K = nidx.shape[1]
    g = torch.Generator(device=cuda_device).manual_seed(3)
    feats = torch.randn(V, 24, device=cuda_device, generator=g)
    w = torch.randn(K * 24, 40, device=cuda_device, generator=g) * K ** -0.5
    cot = torch.randn(nidx.shape[0], 40, device=cuda_device, generator=g)
    grads = []
    before = dict(_build.launches)
    for fn in (lambda f, ww: sparse_conv(f, nidx, ww, mo, inv),
               lambda f, ww: sparse_conv_reference(f, nidx, ww, mo)):
        f, ww = feats.clone().requires_grad_(), w.clone().requires_grad_()
        grads.append(torch.autograd.grad(fn(f, ww), (f, ww), cot))
    torch.cuda.synchronize()
    assert _build.launches["sparse_conv"] == before.get("sparse_conv", 0) + 2
    assert _build.launches["sparse_conv_wgrad"] == before.get(
        "sparse_conv_wgrad", 0) + 1
    for a, b in zip(*grads):
        _close(a, b, 1e-4)
