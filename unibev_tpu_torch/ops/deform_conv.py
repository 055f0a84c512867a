"""Modulated deformable convolution (DCNv2): kernel wrappers and plain versions.

Counterpart of ``unibev_tpu/ops/deform_conv.py::modulated_deform_conv2d``
(semantics from its ``_mdcn_clean``).  The forward is one fused CUDA kernel,
``dcn_fwd`` (``csrc/deform_conv.cu::unibev_dcn_fwd``): it samples the
deformable columns into shared memory and multiplies them there, so the
(B*Ho*Wo, K*Cin) column matrix never reaches device memory;
:func:`dcn_fwd_plan` is its launch plan.  The gradient follows
``_mdcn_fast_bwd``, which recomputes the gather: the im2col kernel
(``unibev_dcn_im2col``) writes the columns for d_weight = cols^T g; d_cols
= g W^T and d_weight are ``torch.matmul``; kernel K4 (``csrc/deform_conv.cu::
unibev_dcn_bwd``), one launch per layer, turns d_cols into d_offset and
d_mask and adds d_x straight into a float32 table with vector reductions;
:func:`dcn_bwd_plan` is its launch plan.

Each kernel tap moves to a fractional position ``(ho*stride - pad + ky*dil +
dy, wo*stride - pad + kx*dil + dx)``, is sampled bilinearly with zero
padding, and is scaled by its (already sigmoid-ed) mask.  The offset layout
is mmcv's: ``offset[..., 2k] = dy_k``, ``offset[..., 2k+1] = dx_k``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from unibev_tpu_torch.ops import _build


def _out_size(size, k, stride, padding, dilation):
    return (size + 2 * padding - dilation * (k - 1) - 1) // stride + 1


# dcn_fwd's square tile (output pixels, output channels, items in its
# shared-memory ring) and its wide tile for 256 < Cout <= 512; threads (16
# warps), the bytes of a staged row
DCN_FWD_TILE = (128, 256, 3)
DCN_FWD_WIDE_TILE = (64, 512, 2)
DCN_FWD_WARPS = 16
DCN_FWD_ROW_BYTES = 128


class DcnFwdPlan(NamedTuple):
    """How ``dcn_fwd`` covers one layer: tiles of ``rows`` output pixels by
    ``bn`` output channels (``channel_tiles`` of them across Cout, each
    sampling the columns anew), ``warps`` warps a block, ``kc`` input
    channels per stage (``chunks`` per tap), ``smem_bytes`` of dynamic
    shared memory."""
    rows: int
    bn: int
    channel_tiles: int
    warps: int
    kc: int
    chunks: int
    smem_bytes: int


def dcn_fwd_plan(cin: int, cout: int, taps: int = 9,
                 itemsize: int = 2) -> DcnFwdPlan:
    """The launch plan of ``dcn_fwd`` for a layer of ``taps`` taps, ``cin``
    -> ``cout`` channels, in a dtype of ``itemsize`` bytes (2 bf16, 4 f32).

    A tile is 128 pixels by 256 output channels in a ring of three items,
    or, for 256 < Cout <= 512, 64 pixels by 512 channels in a ring of two
    (16 warps; in bf16 four warpgroups of wgmma m64n128), so each column
    element is sampled once up to Cout 512; a wider Cout takes more channel
    tiles.  A stage holds 128 bytes of input channels per row (64 bf16, 32
    f32).  The shared memory is the layout of ``FwdLayout`` in
    ``csrc/deform_conv.cu`` (the launch refuses a plan that disagrees): 1024
    bytes of alignment slack, the ring's stages of the sampled columns
    (rows x 128 bytes) and the weight slice (bn x 128 bytes), which the
    output tile (rows x bn, rows padded by 16 bytes) reuses, 64 bytes of
    mbarriers and a flag, then the geometry (4 f32 corner weights and the
    int32 row of the first corner per pixel and tap).  The grid is one wave
    of blocks that share the tiles' items evenly (``csrc/deform_conv.cu``)."""
    wide = DCN_FWD_TILE[1] < cout <= DCN_FWD_WIDE_TILE[1]
    rows, bn, stages = DCN_FWD_WIDE_TILE if wide else DCN_FWD_TILE
    kc = DCN_FWD_ROW_BYTES // itemsize
    stage = (rows + bn) * DCN_FWD_ROW_BYTES
    out = rows * (bn + 16 // itemsize) * itemsize
    smem = 1024 + max(stages * stage, out) + 64 + taps * rows * 20
    return DcnFwdPlan(rows=rows, bn=bn, channel_tiles=-(-cout // bn),
                      warps=DCN_FWD_WARPS, kc=kc, chunks=-(-cin // kc),
                      smem_bytes=smem)


def dcn_bwd_plan(B: int, H: int, W: int, Cin: int, Ho: int, Wo: int,
                 taps: int, itemsize: int, x_address: int = 0,
                 d_cols_address: int = 0) -> _build.BwdPlan:
    """K4's launch plan (:func:`_build.bwd_plan`): items (output pixel,
    tap) of Cin channels, x's and d_cols' addresses (a warp of two 4-channel
    chunks a lane at Cin 256 in bf16)."""
    return _build.bwd_plan(B * Ho * Wo * taps, Cin, itemsize,
                           (x_address, d_cols_address), B * H * W * Cin)


def _im2col_f32(x, offset, mask, kernel_size, stride, padding, dilation):
    B, H, W, Cin = x.shape
    Kh, Kw = kernel_size
    Ho, Wo = offset.shape[1], offset.shape[2]
    xt = x.float().permute(0, 3, 1, 2)                          # (B, Cin, H, W)
    off = offset.float().reshape(B, Ho, Wo, Kh * Kw, 2)
    dev = x.device
    oy = torch.arange(Ho, device=dev, dtype=torch.float32) * stride - padding
    ox = torch.arange(Wo, device=dev, dtype=torch.float32) * stride - padding
    taps = []
    for k in range(Kh * Kw):
        ky, kx = divmod(k, Kw)
        sy = oy[None, :, None] + ky * dilation + off[..., k, 0]   # (B, Ho, Wo)
        sx = ox[None, None, :] + kx * dilation + off[..., k, 1]
        # grid_sample with align_corners=False reads pixel ((g + 1) * size - 1) / 2
        grid = torch.stack([(2 * sx + 1) / W - 1, (2 * sy + 1) / H - 1], dim=-1)
        s = F.grid_sample(xt, grid, mode="bilinear", padding_mode="zeros",
                          align_corners=False)                   # (B, Cin, Ho, Wo)
        taps.append(s.permute(0, 2, 3, 1) * mask[..., k:k + 1].float())
    cols = torch.cat(taps, dim=-1)                               # (B, Ho, Wo, K*Cin)
    return cols.reshape(B * Ho * Wo, Kh * Kw * Cin)


def deform_im2col_reference(x, offset, mask, kernel_size=(3, 3), stride=1,
                            padding=1, dilation=1) -> torch.Tensor:
    """Plain version of the im2col: one ``F.grid_sample`` per tap, in float32.

    x (B, H, W, Cin) NHWC; offset (B, Ho, Wo, 2K); mask (B, Ho, Wo, K).
    Returns cols (B*Ho*Wo, K*Cin), tap-major, in x's dtype.
    """
    return _im2col_f32(x, offset, mask, kernel_size, stride, padding,
                       dilation).to(x.dtype)


def deform_im2col(x, offset, mask, kernel_size=(3, 3), stride=1, padding=1,
                  dilation=1) -> torch.Tensor:
    """Deformable im2col (the columns the backward multiplies for d_weight);
    CPU tensors take the plain version, CUDA tensors the ``dcn_im2col``
    kernel.  Same layouts as :func:`deform_im2col_reference`."""
    if x.device.type == "cpu":
        return deform_im2col_reference(x, offset, mask, kernel_size, stride,
                                       padding, dilation)
    return _im2col_cuda(x, offset, mask, tuple(kernel_size), stride, padding,
                        dilation)


def tap_interior(offset: torch.Tensor, kernel_size=(3, 3), stride=1,
                 padding=1, dilation=1, margin: float = 1e-3) -> torch.Tensor:
    """(B, Ho, Wo, 2K) bool: the tap's sampling position lies more than
    ``margin`` pixels from every cell edge (both entries of a tap alike).

    d_offset jumps across cell edges, and a bf16 offset often puts a tap
    exactly on one; the kernels and the grid_sample plain version round the
    position differently, so comparisons of d_offset are made on interior
    taps only.
    """
    B, Ho, Wo, _ = offset.shape
    Kh, Kw = kernel_size
    dev = offset.device
    off = offset.double().reshape(B, Ho, Wo, Kh * Kw, 2)
    ky, kx = torch.meshgrid(torch.arange(Kh, device=dev),
                            torch.arange(Kw, device=dev), indexing="ij")
    sy = (torch.arange(Ho, device=dev)[:, None, None] * stride - padding
          + ky.reshape(-1) * dilation) + off[..., 0]
    sx = (torch.arange(Wo, device=dev)[:, None] * stride - padding
          + kx.reshape(-1) * dilation) + off[..., 1]
    inside = ((sy - sy.round()).abs() > margin) & ((sx - sx.round()).abs() > margin)
    return inside[..., None].expand(B, Ho, Wo, Kh * Kw, 2).reshape(B, Ho, Wo, -1)


def deform_im2col_backward_reference(x, offset, mask, d_cols,
                                     kernel_size=(3, 3), stride=1, padding=1,
                                     dilation=1):
    """Plain version of the im2col's backward: autograd through
    :func:`deform_im2col_reference`.  Returns (d_x, d_offset, d_mask)."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_() for t in (x, offset, mask)]
        cols = deform_im2col_reference(*inputs, kernel_size, stride, padding,
                                       dilation)
        return torch.autograd.grad(cols, inputs, d_cols)


def deform_im2col_backward(x, offset, mask, d_cols, kernel_size=(3, 3),
                           stride=1, padding=1, dilation=1):
    """(d_x, d_offset, d_mask) of :func:`deform_im2col` for ``d_cols``
    (B*Ho*Wo, K*Cin); CPU tensors take the plain version, CUDA tensors
    kernel K4.  All three in x's dtype."""
    if x.device.type == "cpu":
        return deform_im2col_backward_reference(x, offset, mask, d_cols,
                                                kernel_size, stride, padding,
                                                dilation)
    return _dcn_bwd_cuda(x, offset, mask, d_cols, tuple(kernel_size), stride,
                         padding, dilation)


def _check(x, offset, mask, kernel_size, stride, padding, dilation):
    """Validate the kernels' inputs; returns (B, H, W, Cin, Ho, Wo) and the
    dtype code."""
    tensors = (x, offset, mask)
    if any(t.device != x.device for t in tensors) or x.device.type != "cuda":
        raise ValueError("deform_im2col: all tensors must be on one CUDA device")
    if x.device.index != torch.cuda.current_device():
        raise ValueError("deform_im2col: tensors are not on the current device")
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, Cin), got {tuple(x.shape)}")
    B, H, W, Cin = x.shape
    Kh, Kw = kernel_size
    K = Kh * Kw
    Ho = _out_size(H, Kh, stride, padding, dilation)
    Wo = _out_size(W, Kw, stride, padding, dilation)
    if tuple(offset.shape) != (B, Ho, Wo, 2 * K):
        raise ValueError(f"offset must be {(B, Ho, Wo, 2 * K)}, got {tuple(offset.shape)}")
    if tuple(mask.shape) != (B, Ho, Wo, K):
        raise ValueError(f"mask must be {(B, Ho, Wo, K)}, got {tuple(mask.shape)}")
    code = _build.dtype_code(x.dtype)
    if offset.dtype != x.dtype or mask.dtype != x.dtype:
        raise TypeError("deform_im2col: offset and mask must have x's dtype")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("deform_im2col: the kernel takes contiguous tensors")
    return (B, H, W, Cin, Ho, Wo), code


def _im2col_cuda(x, offset, mask, kernel_size, stride, padding, dilation):
    (B, H, W, Cin, Ho, Wo), code = _check(x, offset, mask, kernel_size,
                                          stride, padding, dilation)
    Kh, Kw = kernel_size
    cols = torch.empty((B * Ho * Wo, Kh * Kw * Cin), dtype=x.dtype,
                       device=x.device)
    err = _build.lib().unibev_dcn_im2col(
        x.data_ptr(), offset.data_ptr(), mask.data_ptr(), cols.data_ptr(),
        B, H, W, Cin, Ho, Wo, Kh, Kw, stride, padding, dilation, code,
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "dcn_im2col")
    _build.launches["dcn_im2col"] += 1
    return cols


# per device: dcn_fwd's arrival counts, one int32 per tile, zero between
# launches (the last block to finish a shared tile sets its count back);
# launches that share them run one after another, as on the port's one
# stream
_ARRIVALS: dict = {}


def _arrivals(device, tiles):
    counts = _ARRIVALS.get(device)
    if counts is None or counts.numel() < tiles:
        counts = torch.zeros(max(tiles, 1024), dtype=torch.int32, device=device)
        _ARRIVALS[device] = counts
    return counts


def _dcn_fwd_cuda(x, offset, mask, weight, kernel_size, stride, padding,
                  dilation):
    (B, H, W, Cin, Ho, Wo), code = _check(x, offset, mask, kernel_size,
                                          stride, padding, dilation)
    Kh, Kw = kernel_size
    K = Kh * Kw
    if weight.dim() != 2 or weight.shape[0] != K * Cin:
        raise ValueError(f"weight must be ({K * Cin}, Cout), got {tuple(weight.shape)}")
    if weight.dtype != x.dtype or weight.device != x.device:
        raise TypeError("dcn_fwd: weight must have x's dtype and device")
    Cout = weight.shape[1]
    plan = dcn_fwd_plan(Cin, Cout, K, x.element_size())
    # the kernel reads the weight K-major by TMA, one row per output channel
    # with each tap's input channels padded to whole stages: no copy when
    # the caller holds it that way (DeformConv2d) and Cin needs no padding
    cin_pad = plan.chunks * plan.kc
    wt = weight.t()
    if cin_pad != Cin:
        wt = F.pad(wt.reshape(Cout, K, Cin), (0, cin_pad - Cin))
    wt = wt.contiguous()
    out = torch.empty((B, Ho, Wo, Cout), dtype=x.dtype, device=x.device)
    # at most one block per SM; two slots of f32 tile sums per block for the
    # tiles that blocks share
    blocks = _build.sm_count(x.device.index)
    partial = torch.empty((2 * blocks, plan.rows * plan.bn),
                          dtype=torch.float32, device=x.device)
    tiles = -(-(B * Ho * Wo) // plan.rows) * plan.channel_tiles
    err = _build.lib().unibev_dcn_fwd(
        x.data_ptr(), offset.data_ptr(), mask.data_ptr(), wt.data_ptr(),
        out.data_ptr(), partial.data_ptr(),
        _arrivals(x.device, tiles).data_ptr(), blocks, B, H, W, Cin, cin_pad,
        Ho, Wo, Cout, Kh, Kw, stride, padding, dilation, plan.smem_bytes,
        code, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "dcn_fwd")
    _build.launches["dcn_fwd"] += 1
    return out


def dcn_fwd(x, offset, mask, weight, kernel_size=(3, 3), stride=1, padding=1,
            dilation=1) -> torch.Tensor:
    """The DCNv2 forward without bias and autograd: CPU tensors take the
    plain version (:func:`modulated_deform_conv2d_reference`), CUDA tensors
    the fused kernel ``dcn_fwd``.  weight (K*Cin, Cout) tap-major, in x's
    dtype; returns (B, Ho, Wo, Cout) in x's dtype."""
    if x.device.type == "cpu":
        return modulated_deform_conv2d_reference(x, offset, mask, weight, None,
                                                 kernel_size, stride, padding,
                                                 dilation)
    return _dcn_fwd_cuda(x, offset, mask, weight, tuple(kernel_size), stride,
                         padding, dilation)


def _dcn_bwd_cuda(x, offset, mask, d_cols, kernel_size, stride, padding,
                  dilation):
    (B, H, W, Cin, Ho, Wo), code = _check(x, offset, mask, kernel_size,
                                          stride, padding, dilation)
    Kh, Kw = kernel_size
    K = Kh * Kw
    N = B * Ho * Wo
    if d_cols.shape != (N, K * Cin):
        raise ValueError(f"d_cols must be {(N, K * Cin)}, got {tuple(d_cols.shape)}")
    d_cols = d_cols.to(x.dtype).contiguous()
    d_offset = torch.empty_like(offset)
    d_mask = torch.empty_like(mask)
    table = torch.zeros((B * H * W, Cin), dtype=torch.float32, device=x.device)
    size = x.element_size()
    plan = dcn_bwd_plan(B, H, W, Cin, Ho, Wo, K, size, x.data_ptr(),
                        d_cols.data_ptr())
    err = _build.lib().unibev_dcn_bwd(
        x.data_ptr(), offset.data_ptr(), mask.data_ptr(), d_cols.data_ptr(),
        d_offset.data_ptr(), d_mask.data_ptr(), table.data_ptr(), B, H, W, Cin,
        Ho, Wo, Kh, Kw, stride, padding, dilation, code, plan.vec_bytes // size,
        plan.lanes, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "dcn_bwd")
    _build.launches["dcn_bwd"] += 1
    d_x = table.view(B, H, W, Cin).to(x.dtype)
    return d_x, d_offset, d_mask


class _DCNFunction(torch.autograd.Function):
    """``dcn_fwd`` forward; im2col + matmuls + K4 backward
    (``_mdcn_fast_bwd``).  Nothing sampled is saved: the backward rebuilds
    the columns for d_weight, as the JAX package's backward recomputes its
    gather.  Under the backbone's checkpointing the recompute runs
    ``dcn_fwd`` once more."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, x, offset, mask, weight, kernel_size, stride, padding,
                dilation):
        ctx.geometry = (kernel_size, stride, padding, dilation)
        ctx.save_for_backward(x, offset, mask, weight)
        return _dcn_fwd_cuda(x, offset, mask, weight, kernel_size, stride,
                             padding, dilation)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, grad_out):
        x, offset, mask, weight = ctx.saved_tensors
        cols = _im2col_cuda(x, offset, mask, *ctx.geometry)
        g = grad_out.reshape(cols.shape[0], -1).to(cols.dtype)
        d_cols = torch.matmul(g, weight.t())
        d_weight = torch.matmul(cols.t(), g)
        del cols
        d_x, d_offset, d_mask = _dcn_bwd_cuda(x, offset, mask, d_cols,
                                              *ctx.geometry)
        return d_x, d_offset, d_mask, d_weight, None, None, None, None


def _conv_from_cols(cols, weight, bias, shape):
    B, Ho, Wo = shape
    out = torch.matmul(cols, weight.to(cols.dtype))
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out.view(B, Ho, Wo, -1)


def modulated_deform_conv2d(x: torch.Tensor, offset: torch.Tensor,
                            mask: torch.Tensor, weight: torch.Tensor,
                            bias: Optional[torch.Tensor] = None,
                            kernel_size: Tuple[int, int] = (3, 3),
                            stride: int = 1, padding: int = 1,
                            dilation: int = 1) -> torch.Tensor:
    """NHWC modulated deformable conv (the JAX package's layouts).

    x (B, H, W, Cin); offset (B, Ho, Wo, 2*Kh*Kw) with (dy, dx) per tap;
    mask (B, Ho, Wo, Kh*Kw), already sigmoid-ed; weight (Kh*Kw*Cin, Cout)
    tap-major; bias (Cout,) or None.  Returns (B, Ho, Wo, Cout).  On CPU
    tensors the plain versions run (and autograd goes through them); on CUDA
    the fused kernel ``dcn_fwd``, with the im2col + K4 backward.
    """
    if x.device.type == "cpu":
        cols = deform_im2col_reference(x, offset, mask, kernel_size, stride,
                                       padding, dilation)
        return _conv_from_cols(cols, weight, bias, offset.shape[:3])
    out = _DCNFunction.apply(x, offset, mask, weight.to(x.dtype),
                             tuple(kernel_size), stride, padding, dilation)
    return out if bias is None else out + bias.to(out.dtype)


def modulated_deform_conv2d_reference(x, offset, mask, weight, bias=None,
                                      kernel_size=(3, 3), stride=1, padding=1,
                                      dilation=1) -> torch.Tensor:
    """Plain version of :func:`modulated_deform_conv2d`, in float32.

    Independent of the JAX package's corner-table code: each tap is a
    ``grid_sample`` of x at the offset positions.  Returns x's dtype.
    """
    cols = _im2col_f32(x, offset, mask, kernel_size, stride, padding, dilation)
    out = _conv_from_cols(cols, weight.float(),
                          None if bias is None else bias.float(),
                          offset.shape[:3])
    return out.to(x.dtype)
