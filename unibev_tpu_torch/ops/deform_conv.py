"""Modulated deformable convolution (DCNv2): kernel wrappers and plain versions.

Counterpart of ``unibev_tpu/ops/deform_conv.py::modulated_deform_conv2d``
(semantics from its ``_mdcn_clean``).  The deformable im2col runs in the CUDA
kernel K2 (``csrc/deform_conv.cu::unibev_dcn_im2col``); the (K*Cin) x Cout
product after it is a plain ``torch.matmul``, as the JAX package left it to
XLA.  The gradient follows ``_mdcn_fast_bwd``: d_cols = g W^T and d_weight =
cols^T g are ``torch.matmul``; kernel K4 (``csrc/deform_conv.cu::
unibev_dcn_bwd``) turns d_cols into d_offset, d_mask and the d_x
contribution rows, which the row scatter-add K5 (``ops/scatter.py``) sums,
in chunks of output pixels.

Each kernel tap moves to a fractional position ``(ho*stride - pad + ky*dil +
dy, wo*stride - pad + kx*dil + dx)``, is sampled bilinearly with zero
padding, and is scaled by its (already sigmoid-ed) mask.  The offset layout
is mmcv's: ``offset[..., 2k] = dy_k``, ``offset[..., 2k+1] = dx_k``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from unibev_tpu_torch.ops import _build
from unibev_tpu_torch.ops.scatter import bwd_chunks, scatter_add_rows


def _out_size(size, k, stride, padding, dilation):
    return (size + 2 * padding - dilation * (k - 1) - 1) // stride + 1


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
    """Deformable im2col; CPU tensors take the plain version, CUDA tensors
    kernel K2.  Same layouts as :func:`deform_im2col_reference`."""
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
    kernels K4 and K5.  All three in x's dtype."""
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
    tr = B * H * W
    table = torch.zeros((tr, Cin), dtype=torch.float32, device=x.device)
    rows_per_pixel = K * 4                  # one row per (tap, corner)
    chunks = bwd_chunks(N, rows_per_pixel * Cin * x.element_size())
    most = max(n for _, n in chunks) * rows_per_pixel
    contrib = torch.empty((most, Cin), dtype=x.dtype, device=x.device)
    idx = torch.empty((most,), dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream().cuda_stream
    for n0, n in chunks:
        err = _build.lib().unibev_dcn_bwd(
            x.data_ptr(), offset.data_ptr(), mask.data_ptr(), d_cols.data_ptr(),
            d_offset.data_ptr(), d_mask.data_ptr(), contrib.data_ptr(),
            idx.data_ptr(), B, H, W, Cin, Ho, Wo, Kh, Kw, stride, padding,
            dilation, n0, n, code, stream)
        _build.check(err, "dcn_bwd")
        _build.launches["dcn_bwd"] += 1
        m = n * rows_per_pixel
        scatter_add_rows(idx[:m], contrib[:m], tr, out=table)
    d_x = table.view(B, H, W, Cin).to(x.dtype)
    return d_x, d_offset, d_mask


class _DCNFunction(torch.autograd.Function):
    """K2 + matmul forward; matmuls + K4 + K5 backward (``_mdcn_fast_bwd``).
    The columns are saved for d_weight; under the backbone's checkpointing
    they are dropped after the forward and rebuilt (K2 again) by the
    recompute, as the JAX package recomputes them with its remat."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, x, offset, mask, weight, kernel_size, stride, padding,
                dilation):
        cols = _im2col_cuda(x, offset, mask, kernel_size, stride, padding,
                            dilation)
        ctx.geometry = (kernel_size, stride, padding, dilation)
        ctx.save_for_backward(x, offset, mask, weight, cols)
        B, Ho, Wo = offset.shape[:3]
        return torch.matmul(cols, weight).view(B, Ho, Wo, -1)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, grad_out):
        x, offset, mask, weight, cols = ctx.saved_tensors
        g = grad_out.reshape(cols.shape[0], -1).to(cols.dtype)
        d_cols = torch.matmul(g, weight.t())
        d_weight = torch.matmul(cols.t(), g)
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
    kernel K2, with the K4 + K5 backward.
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
