"""Modulated deformable convolution (DCNv2): kernel wrappers and plain versions.

Counterpart of ``unibev_tpu/ops/deform_conv.py::modulated_deform_conv2d``
(semantics from its ``_mdcn_clean``).  The forward is one fused CUDA kernel,
``dcn_fwd`` (``csrc/deform_conv.cu::unibev_dcn_fwd``): it samples the
deformable columns into shared memory and multiplies them there, so the
(B*Ho*Wo, K*Cin) column matrix never reaches device memory;
:func:`dcn_fwd_plan` is its launch plan.  The gradient follows
``_mdcn_fast_bwd``, which recomputes the gather: the im2col kernel
(``unibev_dcn_im2col``; :func:`im2col_plan` is its launch plan) writes the
columns for d_weight = cols^T g; d_cols = g W^T and d_weight are
``torch.matmul``; kernel K4 (``csrc/deform_conv.cu::unibev_dcn_bwd``), one
launch per layer, turns d_cols into d_offset and d_mask and adds d_x
straight into a float32 table with vector reductions; :func:`dcn_bwd_plan`
is its launch plan.

Each kernel tap moves to a fractional position ``(ho*stride - pad + ky*dil +
dy, wo*stride - pad + kx*dil + dx)``, is sampled bilinearly with zero
padding, and is scaled by its (already sigmoid-ed) mask.  The offset layout
is mmcv's: ``offset[..., 2k] = dy_k``, ``offset[..., 2k+1] = dx_k``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F


def _out_size(size, k, stride, padding, dilation):
    return (size + 2 * padding - dilation * (k - 1) - 1) // stride + 1


# dcn_fwd's square tile (output pixels, output channels, items in its
# shared-memory ring) and its wide tile for 256 < Cout <= 512; threads (16
# warps), the bytes of a staged row
DCN_FWD_TILE = (128, 256, 3)
DCN_FWD_WIDE_TILE = (64, 512, 2)
DCN_FWD_WARPS = 16
DCN_FWD_ROW_BYTES = 128


# dcn_im2col: threads a block, the vectors a thread writes a tile (the
# plan's aim), the most output pixels a tile, shared memory per (pixel,
# tap) of geometry (a float4 of corner weights and an int32 row) and the
# most of it (csrc/deform_conv.cu, kCol*)
IM2COL_THREADS = 256
IM2COL_UNITS = 16
IM2COL_MAX_PIXELS = 128
IM2COL_GEO_BYTES = 20
IM2COL_MAX_SMEM = 48 * 1024


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
    return deform_im2col_reference(x, offset, mask, kernel_size, stride,
                                   padding, dilation)


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
    return deform_im2col_backward_reference(x, offset, mask, d_cols,
                                            kernel_size, stride, padding,
                                            dilation)


# per device: dcn_fwd's arrival counts, one int32 per tile, zero between
# launches (the last block to finish a shared tile sets its count back);
# launches that share them run one after another, as on the port's one
# stream
_ARRIVALS: dict = {}


def dcn_fwd(x, offset, mask, weight, kernel_size=(3, 3), stride=1, padding=1,
            dilation=1) -> torch.Tensor:
    """The DCNv2 forward without bias and autograd: CPU tensors take the
    plain version (:func:`modulated_deform_conv2d_reference`), CUDA tensors
    the fused kernel ``dcn_fwd``.  weight (K*Cin, Cout) tap-major, in x's
    dtype; returns (B, Ho, Wo, Cout) in x's dtype."""
    return modulated_deform_conv2d_reference(x, offset, mask, weight, None,
                                             kernel_size, stride, padding,
                                             dilation)


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
    cols = deform_im2col_reference(x, offset, mask, kernel_size, stride,
                                   padding, dilation)
    return _conv_from_cols(cols, weight, bias, offset.shape[:3])


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
