"""Modulated deformable convolution (DCNv2): kernel wrapper and plain version.

Counterpart of ``unibev_tpu/ops/deform_conv.py::modulated_deform_conv2d``
(semantics from its ``_mdcn_clean``).  The deformable im2col runs in the CUDA
kernel K2 (``csrc/deform_conv.cu::unibev_dcn_im2col``); the (K*Cin) x Cout
product after it is a plain ``torch.matmul``, as the JAX package left it to
XLA.

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


def _im2col_cuda(x, offset, mask, kernel_size, stride, padding, dilation):
    tensors = (x, offset, mask)
    if any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "deform_im2col: the CUDA kernel is forward-only (inference)")
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

    cols = torch.empty((B * Ho * Wo, K * Cin), dtype=x.dtype, device=x.device)
    err = _build.lib().unibev_dcn_im2col(
        x.data_ptr(), offset.data_ptr(), mask.data_ptr(), cols.data_ptr(),
        B, H, W, Cin, Ho, Wo, Kh, Kw, stride, padding, dilation, code,
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "dcn_im2col")
    _build.launches["dcn_im2col"] += 1
    return cols


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
    tap-major; bias (Cout,) or None.  Returns (B, Ho, Wo, Cout).
    """
    cols = deform_im2col(x, offset, mask, kernel_size, stride, padding,
                         dilation)
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
