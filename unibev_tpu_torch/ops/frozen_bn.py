"""Frozen BatchNorm fused with its ReLU and residual add: kernel wrapper and
plain version.

The camera backbone's frozen BNs (``models/backbones/resnet.py``) each end
in one pass over the activation, in one of three forms:

- (a) ``relu(x * s + t)``: the stem, and each bottleneck's bn1 and bn2;
- (b) ``relu(x * s + t + r)``: bn3 with the identity residual r;
- (c) ``relu(x * s + t + (d * sd + td))``: bn3 with the downsample branch's
  raw convolution d and its frozen BN (sd, td).

Per channel, ``s = w * rsqrt(var + eps)`` and ``t = b - mean * s`` in float32
from the BN's own four buffers (:func:`bn_affine`, FrozenBatchNorm's
formula), on every call: nothing is cached and nothing is folded into a
convolution's weights, so loading a state dict needs no invalidation.  The
pass runs in float32 and rounds to x's dtype once.

The JAX package has no kernel here: its ResNet writes the same arithmetic
as jnp ops, which XLA fuses into one loop.  On CUDA, :func:`frozen_bn_act`
launches kernel K13 (``csrc/frozen_bn_act.cu::unibev_frozen_bn_act``), one
launch a site, counted as ``_build.launches["frozen_bn_act"]``; CPU tensors
take the plain version, :func:`frozen_bn_act_reference`.  The gradient is a
``torch.autograd.Function`` whose backward is plain PyTorch from the saved
output: ``dz = g * [y > 0]``, ``dx = dz * s``, ``dr = dz``, ``dd = dz * sd``;
the buffers take none.
"""

from __future__ import annotations

from typing import Optional

import torch

from unibev_tpu_torch.ops import _build
from unibev_tpu_torch.utils.timer import spanned


def bn_affine(bn):
    """(s, t) of a frozen BN in float32: ``s = w * rsqrt(var + eps)``,
    ``t = b - mean * s``.  ``bn`` has FrozenBatchNorm's buffers (weight,
    bias, running_mean, running_var) and ``eps``."""
    s = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
    return s, bn.bias.float() - bn.running_mean.float() * s


def _channels(v):
    return v[:, None, None]


def frozen_bn_act_reference(x: torch.Tensor, bn,
                            residual: Optional[torch.Tensor] = None,
                            down: Optional[torch.Tensor] = None,
                            down_bn=None) -> torch.Tensor:
    """Plain version: form (a), (b) with ``residual`` or (c) with ``down``
    and ``down_bn``, on (B, C, H, W) tensors of one dtype, in float32 in
    K13's order, rounded once to x's dtype."""
    s, t = bn_affine(bn)
    z = x.float() * _channels(s) + _channels(t)
    if residual is not None:
        z = z + residual.float()
    if down is not None:
        sd, td = bn_affine(down_bn)
        z = z + (down.float() * _channels(sd) + _channels(td))
    return torch.relu(z).to(x.dtype)


def frozen_bn_act(x: torch.Tensor, bn, residual: Optional[torch.Tensor] = None,
                  down: Optional[torch.Tensor] = None,
                  down_bn=None) -> torch.Tensor:
    """``relu(bn(x) [+ residual] [+ down_bn(down)])`` in one pass; CPU
    tensors take the plain version, CUDA tensors kernel K13.

    x, and residual or down where given (not both), are (B, C, H, W) of one
    dtype, float32 or bfloat16.  On CUDA the kernel takes them
    channels_last-contiguous with C a multiple of 8, and the BNs' buffers
    contiguous (C,) vectors of one dtype, float32 or bfloat16, on x's
    device; anything else raises.  Differentiable in x, residual and down.
    """
    if residual is not None and down is not None:
        raise ValueError("frozen_bn_act: a residual or a downsample branch, "
                         "not both")
    if down is not None and down_bn is None:
        raise ValueError("frozen_bn_act: down needs down_bn")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, residual, down)):
        return _FrozenBnActFunction.apply(x, residual, down, bn, down_bn)
    return _forward(x, bn, residual, down, down_bn)


def _forward(x, bn, residual, down, down_bn):
    if x.device.type == "cpu":
        return frozen_bn_act_reference(x, bn, residual, down, down_bn)
    return _frozen_bn_act_cuda(x, bn, residual, down, down_bn)


class _FrozenBnActFunction(torch.autograd.Function):
    """K13 (or, on the CPU, the plain version) forward; a plain backward
    from the output, the only tensor saved."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, x, residual, down, bn, down_bn):
        y = _forward(x, bn, residual, down, down_bn)
        ctx.bns = (bn, down_bn)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, g):
        y, = ctx.saved_tensors
        bn, down_bn = ctx.bns
        need_x, need_r, need_d = ctx.needs_input_grad[:3]
        dz = torch.where(y > 0, g, 0)
        dx = dr = dd = None
        if need_x:
            dx = (dz.float() * _channels(bn_affine(bn)[0])).to(y.dtype)
        if need_r:
            dr = dz
        if need_d:
            dd = (dz.float() * _channels(bn_affine(down_bn)[0])).to(y.dtype)
        return dx, dr, dd, None, None


def _buffers(bn, C, dtype, device):
    """The four buffers of ``bn`` and its eps, checked for K13."""
    bufs = (bn.weight, bn.bias, bn.running_mean, bn.running_var)
    for b in bufs:
        if b.shape != (C,) or b.dtype != dtype or b.device != device \
                or not b.is_contiguous():
            raise ValueError(f"frozen_bn_act: BN buffers must be contiguous "
                             f"({C},) {dtype} on {device}, got "
                             f"{tuple(b.shape)} {b.dtype} on {b.device}")
    return [b.data_ptr() for b in bufs] + [float(bn.eps)]


@spanned("kernel:frozen_bn_act")
def _frozen_bn_act_cuda(x, bn, residual, down, down_bn):
    if x.dim() != 4:
        raise ValueError(f"frozen_bn_act: x must be (B, C, H, W), got "
                         f"{tuple(x.shape)}")
    device = x.device
    if device.index != torch.cuda.current_device():
        raise ValueError("frozen_bn_act: tensors are not on the current device")
    code = _build.dtype_code(x.dtype)
    C = x.shape[1]
    if C % 8:
        raise ValueError(f"frozen_bn_act: C must be a multiple of 8, got {C}")
    other = residual if residual is not None else down
    for t in (x,) if other is None else (x, other):
        if not t.is_contiguous(memory_format=torch.channels_last):
            raise ValueError("frozen_bn_act: the kernel takes channels_last "
                             "tensors")
    if other is not None and (other.shape != x.shape or other.dtype != x.dtype
                              or other.device != device):
        raise ValueError(f"frozen_bn_act: the residual or downsample branch "
                         f"must match x {tuple(x.shape)} {x.dtype}, got "
                         f"{tuple(other.shape)} {other.dtype} on {other.device}")
    buf_dtype = bn.weight.dtype
    buf_code = _build.dtype_code(buf_dtype)
    bufs = _buffers(bn, C, buf_dtype, device)
    bufs_d = (_buffers(down_bn, C, buf_dtype, device) if down is not None
              else [None] * 4 + [0.0])
    form = 0 if other is None else 1 if residual is not None else 2
    out = torch.empty_like(x)
    ptr = other.data_ptr() if other is not None else None
    err = _build.lib().unibev_frozen_bn_act(
        x.data_ptr(), ptr if form == 1 else None, ptr if form == 2 else None,
        out.data_ptr(), *bufs, *bufs_d, x.numel(), C, form, code, buf_code,
        _build.sm_count(device.index), _build.raw_stream(device.index))
    _build.check(err, "frozen_bn_act")
    _build.launches["frozen_bn_act"] += 1
    return out
