"""Multi-scale deformable attention (MSDA): kernel wrapper and plain version.

Counterpart of ``unibev_tpu/ops/msda.py::ms_deform_attn`` and of the Pallas
kernel ``unibev_tpu/ops/msda_pallas.py::ms_deform_attn_smallv``.  Both JAX
routes compute one function, which the CUDA kernel K1
(``csrc/msda.cu::unibev_msda_fwd``) computes for every call site of the slice:
temporal self-attention and decoder cross-attention over the 200x200 BEV map,
and the camera cross-attention over the small per-camera maps.

Semantics are the reference's ``multi_scale_deformable_attn_pytorch``:
locations in [0, 1] over each level's (W, H), bilinear sampling with
grid_sample ``align_corners=False`` (pixel = loc * size - 0.5), zero padding,
and ``out[q] = sum_{level, point} attn * sample``.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from unibev_tpu_torch.ops import _build

MAX_LEVELS = 8   # csrc/msda.cu kMaxLevels


def ms_deform_attn_reference(value: torch.Tensor,
                             spatial_shapes: Sequence[Tuple[int, int]],
                             sampling_locations: torch.Tensor,
                             attention_weights: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: one ``F.grid_sample`` per level, in float32.

    value (B, V, heads, D); sampling_locations (B, Q, heads, L, P, 2) in
    [0, 1], xy order; attention_weights (B, Q, heads, L, P).
    Returns (B, Q, heads * D) in value's dtype.
    """
    B, _, heads, D = value.shape
    _, Q, _, L, P, _ = sampling_locations.shape
    values = value.float().split([h * w for h, w in spatial_shapes], dim=1)
    grids = 2 * sampling_locations.float() - 1
    sampled = []
    for lvl, (H, W) in enumerate(spatial_shapes):
        v = values[lvl].flatten(2).transpose(1, 2).reshape(B * heads, D, H, W)
        g = grids[:, :, :, lvl].transpose(1, 2).flatten(0, 1)   # (B*heads, Q, P, 2)
        sampled.append(F.grid_sample(v, g, mode="bilinear",
                                     padding_mode="zeros",
                                     align_corners=False))      # (B*heads, D, Q, P)
    attn = attention_weights.float().transpose(1, 2).reshape(
        B * heads, 1, Q, L * P)
    out = (torch.stack(sampled, dim=-2).flatten(-2) * attn).sum(-1)
    out = out.view(B, heads * D, Q).transpose(1, 2).contiguous()
    return out.to(value.dtype)


def ms_deform_attn(value: torch.Tensor,
                   spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    """MSDA forward; CPU tensors take the plain version, CUDA tensors kernel K1.

    Same layouts as :func:`ms_deform_attn_reference`.  On CUDA the kernel
    takes value in bfloat16 or float32, locations in float32 and attention
    weights in value's dtype, all contiguous; anything else raises.
    """
    if value.device.type == "cpu":
        return ms_deform_attn_reference(value, spatial_shapes,
                                        sampling_locations, attention_weights)
    return _msda_cuda(value, tuple(tuple(s) for s in spatial_shapes),
                      sampling_locations, attention_weights)


def _msda_cuda(value, spatial_shapes, loc, attn):
    tensors = (value, loc, attn)
    if any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "ms_deform_attn: the CUDA kernel is forward-only (inference)")
    if any(t.device != value.device for t in tensors) or value.device.type != "cuda":
        raise ValueError("ms_deform_attn: all tensors must be on one CUDA device")
    if value.device.index != torch.cuda.current_device():
        raise ValueError("ms_deform_attn: tensors are not on the current device")
    if value.dim() != 4:
        raise ValueError(f"value must be (B, V, heads, D), got {tuple(value.shape)}")
    B, V, heads, D = value.shape
    L = len(spatial_shapes)
    if not 1 <= L <= MAX_LEVELS:
        raise ValueError(f"ms_deform_attn: 1..{MAX_LEVELS} levels, got {L}")
    if loc.dim() != 6 or tuple(loc.shape[:4]) != (B, loc.shape[1], heads, L) \
            or loc.shape[-1] != 2:
        raise ValueError(f"sampling_locations must be (B, Q, heads, L, P, 2), "
                         f"got {tuple(loc.shape)}")
    Q, P = loc.shape[1], loc.shape[4]
    if tuple(attn.shape) != (B, Q, heads, L, P):
        raise ValueError(f"attention_weights must be {(B, Q, heads, L, P)}, "
                         f"got {tuple(attn.shape)}")
    if sum(h * w for h, w in spatial_shapes) != V:
        raise ValueError(f"spatial_shapes {spatial_shapes} do not sum to V={V}")
    code = _build.dtype_code(value.dtype)
    if loc.dtype != torch.float32:
        raise TypeError(f"sampling_locations must be float32, got {loc.dtype}")
    if attn.dtype != value.dtype:
        raise TypeError(f"attention_weights must be {value.dtype}, got {attn.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ms_deform_attn: the kernel takes contiguous tensors")

    starts = [0]
    for h, w in spatial_shapes[:-1]:
        starts.append(starts[-1] + h * w)
    shapes = (ctypes.c_int * (3 * L))(
        *[v for (h, w), s in zip(spatial_shapes, starts) for v in (h, w, s)])
    out = torch.empty((B, Q, heads * D), dtype=value.dtype, device=value.device)
    err = _build.lib().unibev_msda_fwd(
        value.data_ptr(), loc.data_ptr(), attn.data_ptr(), out.data_ptr(),
        B, V, Q, heads, D, L, P, ctypes.addressof(shapes), code,
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "msda_fwd")
    _build.launches["msda_fwd"] += 1
    return out
