"""Multi-scale deformable attention (MSDA): kernel wrappers and plain versions.

Counterpart of ``unibev_tpu/ops/msda.py::ms_deform_attn`` and of the Pallas
kernel ``unibev_tpu/ops/msda_pallas.py::ms_deform_attn_smallv``.  Both JAX
routes compute one function, which the CUDA kernel K1
(``csrc/msda.cu::unibev_msda_fwd``) computes for every call site of the slice:
temporal self-attention and decoder cross-attention over the 200x200 BEV map,
and the camera cross-attention over the small per-camera maps.

K1 reads 16 bytes per corner where D and value's alignment allow;
:func:`msda_fwd_route` picks the access width per call.

The gradient is a ``torch.autograd.Function`` whose backward is kernel K3
(``csrc/msda.cu::unibev_msda_bwd``), one launch per call: it writes d_attn
and d_loc and adds d_value straight into a float32 table with vector
reductions, where ``_slab_level_op2_bwd`` of the JAX package writes
contribution rows in chunks of queries and scatter-adds them.
:func:`msda_bwd_plan` is its launch plan.

Semantics are the reference's ``multi_scale_deformable_attn_pytorch``:
locations in [0, 1] over each level's (W, H), bilinear sampling with
grid_sample ``align_corners=False`` (pixel = loc * size - 0.5), zero padding,
and ``out[q] = sum_{level, point} attn * sample``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


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


def cell_interior(sampling_locations: torch.Tensor,
                  spatial_shapes: Sequence[Tuple[int, int]],
                  margin: float = 1e-3) -> torch.Tensor:
    """(B, Q, heads, L, P, 1) bool: the point lies more than ``margin``
    pixels from every cell edge of its level.

    The bilinear gradient d_loc jumps across cell edges.  Two correct
    implementations that round the pixel coordinate differently (the kernels
    compute ``loc * W - 0.5``, grid_sample ``((2 loc - 1 + 1) * W - 1) / 2``)
    can put a point that lies on an edge on either side, so comparisons of
    d_loc are made on interior points only.
    """
    size = torch.tensor([[w, h] for h, w in spatial_shapes], dtype=torch.float64,
                        device=sampling_locations.device)         # (L, 2)
    pix = sampling_locations.double() * size[:, None, :] - 0.5
    return ((pix - pix.round()).abs() > margin).all(-1, keepdim=True)


def ms_deform_attn_backward_reference(value, spatial_shapes, sampling_locations,
                                      attention_weights, grad_out):
    """Plain version of the backward: autograd through
    :func:`ms_deform_attn_reference`.  Returns (d_value, d_loc, d_attn)."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_()
                  for t in (value, sampling_locations, attention_weights)]
        out = ms_deform_attn_reference(inputs[0], spatial_shapes, inputs[1],
                                       inputs[2])
        return torch.autograd.grad(out, inputs, grad_out)


def ms_deform_attn(value: torch.Tensor,
                   spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    """MSDA forward; CPU tensors take the plain version, CUDA tensors kernel
    K1, with the K3 backward.

    Same layouts as :func:`ms_deform_attn_reference`.  On CUDA the kernels
    take value in bfloat16 or float32, locations in float32 and attention
    weights in value's dtype, all contiguous; anything else raises.
    """
    return ms_deform_attn_reference(value, spatial_shapes,
                                    sampling_locations, attention_weights)


def ms_deform_attn_backward(value, spatial_shapes, sampling_locations,
                            attention_weights, grad_out):
    """(d_value, d_loc, d_attn) of :func:`ms_deform_attn` for ``grad_out``
    (B, Q, heads * D); CPU tensors take the plain version, CUDA tensors
    kernel K3.  d_loc is float32, the others in their input's dtype."""
    return ms_deform_attn_backward_reference(
        value, spatial_shapes, sampling_locations, attention_weights,
        grad_out)


