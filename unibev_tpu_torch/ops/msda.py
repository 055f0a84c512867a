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

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from unibev_tpu_torch.ops import _build
from unibev_tpu_torch.utils.timer import spanned

MAX_LEVELS = 8   # csrc/msda.cu kMaxLevels


def msda_fwd_route(D: int, itemsize: int, address: int = 0) -> int:
    """K1's access width in bytes for one call: the widest of 16, 8 and 4
    bytes that divides a head's D-wide row and ``address`` (value's data
    pointer), else one element."""
    return _build.access_width(D * itemsize, itemsize, address)


def msda_bwd_plan(B: int, V: int, Q: int, heads: int, D: int, itemsize: int,
                  value_address: int = 0,
                  grad_address: int = 0) -> _build.BwdPlan:
    """K3's launch plan (:func:`_build.bwd_plan`): items (b, q, head) of D
    channels, value's and grad's addresses, two chunks a lane where a row
    has two (4 threads of 2 x 4 bf16 channels at D = 32)."""
    return _build.bwd_plan(B * Q * heads, D, itemsize,
                           (value_address, grad_address), B * V * heads * D,
                           chunks_per_lane=2)


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
    if value.device.type == "cpu":
        return ms_deform_attn_reference(value, spatial_shapes,
                                        sampling_locations, attention_weights)
    return _MSDAFunction.apply(value, tuple(tuple(s) for s in spatial_shapes),
                               sampling_locations, attention_weights)


def ms_deform_attn_backward(value, spatial_shapes, sampling_locations,
                            attention_weights, grad_out):
    """(d_value, d_loc, d_attn) of :func:`ms_deform_attn` for ``grad_out``
    (B, Q, heads * D); CPU tensors take the plain version, CUDA tensors
    kernel K3.  d_loc is float32, the others in their input's dtype."""
    if value.device.type == "cpu":
        return ms_deform_attn_backward_reference(
            value, spatial_shapes, sampling_locations, attention_weights,
            grad_out)
    return _msda_bwd_cuda(value, tuple(tuple(s) for s in spatial_shapes),
                          sampling_locations, attention_weights, grad_out)


class _MSDAFunction(torch.autograd.Function):
    """K1 forward, K3 backward.  Autocast is declared but casts nothing:
    locations must stay float32 (a bf16 location is off by up to half a cell
    on a 200-cell map)."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, value, spatial_shapes, loc, attn):
        ctx.spatial_shapes = spatial_shapes
        ctx.save_for_backward(value, loc, attn)
        return _msda_cuda(value, spatial_shapes, loc, attn)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, grad_out):
        value, loc, attn = ctx.saved_tensors
        d_value, d_loc, d_attn = _msda_bwd_cuda(value, ctx.spatial_shapes, loc,
                                                attn, grad_out)
        return d_value, None, d_loc, d_attn


def _check(value, spatial_shapes, loc, attn):
    """Validate the kernels' inputs; returns the shapes and the C arguments."""
    tensors = (value, loc, attn)
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
    return (B, V, Q, heads, D, L, P), shapes, code


@spanned("kernel:msda_fwd")
def _msda_cuda(value, spatial_shapes, loc, attn):
    (B, V, Q, heads, D, L, P), shapes, code = _check(value, spatial_shapes,
                                                     loc, attn)
    size = value.element_size()
    vec = msda_fwd_route(D, size, value.data_ptr())
    out = torch.empty((B, Q, heads * D), dtype=value.dtype, device=value.device)
    err = _build.lib().unibev_msda_fwd(
        value.data_ptr(), loc.data_ptr(), attn.data_ptr(), out.data_ptr(),
        B, V, Q, heads, D, L, P, ctypes.addressof(shapes), code, vec // size,
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "msda_fwd")
    _build.launches["msda_fwd"] += 1
    return out


@spanned("kernel:msda_bwd")
def _msda_bwd_cuda(value, spatial_shapes, loc, attn, grad_out):
    (B, V, Q, heads, D, L, P), shapes, code = _check(value, spatial_shapes,
                                                     loc, attn)
    if grad_out.shape != (B, Q, heads * D):
        raise ValueError(f"grad_out must be {(B, Q, heads * D)}, "
                         f"got {tuple(grad_out.shape)}")
    grad_out = grad_out.to(value.dtype).contiguous()
    d_attn = torch.empty_like(attn)
    d_loc = torch.empty_like(loc)
    table = torch.zeros((B * V * heads, D), dtype=torch.float32,
                        device=value.device)
    size = value.element_size()
    plan = msda_bwd_plan(B, V, Q, heads, D, size, value.data_ptr(),
                         grad_out.data_ptr())
    err = _build.lib().unibev_msda_bwd(
        value.data_ptr(), loc.data_ptr(), attn.data_ptr(), grad_out.data_ptr(),
        d_attn.data_ptr(), d_loc.data_ptr(), table.data_ptr(), B, V, Q, heads,
        D, L, P, ctypes.addressof(shapes), code, plan.vec_bytes // size,
        plan.lanes, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "msda_bwd")
    _build.launches["msda_bwd"] += 1
    d_value = table.view(B, V, heads, D).to(value.dtype)
    return d_value, d_loc, d_attn
