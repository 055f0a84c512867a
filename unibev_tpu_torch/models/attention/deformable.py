"""Deformable-attention modules of the UniBEV transformer stack.

Counterpart of ``unibev_tpu/models/attention/deformable.py``.  Every module
samples through ``ops.msda.ms_deform_attn`` (kernel K1 on CUDA).  Sampling
locations are kept in float32 whatever the compute dtype: a bf16 location
over a 200-cell map is off by up to half a cell.

The camera cross-attention has both of the JAX package's formulations: the
per-camera top-K rebatch (only queries whose pillar projects into a camera
run through that camera's attention) and the masked dense form (every query
against every camera, non-hits zeroed).  They are the same math when K
covers every hit.  The LiDAR cross-attention runs every query against the
one LiDAR BEV map.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from unibev_tpu_torch.models.layers import dropout
from unibev_tpu_torch.ops.msda import ms_deform_attn
from unibev_tpu_torch.registry import ATTENTION


def grid_offset_bias(num_heads: int, num_levels: int,
                     num_points: int) -> torch.Tensor:
    """Deformable-DETR's directional grid init for the sampling-offset bias."""
    thetas = torch.arange(num_heads, dtype=torch.float32) * (2.0 * math.pi / num_heads)
    grid = torch.stack([thetas.cos(), thetas.sin()], dim=-1)
    grid = grid / grid.abs().max(dim=-1, keepdim=True).values
    grid = grid[:, None, None, :].repeat(1, num_levels, num_points, 1)
    scale = torch.arange(1, num_points + 1, dtype=torch.float32)[None, None, :, None]
    return (grid * scale).reshape(-1)


class _SamplingHeads(nn.Module):
    """Projections shared by every MSDA variant: offsets, weights, values."""

    def __init__(self, embed_dims, num_heads, num_levels, num_points):
        super().__init__()
        if embed_dims % num_heads:
            raise ValueError(f"embed_dims {embed_dims} not divisible by {num_heads}")
        self.embed_dims = embed_dims
        self.num_heads = num_heads
        self.num_levels = num_levels
        self.num_points = num_points
        self.sampling_offsets = nn.Linear(embed_dims,
                                          num_heads * num_levels * num_points * 2)
        self.attention_weights = nn.Linear(embed_dims,
                                           num_heads * num_levels * num_points)
        self.value_proj = nn.Linear(embed_dims, embed_dims)

    def project(self, query, value, spatial_shapes):
        """-> value (B, V, heads, D), offsets (B, Q, heads, L, P, 2) in
        normalized float32 units, weights (B, Q, heads, L, P) in value's
        dtype (under autocast the softmax runs in float32)."""
        B, Q, _ = query.shape
        h, L, P = self.num_heads, self.num_levels, self.num_points
        v = self.value_proj(value).view(value.shape[0], -1, h,
                                        self.embed_dims // h)
        offsets = self.sampling_offsets(query).view(B, Q, h, L, P, 2).float()
        # offsets are (x, y) in cells: divide by each level's (W, H), in
        # place with Python scalars (a normalizer tensor built from a list
        # would cost a host-to-device copy per call)
        for lvl, (H, W) in enumerate(spatial_shapes):
            offsets[:, :, :, lvl, :, 0].div_(W)
            offsets[:, :, :, lvl, :, 1].div_(H)
        weights = self.attention_weights(query).view(B, Q, h, L * P)
        weights = torch.softmax(weights, dim=-1).view(B, Q, h, L, P)
        return v.contiguous(), offsets, weights.to(v.dtype)


@ATTENTION.register_module(name="MultiScaleDeformableAttention")
class MSDAttention(_SamplingHeads):
    """mmcv MultiScaleDeformableAttention (TSA and decoder cross-attention):
    value_proj, loc = ref + offsets / normalizer, MSDA, output_proj, dropout,
    + identity."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 num_levels: int = 1, num_points: int = 4):
        super().__init__(embed_dims, num_heads, num_levels, num_points)
        self.output_proj = nn.Linear(embed_dims, embed_dims)

    def forward(self, query, value, reference_points,
                spatial_shapes: Sequence[Tuple[int, int]], query_pos=None,
                identity=None):
        """query (B, Q, C); value (B, V, C); reference_points (B, Q, L, 2)."""
        identity = query if identity is None else identity
        if query_pos is not None:
            query = query + query_pos
        v, offsets, weights = self.project(query, value, spatial_shapes)
        loc = reference_points.float()[:, :, None, :, None, :] + offsets
        out = ms_deform_attn(v, spatial_shapes, loc.contiguous(),
                             weights.contiguous())
        return identity + dropout(self.output_proj(out), self.training)


@ATTENTION.register_module(name="CustomMSDeformableAttention")
class CustomMSDeformableAttention(MSDAttention):
    """Decoder cross-attention: the same computation as MSDAttention."""


@ATTENTION.register_module(name="MSDeformableAttention3DImg")
@ATTENTION.register_module(name="MSDeformableAttention3DPts")
class MSDeformableAttention3D(_SamplingHeads):
    """Inner deformable attention of the cross-attentions: no output
    projection and no residual.  The num_points taps are split over the Z
    pillar anchors of each query, ``(points // Z, Z)``."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 num_levels: int = 1, num_points: int = 8):
        super().__init__(embed_dims, num_heads, num_levels, num_points)

    def forward(self, query, value, reference_points,
                spatial_shapes: Sequence[Tuple[int, int]]):
        """query (B, Q, C); value (B, V, C); reference_points (B, Q, Z, 2)."""
        B, Q, _ = query.shape
        Z = reference_points.shape[2]
        h, L, P = self.num_heads, self.num_levels, self.num_points
        if P % Z:
            raise ValueError(f"num_points {P} not divisible by {Z} anchors")
        v, offsets, weights = self.project(query, value, spatial_shapes)
        offsets = offsets.view(B, Q, h, L, P // Z, Z, 2)
        loc = reference_points.float()[:, :, None, None, None, :, :] + offsets
        # an expanded or transposed reference (the LiDAR anchors) can give
        # the sum a permuted layout
        return ms_deform_attn(v, spatial_shapes,
                              loc.contiguous().view(B, Q, h, L, P, 2),
                              weights.contiguous())


@ATTENTION.register_module(name="SpatialCrossAttentionImg")
class SpatialCrossAttentionImg(nn.Module):
    """BEV-query -> multi-camera cross attention.

    Per camera, every BEV query attends into that camera's feature map at its
    projected pillar points; outputs are averaged over the cameras whose
    frustum holds the pillar (the hit mask), projected, dropped out and added
    to the query.
    ``rebatch_k`` > 0 runs only the top-K hit queries of each camera; 0 runs
    the masked dense form.
    """

    def __init__(self, embed_dims: int = 256,
                 deformable_attention: Optional[dict] = None,
                 rebatch_k: int = 0):
        super().__init__()
        da_cfg = {k: v for k, v in dict(deformable_attention or {}).items()
                  if k != "type"}
        da_cfg.setdefault("embed_dims", embed_dims)
        self.rebatch_k = rebatch_k
        self.deformable_attention = MSDeformableAttention3D(**da_cfg)
        self.output_proj = nn.Linear(embed_dims, embed_dims)

    def forward(self, query, value, reference_points_cam, bev_mask,
                spatial_shapes, topk_idx=None):
        """query (B, Q, C); value (B, cams, V, C); reference_points_cam
        (B, cams, Q, Z, 2); bev_mask (B, cams, Q) bool; topk_idx (B, cams, K)
        hit-query indices, hits first (used when rebatch_k > 0)."""
        B, Q, C = query.shape
        N = value.shape[1]
        Z = reference_points_cam.shape[3]
        v_b = value.reshape(B * N, -1, C)
        hit = bev_mask.to(query.dtype)                         # (B, N, Q)
        count = hit.sum(dim=1).clamp(min=1.0)                  # (B, Q)

        if self.rebatch_k and topk_idx is not None:
            K = topk_idx.shape[-1]
            idx = topk_idx.long()
            q_reb = torch.gather(query[:, None].expand(B, N, Q, C), 2,
                                 idx[..., None].expand(B, N, K, C))
            ref_reb = torch.gather(
                reference_points_cam.reshape(B, N, Q, Z * 2), 2,
                idx[..., None].expand(B, N, K, Z * 2))
            sel_hit = torch.gather(hit, 2, idx)                # (B, N, K)
            out = self.deformable_attention(
                q_reb.reshape(B * N, K, C), v_b,
                ref_reb.reshape(B * N, K, Z, 2), spatial_shapes)
            out = out.view(B, N, K, C) * sel_hit[..., None]
            # scatter-add back into the full query grid
            slots = torch.zeros((B * Q, C), dtype=out.dtype, device=out.device)
            rows = (idx + torch.arange(B, device=idx.device)[:, None, None] * Q)
            slots.index_add_(0, rows.reshape(-1), out.reshape(-1, C))
            slots = slots.view(B, Q, C)
        else:
            q_b = query[:, None].expand(B, N, Q, C).reshape(B * N, Q, C)
            ref_b = reference_points_cam.reshape(B * N, Q, Z, 2)
            out = self.deformable_attention(q_b, v_b, ref_b, spatial_shapes)
            slots = (out.view(B, N, Q, C) * hit[..., None]).sum(dim=1)

        slots = slots / count[..., None]
        return dropout(self.output_proj(slots), self.training) + query


@ATTENTION.register_module(name="SpatialCrossAttentionPts")
class SpatialCrossAttentionPts(nn.Module):
    """BEV-query -> LiDAR BEV map cross attention: every query attends into
    the one map at its pillar anchors, then output projection, dropout and
    the residual."""

    def __init__(self, embed_dims: int = 256,
                 deformable_attention: Optional[dict] = None):
        super().__init__()
        da_cfg = {k: v for k, v in dict(deformable_attention or {}).items()
                  if k != "type"}
        da_cfg.setdefault("embed_dims", embed_dims)
        self.deformable_attention = MSDeformableAttention3D(**da_cfg)
        self.output_proj = nn.Linear(embed_dims, embed_dims)

    def forward(self, query, value, reference_points, spatial_shapes):
        """query (B, Q, C); value (B, V, C); reference_points (B, Q, Z, 2)."""
        out = self.deformable_attention(query, value, reference_points,
                                        spatial_shapes)
        return dropout(self.output_proj(out), self.training) + query
