"""BEVFormer-style BEV encoders of the camera and LiDAR branches.

Counterpart of ``unibev_tpu/models/encoders.py``.  Geometry as in the JAX
package: pillar reference points with z anchors at
``linspace(0.5, Z - 0.5, P) / Z``, camera projection through ``lidar2img``
normalized by the un-padded ``img_shape``, and the layer order
TSA -> norm -> SCA -> norm -> FFN -> norm.  The LiDAR encoder's sampling is
trivial: the normalized xy of each pillar anchor indexes the LiDAR BEV map
directly.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from benchmark.reference.models.attention.deformable import (
    MSDAttention, SpatialCrossAttentionImg, SpatialCrossAttentionPts)
from benchmark.reference.models.layers import FFN, layer_norm
from benchmark.reference.registry import TRANSFORMER_LAYER_SEQUENCES


def _centers(n: int, device) -> torch.Tensor:
    return torch.linspace(0.5, n - 0.5, n, device=device) / n


def get_reference_points_3d(H: int, W: int, Z: float, num_points_in_pillar: int,
                            device=None) -> torch.Tensor:
    """(P, H*W, 3) normalized pillar points; ref[p, h*W+w] = (x_w, y_h, z_p)."""
    P = num_points_in_pillar
    zs = torch.linspace(0.5, Z - 0.5, P, device=device) / Z
    xs, ys = _centers(W, device), _centers(H, device)
    x = xs[None, None, :].expand(P, H, W)
    y = ys[None, :, None].expand(P, H, W)
    z = zs[:, None, None].expand(P, H, W)
    return torch.stack([x, y, z], dim=-1).reshape(P, H * W, 3)


def get_reference_points_2d(H: int, W: int, device=None) -> torch.Tensor:
    """(H*W, 1, 2) normalized BEV cell centers in (x, y) order."""
    ys, xs = _centers(H, device), _centers(W, device)
    y = ys[:, None].expand(H, W)
    x = xs[None, :].expand(H, W)
    return torch.stack([x, y], dim=-1).reshape(H * W, 1, 2)


def point_sampling_img(ref_3d: torch.Tensor, pc_range: Sequence[float],
                       lidar2img: torch.Tensor, img_shape: Tuple[int, int]):
    """Project pillar points into every camera, in float32.

    ref_3d (P, Q, 3); lidar2img (B, N, 4, 4); img_shape (H_img, W_img), the
    pre-padding size the reference normalizes by.
    Returns ref_cam (B, N, Q, P, 2) in [0, 1] (x, y) and bev_mask (B, N, Q, P).
    """
    eps = 1e-5
    x = ref_3d[..., 0] * (pc_range[3] - pc_range[0]) + pc_range[0]
    y = ref_3d[..., 1] * (pc_range[4] - pc_range[1]) + pc_range[1]
    z = ref_3d[..., 2] * (pc_range[5] - pc_range[2]) + pc_range[2]
    pts = torch.stack([x, y, z, torch.ones_like(x)], dim=-1)      # (P, Q, 4)
    cam = torch.einsum("bnij,pqj->bnpqi", lidar2img.float(), pts.float())
    zcam = cam[..., 2]
    mask = zcam > eps
    xy = cam[..., :2] / zcam.clamp(min=eps)[..., None]
    u = xy[..., 0] / img_shape[1]
    v = xy[..., 1] / img_shape[0]
    mask &= (u > 0.0) & (u < 1.0) & (v > 0.0) & (v < 1.0)
    ref_cam = torch.nan_to_num(torch.stack([u, v], dim=-1))
    return ref_cam.permute(0, 1, 3, 2, 4), mask.permute(0, 1, 3, 2)


class BEVEncoderLayer(nn.Module):
    """One encoder layer: TSA -> LN -> SCA -> LN -> FFN -> LN (post-norm).

    Submodules sit under the reference's names: ``attentions.0`` (TSA),
    ``attentions.1`` (SCA: the camera one, or the LiDAR one when
    ``modality`` is "pts"), ``ffns.0``, ``norms.0-2``.
    """

    def __init__(self, embed_dims: int = 256, ffn_dims: int = 512,
                 tsa_cfg: Optional[dict] = None, sca_cfg: Optional[dict] = None,
                 modality: str = "img"):
        super().__init__()
        tsa = {k: v for k, v in dict(tsa_cfg or {}).items() if k != "type"}
        sca = {k: v for k, v in dict(sca_cfg or {}).items() if k != "type"}
        sca_cls = {"img": SpatialCrossAttentionImg,
                   "pts": SpatialCrossAttentionPts}[modality]
        self.modality = modality
        self.attentions = nn.ModuleList([
            MSDAttention(**tsa), sca_cls(embed_dims=embed_dims, **sca)])
        self.ffns = nn.ModuleList([FFN(embed_dims, ffn_dims)])
        self.norms = nn.ModuleList([layer_norm(embed_dims) for _ in range(3)])

    def forward(self, query, value, bev_pos, ref_2d, bev_hw, ref_cross,
                hit_mask, value_shapes, topk_idx=None):
        B = query.shape[0]
        query = self.attentions[0](query, query,
                                   ref_2d[None].expand(B, *ref_2d.shape),
                                   (bev_hw,), query_pos=bev_pos)
        query = self.norms[0](query)
        if self.modality == "img":
            query = self.attentions[1](query, value, ref_cross, hit_mask,
                                       value_shapes, topk_idx=topk_idx)
        else:
            query = self.attentions[1](query, value, ref_cross, value_shapes)
        query = self.norms[1](query)
        query = self.ffns[0](query)
        return self.norms[2](query)


@TRANSFORMER_LAYER_SEQUENCES.register_module(name="ImgEncoder")
class ImgEncoder(nn.Module):
    """Camera BEV encoder: N layers of TSA + camera SCA over shared queries."""

    def __init__(self, num_layers: int = 3,
                 pc_range: Sequence[float] = (-54, -54, -5, 54, 54, 3),
                 num_points_in_pillar: int = 4, embed_dims: int = 256,
                 ffn_dims: int = 512, tsa_cfg: Optional[dict] = None,
                 sca_cfg: Optional[dict] = None):
        super().__init__()
        self.pc_range = tuple(pc_range)
        self.num_points_in_pillar = num_points_in_pillar
        self.rebatch_k = int((sca_cfg or {}).get("rebatch_k", 0) or 0)
        self.layers = nn.ModuleList([
            BEVEncoderLayer(embed_dims, ffn_dims, tsa_cfg, sca_cfg)
            for _ in range(num_layers)])

    def forward(self, bev_query, value, bev_pos, bev_h, bev_w, lidar2img,
                img_shape, value_shapes):
        """bev_query (B, H*W, C); value (B, cams, V, C); lidar2img (B, N, 4, 4).

        Returns (bev (B, H*W, C), sca_overflow): the overflow is the most hit
        queries any camera had beyond the top-K capacity, a 0-dim int tensor
        (0 when the rebatch covers every hit or is off).
        """
        dev = bev_query.device
        Z = self.pc_range[5] - self.pc_range[2]
        ref_3d = get_reference_points_3d(bev_h, bev_w, Z,
                                         self.num_points_in_pillar, dev)
        ref_2d = get_reference_points_2d(bev_h, bev_w, dev)
        ref_cam, mask = point_sampling_img(ref_3d, self.pc_range, lidar2img,
                                           img_shape)
        hit = mask.any(dim=-1)                                 # (B, N, Q)

        # Per-camera top-K hit-query indices, hits first in query order,
        # computed once and shared by every layer (the hit pattern is
        # geometry only).
        topk_idx = None
        overflow = torch.zeros((), dtype=torch.int64, device=dev)
        if self.rebatch_k:
            K = min(self.rebatch_k, bev_h * bev_w)
            order = torch.argsort((~hit).to(torch.uint8), dim=-1, stable=True)
            topk_idx = order[..., :K]
            overflow = (hit.sum(dim=-1) - K).clamp(min=0).max()

        for layer in self.layers:
            bev_query = layer(bev_query, value, bev_pos, ref_2d,
                              (bev_h, bev_w), ref_cam, hit, value_shapes,
                              topk_idx=topk_idx)
        return bev_query, overflow


@TRANSFORMER_LAYER_SEQUENCES.register_module(name="PtsEncoder")
class PtsEncoder(nn.Module):
    """LiDAR BEV encoder: N layers of TSA + LiDAR SCA over the LiDAR BEV map."""

    def __init__(self, num_layers: int = 3,
                 pc_range: Sequence[float] = (-54, -54, -5, 54, 54, 3),
                 num_points_in_pillar_lidar: int = 4, embed_dims: int = 256,
                 ffn_dims: int = 512, tsa_cfg: Optional[dict] = None,
                 sca_cfg: Optional[dict] = None):
        super().__init__()
        self.pc_range = tuple(pc_range)
        self.num_points_in_pillar = num_points_in_pillar_lidar
        self.layers = nn.ModuleList([
            BEVEncoderLayer(embed_dims, ffn_dims, tsa_cfg, sca_cfg, "pts")
            for _ in range(num_layers)])

    def forward(self, bev_query, value, bev_pos, bev_h, bev_w, value_shapes):
        """bev_query (B, H*W, C); value (B, V, C), the flattened LiDAR BEV map
        in (h, w) order.  Returns (B, H*W, C)."""
        dev = bev_query.device
        Z = self.pc_range[5] - self.pc_range[2]
        P = self.num_points_in_pillar
        ref_3d = get_reference_points_3d(bev_h, bev_w, Z, P, dev)
        ref_2d = get_reference_points_2d(bev_h, bev_w, dev)
        # every anchor of a pillar shares its xy (the reference's (P, Q, 2)
        # -> (Q, P, 2) permute)
        ref_lidar = ref_3d[..., :2].transpose(0, 1)[None].expand(
            bev_query.shape[0], bev_h * bev_w, P, 2)
        for layer in self.layers:
            bev_query = layer(bev_query, value, bev_pos, ref_2d,
                              (bev_h, bev_w), ref_lidar, None, value_shapes)
        return bev_query
