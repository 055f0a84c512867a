"""BEVFormer's transformer: the previous BEV map aligned with the ego's
motion, the CAN bus added to the BEV queries, the camera BEV encoder with
temporal self-attention, and the object decoder.

Written from the published ``transformer.py`` (fundamentalvision/BEVFormer,
``PerceptionTransformer.get_bev_features`` and ``forward``) on the port's
modules: the encoder is the camera ``ImgEncoder`` with its TSA of type
``TemporalSelfAttention``, the decoder and the camera value are UniBEV's
(``transformer_fusion``).  Parameter names are the published module tree's
(``level_embeds``, ``cams_embeds``, ``reference_points``, ``can_bus_mlp``,
``encoder``, ``decoder``).

The alignment (:class:`BEVAlign`, ``align``, no parameters) runs on the
device from the CAN bus rows the detector formed (``can_bus[:3]`` the
ego's translation since the previous frame, ``can_bus[-1]`` its yaw change
in degrees, ``can_bus[-2]`` its absolute yaw in radians; zeros where a
sample has no history): the previous map rotated by the yaw change about
``rotate_center`` (``ops/bev_rotate.py``), the translation as a shift of
the TSA's reference points in BEV units, and ``can_bus_mlp`` of the row
added to every BEV query.  Noted departure: ``can_bus_mlp``'s LayerNorm
takes the port's eps, 1e-6, where mmcv's is 1e-5 (at unit-variance
activations below 1e-5 relative).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from unibev_tpu_torch.models.encoders import ImgEncoder
from unibev_tpu_torch.models.layers import layer_norm
from unibev_tpu_torch.models.transformer_fusion import (build_decoder,
                                                        build_encoder,
                                                        camera_value)
from unibev_tpu_torch.ops.bev_rotate import rotate_bev
from unibev_tpu_torch.registry import TRANSFORMERS
from unibev_tpu_torch.utils.timer import spanned


class BEVAlign(nn.Module):
    """The previous BEV map rotated into this frame, the shift of the TSA's
    reference points, and the CAN bus added to the BEV queries."""

    def __init__(self, bev_h: int, bev_w: int,
                 rotate_center: Sequence[float] = (100, 100)):
        super().__init__()
        self.bev_h, self.bev_w = bev_h, bev_w
        self.rotate_center = tuple(rotate_center)

    def rotate(self, prev_bev: torch.Tensor, angle_deg: torch.Tensor,
               keep: torch.Tensor) -> torch.Tensor:
        """(B, HW, C) maps rotated by ``angle_deg`` (B,) about the centre;
        zero where ``keep`` is False."""
        B, HW, C = prev_bev.shape
        return rotate_bev(prev_bev.view(B, self.bev_h, self.bev_w, C),
                          angle_deg, self.rotate_center,
                          keep).view(B, HW, C)

    @spanned("bev_align")
    def forward(self, prev_bev: Optional[torch.Tensor], can_bus: torch.Tensor,
                history: torch.Tensor, queries: torch.Tensor,
                can_bus_mlp: nn.Module, grid_length: Tuple[float, float]):
        """prev_bev (B, HW, C), the stored previous map, or None where no
        sample has one; can_bus (B, 18) float64 (see the module's doc);
        history (B,) bool; queries (B, HW, C); grid_length (y, x) metres a
        BEV cell.  Returns (the aligned previous map (B, HW, C), zero where
        a sample has no history; shift (B, 2) float32, (x, y) in BEV units;
        the queries plus the CAN bus's embedding)."""
        dx, dy = can_bus[:, 0], can_bus[:, 1]
        ego_angle = can_bus[:, -2] / math.pi * 180
        length = torch.sqrt(dx ** 2 + dy ** 2)
        bev_angle = ego_angle - torch.atan2(dy, dx) / math.pi * 180
        rad = bev_angle / 180 * math.pi
        shift_y = length * torch.cos(rad) / grid_length[0] / self.bev_h
        shift_x = length * torch.sin(rad) / grid_length[1] / self.bev_w
        shift = torch.stack([shift_x, shift_y], -1).float()
        if prev_bev is None:
            prev = torch.zeros_like(queries)
        else:
            prev = self.rotate(prev_bev, can_bus[:, -1], history)
        emb = can_bus_mlp(can_bus.to(queries.dtype))
        queries = queries + emb[:, None, :]
        return prev, shift, queries


@TRANSFORMERS.register_module(name="PerceptionTransformer")
class PerceptionTransformer(nn.Module):

    def __init__(self, num_feature_levels: int = 4, num_cams: int = 6,
                 encoder: Optional[dict] = None,
                 decoder: Optional[dict] = None, embed_dims: int = 256,
                 use_shift: bool = True, use_can_bus: bool = True,
                 can_bus_norm: bool = True,
                 rotate_center: Sequence[float] = (100, 100),
                 bev_h: int = 200, bev_w: int = 200,
                 rotate_prev_bev: bool = True, use_cams_embeds: bool = True):
        super().__init__()
        if not (rotate_prev_bev and use_cams_embeds and use_shift
                and use_can_bus and can_bus_norm):
            raise ValueError("the port's BEVFormer rotates and shifts by the "
                             "previous BEV, adds the normed CAN bus and the "
                             "camera embeddings, as published")
        C = embed_dims
        self.embed_dims = self.dec_dims = C
        self.bev_h, self.bev_w = bev_h, bev_w
        self.level_embeds = nn.Parameter(torch.empty(num_feature_levels, C))
        self.cams_embeds = nn.Parameter(torch.empty(num_cams, C))
        self.reference_points = nn.Linear(C, 3)
        self.can_bus_mlp = nn.Sequential(
            nn.Linear(18, C // 2), nn.ReLU(inplace=True),
            nn.Linear(C // 2, C), nn.ReLU(inplace=True))
        self.can_bus_mlp.add_module("norm", layer_norm(C))
        self.align = BEVAlign(bev_h, bev_w, rotate_center)
        self.encoder = build_encoder(ImgEncoder, dict(encoder or {}), C)
        self.decoder = build_decoder(dict(decoder or {}), C)

    def forward(self, img_feats, bev_queries, object_query_embed, bev_pos,
                lidar2img, img_shape, prev_bev, can_bus, history,
                grid_length, reg_branches=None):
        """img_feats: list of (B, N, H, W, C); bev_queries (HW, C);
        object_query_embed (Nq, 2C); bev_pos (B, HW, C); prev_bev, can_bus,
        history, grid_length as :meth:`BEVAlign.forward` takes them.

        Returns (bev_embed (B, HW, C), the encoder's output and the next
        frame's previous map; states (L, B, Nq, C); init_ref (B, Nq, 3);
        refs (L, B, Nq, 3); sca_overflow)."""
        B = img_feats[0].shape[0]
        C, HW = self.embed_dims, self.bev_h * self.bev_w
        queries = bev_queries[None].expand(B, HW, C)
        prev, shift, queries = self.align(prev_bev, can_bus, history, queries,
                                          self.can_bus_mlp, grid_length)
        value, shapes = camera_value(img_feats, self.cams_embeds,
                                     self.level_embeds)
        bev_embed, sca_overflow = self.encoder(
            queries, value, bev_pos, self.bev_h, self.bev_w, lidar2img,
            img_shape, shapes, prev, shift, history)

        query_pos, query = object_query_embed.split(C, dim=1)
        query_pos = query_pos[None].expand(B, -1, -1)
        query = query[None].expand(B, -1, -1)
        reference_points = torch.sigmoid(self.reference_points(query_pos))
        states, refs = self.decoder(query, bev_embed, query_pos,
                                    reference_points,
                                    ((self.bev_h, self.bev_w),),
                                    reg_branches=reg_branches)
        return bev_embed, states, reference_points, refs, sca_overflow
