"""BEVFormer's transformer and head, written from the published
``transformer.py``, ``encoder.py`` and ``bevformer_head.py``
(fundamentalvision/BEVFormer, ``projects/mmdet3d_plugin/bevformer``), batch
first, float32, on the reference's shared modules: the camera
cross-attention (``SpatialCrossAttentionImg``, with the configuration's
per-camera top-K capacity), the pillar geometry, the FFN, the object
decoder, the class and box branches, the positional encoding and the box
coder.  Module names are the published tree's (``transformer.
level_embeds``, ``cams_embeds``, ``reference_points``, ``can_bus_mlp``,
``encoder.layers.{i}.attentions.{0,1}``, ``decoder``); ``transformer.
align`` holds no parameters: it is ``get_bev_features``' alignment of the
previous map, as a module of its own.

As published: the shift and rotation come from the frame's CAN bus row on
the host, in float64 (numpy); the encoder shifts ``ref_2d`` in place, so
both maps of the TSA's queue are sampled at the shifted points (the
published comment keeps that bug to reproduce the paper's results); the
queue's current map is the encoder's first queries in every layer.
LayerNorms take eps 1e-6 (mmcv's is 1e-5), as the rest of the reference.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from benchmark.reference.core.bbox.coders import NMSFreeCoder
from benchmark.reference.models.attention.deformable import \
    SpatialCrossAttentionImg
from benchmark.reference.models.attention.temporal import \
    TemporalSelfAttention
from benchmark.reference.models.decoder import DetectionTransformerDecoder
from benchmark.reference.models.encoders import (get_reference_points_2d,
                                                 get_reference_points_3d,
                                                 point_sampling_img)
from benchmark.reference.models.heads.unibev_head import (UniBEVHead,
                                                          cls_branch,
                                                          reg_branch)
from benchmark.reference.models.layers import (FFN, LearnedPositionalEncoding,
                                               inverse_sigmoid, layer_norm)
from benchmark.reference.ops.rotate import rotate


def _clean(cfg) -> dict:
    return {k: v for k, v in dict(cfg or {}).items() if k != "type"}


class BEVAlign(nn.Module):
    """``get_bev_features``' shift from the ego's translation and rotation
    of the previous map by its yaw change."""

    def __init__(self, bev_h: int, bev_w: int,
                 rotate_center: Sequence[float], rotate_prev_bev: bool,
                 use_shift: bool):
        super().__init__()
        self.bev_h, self.bev_w = bev_h, bev_w
        self.rotate_center = list(rotate_center)
        self.rotate_prev_bev = rotate_prev_bev
        self.use_shift = use_shift

    def forward(self, prev_bev: Optional[torch.Tensor], can_bus: np.ndarray,
                grid_length: Tuple[float, float], device):
        """prev_bev (bs, HW, C) or None; can_bus (bs, 18) float64, the deltas
        formed.  Returns (the rotated map or None, shift (bs, 2) float32 on
        ``device``)."""
        delta_x, delta_y = can_bus[:, 0], can_bus[:, 1]
        ego_angle = can_bus[:, -2] / np.pi * 180
        grid_length_y, grid_length_x = grid_length
        translation_length = np.sqrt(delta_x ** 2 + delta_y ** 2)
        translation_angle = np.arctan2(delta_y, delta_x) / np.pi * 180
        bev_angle = ego_angle - translation_angle
        shift_y = translation_length * \
            np.cos(bev_angle / 180 * np.pi) / grid_length_y / self.bev_h
        shift_x = translation_length * \
            np.sin(bev_angle / 180 * np.pi) / grid_length_x / self.bev_w
        shift_y = shift_y * self.use_shift
        shift_x = shift_x * self.use_shift
        shift = torch.tensor(np.stack([shift_x, shift_y], -1),
                             dtype=torch.float32, device=device)
        if prev_bev is not None and self.rotate_prev_bev:
            prev_bev = prev_bev.clone()
            for i in range(prev_bev.shape[0]):
                tmp = prev_bev[i].reshape(self.bev_h, self.bev_w, -1) \
                    .permute(2, 0, 1)
                tmp = rotate(tmp, can_bus[i][-1], self.rotate_center)
                prev_bev[i] = tmp.permute(1, 2, 0).reshape(
                    self.bev_h * self.bev_w, -1)
        return prev_bev, shift


class BEVFormerLayer(nn.Module):
    """TSA -> LN -> SCA -> LN -> FFN -> LN (``BEVFormerLayer``, post-norm)."""

    def __init__(self, embed_dims: int, ffn_dims: int, tsa_cfg: dict,
                 sca_cfg: dict):
        super().__init__()
        sca = {k: v for k, v in _clean(sca_cfg).items() if k != "embed_dims"}
        self.attentions = nn.ModuleList([
            TemporalSelfAttention(**_clean(tsa_cfg)),
            SpatialCrossAttentionImg(embed_dims=embed_dims, **sca)])
        self.ffns = nn.ModuleList([FFN(embed_dims, ffn_dims)])
        self.norms = nn.ModuleList([layer_norm(embed_dims) for _ in range(3)])

    def forward(self, query, value, bev_pos, hybrid_ref, bev_hw, ref_cam,
                bev_mask, value_shapes, topk_idx, prev_bev):
        query = self.attentions[0](query, prev_bev, bev_pos, hybrid_ref,
                                   [bev_hw])
        query = self.norms[0](query)
        query = self.attentions[1](query, value, ref_cam, bev_mask,
                                   value_shapes, topk_idx=topk_idx)
        query = self.norms[1](query)
        query = self.ffns[0](query)
        return self.norms[2](query)


class BEVFormerEncoder(nn.Module):

    def __init__(self, num_layers: int, pc_range: Sequence[float],
                 num_points_in_pillar: int, embed_dims: int,
                 transformerlayers: dict, **_):
        super().__init__()
        attn = transformerlayers["attn_cfgs"]
        self.pc_range = tuple(pc_range)
        self.num_points_in_pillar = num_points_in_pillar
        self.rebatch_k = int(dict(attn[1]).get("rebatch_k", 0) or 0)
        ffn = transformerlayers.get("feedforward_channels", embed_dims * 2)
        self.layers = nn.ModuleList([
            BEVFormerLayer(embed_dims, ffn, attn[0], attn[1])
            for _ in range(num_layers)])

    def forward(self, bev_query, value, bev_pos, bev_h, bev_w, lidar2img,
                img_shape, value_shapes, prev_bev=None, shift=None):
        """bev_query (bs, HW, C); value (bs, cams, V, C); prev_bev (bs, HW,
        C), the rotated previous map, or None; shift (bs, 2).  Returns (the
        BEV map, sca_overflow)."""
        bs, len_bev, _ = bev_query.shape
        dev = bev_query.device
        Z = self.pc_range[5] - self.pc_range[2]
        ref_3d = get_reference_points_3d(bev_h, bev_w, Z,
                                         self.num_points_in_pillar, dev)
        ref_2d = get_reference_points_2d(bev_h, bev_w, dev)[None].repeat(
            bs, 1, 1, 1)
        ref_cam, mask = point_sampling_img(ref_3d, self.pc_range, lidar2img,
                                           img_shape)
        hit = mask.any(dim=-1)
        topk_idx = None
        overflow = torch.zeros((), dtype=torch.int64, device=dev)
        if self.rebatch_k:
            K = min(self.rebatch_k, bev_h * bev_w)
            order = torch.argsort((~hit).to(torch.uint8), dim=-1, stable=True)
            topk_idx = order[..., :K]
            overflow = (hit.sum(dim=-1) - K).clamp(min=0).max()
        # as published: "this code should be 'shift_ref_2d = ref_2d.clone()',
        # we keep this bug for reproducing our results in paper"
        shift_ref_2d = ref_2d
        shift_ref_2d += shift[:, None, None, :]
        num_bev_level = ref_2d.shape[2]
        if prev_bev is not None:
            prev_bev = torch.stack([prev_bev, bev_query], 1).reshape(
                bs * 2, len_bev, -1)
            hybird_ref_2d = torch.stack([shift_ref_2d, ref_2d], 1).reshape(
                bs * 2, len_bev, num_bev_level, 2)
        else:
            hybird_ref_2d = torch.stack([ref_2d, ref_2d], 1).reshape(
                bs * 2, len_bev, num_bev_level, 2)
        for layer in self.layers:
            bev_query = layer(bev_query, value, bev_pos, hybird_ref_2d,
                              (bev_h, bev_w), ref_cam, hit, value_shapes,
                              topk_idx, prev_bev)
        return bev_query, overflow


class PerceptionTransformer(nn.Module):

    def __init__(self, num_feature_levels: int = 4, num_cams: int = 6,
                 encoder: Optional[dict] = None,
                 decoder: Optional[dict] = None, embed_dims: int = 256,
                 rotate_prev_bev: bool = True, use_shift: bool = True,
                 use_can_bus: bool = True, can_bus_norm: bool = True,
                 use_cams_embeds: bool = True,
                 rotate_center: Sequence[float] = (100, 100),
                 bev_h: int = 200, bev_w: int = 200, **_):
        super().__init__()
        self.embed_dims = embed_dims
        self.bev_h, self.bev_w = bev_h, bev_w
        self.use_can_bus = use_can_bus
        self.use_cams_embeds = use_cams_embeds
        self.level_embeds = nn.Parameter(torch.empty(num_feature_levels,
                                                     embed_dims))
        self.cams_embeds = nn.Parameter(torch.empty(num_cams, embed_dims))
        self.reference_points = nn.Linear(embed_dims, 3)
        self.can_bus_mlp = nn.Sequential(
            nn.Linear(18, embed_dims // 2), nn.ReLU(inplace=True),
            nn.Linear(embed_dims // 2, embed_dims), nn.ReLU(inplace=True))
        if can_bus_norm:
            self.can_bus_mlp.add_module("norm", layer_norm(embed_dims))
        self.align = BEVAlign(bev_h, bev_w, rotate_center, rotate_prev_bev,
                              use_shift)
        self.encoder = BEVFormerEncoder(embed_dims=embed_dims,
                                        **_clean(encoder))
        dlayers = dict(decoder)["transformerlayers"]
        mha, ca = (dict(a) for a in dlayers["attn_cfgs"])
        self.decoder = DetectionTransformerDecoder(
            num_layers=dict(decoder).get("num_layers", 6),
            embed_dims=embed_dims, num_heads=mha.get("num_heads", 8),
            ffn_dims=dlayers.get("feedforward_channels", embed_dims * 2),
            cross_attn_cfg=_clean(ca))

    def get_bev_features(self, img_feats, bev_queries, grid_length, bev_pos,
                         prev_bev, can_bus, lidar2img, img_shape):
        bs = img_feats[0].shape[0]
        prev_bev, shift = self.align(prev_bev, can_bus, grid_length,
                                     bev_queries.device)
        can = torch.tensor(can_bus, dtype=bev_queries.dtype,
                           device=bev_queries.device)
        bev_queries = bev_queries[None].repeat(bs, 1, 1) \
            + self.can_bus_mlp(can)[:, None, :] * self.use_can_bus
        feat_flatten, spatial_shapes = [], []
        for lvl, feat in enumerate(img_feats):
            _, num_cam, h, w, c = feat.shape
            feat = feat.reshape(bs, num_cam, h * w, c)
            if self.use_cams_embeds:
                feat = feat + self.cams_embeds[None, :, None, :]
            feat = feat + self.level_embeds[None, None, lvl:lvl + 1, :]
            spatial_shapes.append((h, w))
            feat_flatten.append(feat)
        value = torch.cat(feat_flatten, 2)
        return self.encoder(bev_queries, value, bev_pos, self.bev_h,
                            self.bev_w, lidar2img, img_shape,
                            tuple(spatial_shapes), prev_bev, shift)

    def forward(self, img_feats, bev_queries, object_query_embed,
                grid_length, bev_pos, prev_bev, can_bus, lidar2img,
                img_shape, reg_branches):
        bev_embed, overflow = self.get_bev_features(
            img_feats, bev_queries, grid_length, bev_pos, prev_bev, can_bus,
            lidar2img, img_shape)
        bs = img_feats[0].shape[0]
        query_pos, query = torch.split(object_query_embed, self.embed_dims,
                                       dim=1)
        query_pos = query_pos.unsqueeze(0).expand(bs, -1, -1)
        query = query.unsqueeze(0).expand(bs, -1, -1)
        reference_points = self.reference_points(query_pos).sigmoid()
        states, refs = self.decoder(query, bev_embed, query_pos,
                                    reference_points,
                                    ((self.bev_h, self.bev_w),),
                                    reg_branches=reg_branches)
        return bev_embed, states, reference_points, refs, overflow


class BEVFormerHead(nn.Module):
    """The published ``BEVFormerHead`` with box refinement; its decoding is
    the shared head's (``get_bboxes``)."""

    get_bboxes = UniBEVHead.get_bboxes

    def __init__(self, num_classes: int = 10, in_channels: int = 256,
                 num_query: int = 900, bev_h: int = 200, bev_w: int = 200,
                 transformer: Optional[dict] = None,
                 bbox_coder: Optional[dict] = None,
                 positional_encoding: Optional[dict] = None, **_):
        super().__init__()
        coder = _clean(bbox_coder)
        self.pc_range = tuple(coder["pc_range"])
        self.real_w = self.pc_range[3] - self.pc_range[0]
        self.real_h = self.pc_range[4] - self.pc_range[1]
        self.bev_h, self.bev_w = bev_h, bev_w
        num_layers = dict(dict(transformer)["decoder"]).get("num_layers", 6)
        self.transformer = PerceptionTransformer(
            **{**_clean(transformer), "bev_h": bev_h, "bev_w": bev_w})
        pe = _clean(positional_encoding)
        self.positional_encoding = LearnedPositionalEncoding(
            pe["num_feats"], pe["row_num_embed"], pe["col_num_embed"])
        self.bev_embedding = nn.Embedding(bev_h * bev_w, in_channels)
        self.query_embedding = nn.Embedding(num_query, in_channels * 2)
        self.cls_branches = nn.ModuleList(
            [cls_branch(in_channels, num_classes) for _ in range(num_layers)])
        self.reg_branches = nn.ModuleList(
            [reg_branch(in_channels) for _ in range(num_layers)])
        coder.setdefault("num_classes", num_classes)
        self.coder = NMSFreeCoder(**coder)

    def forward(self, img_feats, lidar2img, img_shape, prev_bev, can_bus):
        bs = img_feats[0].shape[0]
        bev_pos = self.positional_encoding(bs, self.bev_h, self.bev_w)
        # refs[l]: the reference points decoder layer l sampled at (the
        # published init_reference, then inter_references[l - 1])
        bev_embed, hs, init_reference, refs, overflow = \
            self.transformer(img_feats, self.bev_embedding.weight,
                             self.query_embedding.weight,
                             (self.real_h / self.bev_h,
                              self.real_w / self.bev_w),
                             bev_pos, prev_bev, can_bus, lidar2img, img_shape,
                             self.reg_branches)
        outputs_classes, outputs_coords = [], []
        pr = self.pc_range
        for lvl in range(hs.shape[0]):
            reference = inverse_sigmoid(refs[lvl])
            outputs_class = self.cls_branches[lvl](hs[lvl])
            tmp = self.reg_branches[lvl](hs[lvl])
            tmp[..., 0:2] += reference[..., 0:2]
            tmp[..., 0:2] = tmp[..., 0:2].sigmoid()
            tmp[..., 4:5] += reference[..., 2:3]
            tmp[..., 4:5] = tmp[..., 4:5].sigmoid()
            tmp[..., 0:1] = tmp[..., 0:1] * (pr[3] - pr[0]) + pr[0]
            tmp[..., 1:2] = tmp[..., 1:2] * (pr[4] - pr[1]) + pr[1]
            tmp[..., 4:5] = tmp[..., 4:5] * (pr[5] - pr[2]) + pr[2]
            outputs_classes.append(outputs_class)
            outputs_coords.append(tmp)
        return dict(all_cls_scores=torch.stack(outputs_classes),
                    all_bbox_preds=torch.stack(outputs_coords),
                    bev_embed=bev_embed, sca_overflow=overflow)
