"""UniBEVTransformer: camera and LiDAR BEV encoding, CNW linear fusion,
object decoder.

Counterpart of ``unibev_tpu/models/transformer_fusion.py``.  Fusion is the
flagship's: ChannelNormWeights (CNW) with linear fusion ``c * img + l * pts``
under the modality flags ``l_flag`` and ``c_flag`` (float32 0-dim tensors,
0 or 1).  CNW softmaxes the two modalities' per-channel weights against each
other only when both flags are on; otherwise each weight is exactly 1.0.  A
missing modality's features are zeros.  The flags come from which inputs are
present (LC, L without ``img_feats``, C without ``pts_feats``, on one LC
model) or, for modality dropout in training, from
:func:`sample_modality_flags`; a dropped modality's branch still runs and
its BEV is multiplied by 0, as in the JAX package.

Not ported yet: the avg / cat fusions, the MLP-CNW / ModalityProjection /
spatial norms, modal embeddings and dual queries.  Each raises
``NotImplementedError`` at construction.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from unibev_tpu_torch.models.decoder import DetectionTransformerDecoder
from unibev_tpu_torch.models.encoders import ImgEncoder, PtsEncoder
from unibev_tpu_torch.registry import TRANSFORMERS


def sample_modality_flags(generator: torch.Generator, dropout_prob: float,
                          lidar_prob: float):
    """Modality dropout's flags (l_flag, c_flag), float32 0-dim tensors on
    the generator's device, drawn there without a host sync: with
    probability ``dropout_prob`` one modality is dropped, LiDAR surviving
    with probability ``lidar_prob``; otherwise both are on.  The JAX
    package's ``sample_modality_flags`` (its draws differ: another
    generator)."""
    r = torch.rand(2, generator=generator, device=generator.device)
    drop, lidar = r[0] < dropout_prob, r[1] < lidar_prob
    l_flag = torch.where(drop, lidar.float(), 1.0)
    c_flag = torch.where(drop, (~lidar).float(), 1.0)
    return l_flag, c_flag


def present_flags(img_feats, pts_feats, device):
    """(l_flag, c_flag) of the modalities whose features are given."""
    return (torch.full((), float(pts_feats is not None), device=device),
            torch.full((), float(img_feats is not None), device=device))


@TRANSFORMERS.register_module(name="UniBEVTransformer")
class UniBEVTransformer(nn.Module):

    def __init__(self, embed_dims: int = 256, num_cams: int = 6,
                 fusion_method: str = "linear",
                 feature_norm: Optional[str] = None,
                 spatial_norm: Optional[str] = None,
                 use_modal_embeds: Optional[str] = None,
                 drop_modality=None, dual_queries: bool = False,
                 bev_h: int = 200, bev_w: int = 200,
                 img_encoder: Optional[dict] = None,
                 pts_encoder: Optional[dict] = None,
                 decoder: Optional[dict] = None,
                 use_img: bool = True, use_pts: bool = False):
        # drop_modality is read by the detector, which draws the flags
        super().__init__()
        if fusion_method != "linear":
            raise NotImplementedError(f"fusion_method={fusion_method!r} not yet ported")
        if feature_norm not in (None, "ChannelNormWeights"):
            raise NotImplementedError(f"feature_norm={feature_norm!r} not yet ported")
        if spatial_norm or use_modal_embeds or dual_queries:
            raise NotImplementedError(
                "spatial_norm, use_modal_embeds and dual_queries are not yet ported")
        C = embed_dims
        self.embed_dims = C
        self.bev_h, self.bev_w = bev_h, bev_w
        self.cnw = feature_norm == "ChannelNormWeights"
        if self.cnw:
            self.img_channel_weights = nn.Parameter(torch.empty(C))
            self.pts_channel_weights = nn.Parameter(torch.empty(C))
        # one FPN level in every reference config, on both branches
        if use_img:
            self.cams_embeds = nn.Parameter(torch.empty(num_cams, C))
            self.img_level_embeds = nn.Parameter(torch.empty(1, C))
            self.img_bev_encoder = self._build_encoder(ImgEncoder,
                                                       img_encoder or {})
        if use_pts:
            self.pts_level_embeds = nn.Parameter(torch.empty(1, C))
            self.pts_bev_encoder = self._build_encoder(PtsEncoder,
                                                       pts_encoder or {})
        self.reference_points = nn.Linear(C, 3)
        self.decoder = self._build_decoder(decoder or {})

    def _build_encoder(self, cls, cfg):
        layers = cfg.get("transformerlayers", {}) or {}
        attn_cfgs = layers.get("attn_cfgs", [{}, {}])
        pillar = ({"num_points_in_pillar": cfg.get("num_points_in_pillar", 4)}
                  if cls is ImgEncoder else
                  {"num_points_in_pillar_lidar":
                   cfg.get("num_points_in_pillar_lidar", 4)})
        return cls(
            num_layers=cfg.get("num_layers", 3),
            pc_range=tuple(cfg.get("pc_range", (-54, -54, -5, 54, 54, 3))),
            **pillar, embed_dims=self.embed_dims,
            ffn_dims=layers.get("feedforward_channels", self.embed_dims * 2),
            tsa_cfg=dict(attn_cfgs[0]) if attn_cfgs else None,
            sca_cfg={k: v for k, v in dict(attn_cfgs[1]).items()
                     if k not in ("type", "embed_dims")}
            if len(attn_cfgs) > 1 else None)

    def _build_decoder(self, cfg):
        layers = cfg.get("transformerlayers", {}) or {}
        attn_cfgs = layers.get("attn_cfgs", [{}, {}])
        mha = dict(attn_cfgs[0]) if attn_cfgs else {}
        ca = dict(attn_cfgs[1]) if len(attn_cfgs) > 1 else {}
        return DetectionTransformerDecoder(
            num_layers=cfg.get("num_layers", 6),
            embed_dims=self.embed_dims,
            num_heads=mha.get("num_heads", 8),
            ffn_dims=layers.get("feedforward_channels", self.embed_dims * 2),
            cross_attn_cfg={k: v for k, v in ca.items() if k != "type"})

    def forward(self, img_feats, pts_feats, bev_queries, object_query_embed,
                bev_pos, lidar2img, img_shape, l_flag=None, c_flag=None,
                reg_branches=None):
        """img_feats: list of (B, N, H, W, C) or None (camera absent);
        pts_feats: list of (B, H, W, C) or None (LiDAR absent); at least one
        is given.  bev_queries (HW, C); object_query_embed (Nq, 2C); bev_pos
        (B, HW, C); l_flag / c_flag float32 0-dim, 0 or 1, by default
        :func:`present_flags`.

        Returns (bev_embed, states (L, B, Nq, C), init_ref (B, Nq, 3),
        refs (L, B, Nq, 3), sca_overflow).
        """
        C = self.embed_dims
        feats = img_feats if img_feats is not None else pts_feats
        if feats is None:
            raise ValueError("the transformer needs img_feats or pts_feats")
        B = feats[0].shape[0]
        HW = self.bev_h * self.bev_w
        bev_q = bev_queries[None].expand(B, HW, C)

        img_bev = pts_bev = None
        sca_overflow = torch.zeros((), dtype=torch.int64, device=bev_q.device)
        if img_feats is not None:
            flat, shapes = [], []
            for lvl, feat in enumerate(img_feats):
                _, N, H, W, _ = feat.shape
                f = feat.reshape(B, N, H * W, C) + self.cams_embeds[None, :, None, :]
                flat.append(f + self.img_level_embeds[lvl])
                shapes.append((H, W))
            value = torch.cat(flat, dim=2)                     # (B, N, sumHW, C)
            img_bev, sca_overflow = self.img_bev_encoder(
                bev_q, value, bev_pos, self.bev_h, self.bev_w, lidar2img,
                img_shape, tuple(shapes))
        if pts_feats is not None:
            flat, shapes = [], []
            for lvl, feat in enumerate(pts_feats):
                _, H, W, _ = feat.shape
                flat.append(feat.reshape(B, H * W, C) + self.pts_level_embeds[lvl])
                shapes.append((H, W))
            value = torch.cat(flat, dim=1)                     # (B, sumHW, C)
            pts_bev = self.pts_bev_encoder(bev_q, value, bev_pos, self.bev_h,
                                           self.bev_w, tuple(shapes))

        if l_flag is None or c_flag is None:
            l_flag, c_flag = present_flags(img_feats, pts_feats, bev_q.device)
        # with one input the flags cannot both be on: no softmax, so the CNW
        # weights get no gradient
        both_present = img_bev is not None and pts_bev is not None
        # a missing modality's features are zeros
        img_bev = torch.zeros_like(pts_bev) if img_bev is None else img_bev
        pts_bev = torch.zeros_like(img_bev) if pts_bev is None else pts_bev
        if self.cnw and both_present:
            # each weight is exactly 1.0 unless both flags are on
            joint = torch.softmax(torch.stack([self.img_channel_weights,
                                               self.pts_channel_weights]), 0)
            joint = torch.where((l_flag > 0.5) & (c_flag > 0.5), joint, 1.0)
            img_bev = img_bev * joint[0].to(img_bev.dtype)
            pts_bev = pts_bev * joint[1].to(pts_bev.dtype)
        fused = (c_flag.to(img_bev.dtype) * img_bev
                 + l_flag.to(pts_bev.dtype) * pts_bev)

        query_pos, query = object_query_embed.split(C, dim=1)
        query_pos = query_pos[None].expand(B, -1, -1)
        query = query[None].expand(B, -1, -1)
        reference_points = torch.sigmoid(self.reference_points(query_pos))
        states, refs = self.decoder(query, fused, query_pos, reference_points,
                                    ((self.bev_h, self.bev_w),),
                                    reg_branches=reg_branches)
        return fused, states, reference_points, refs, sca_overflow
