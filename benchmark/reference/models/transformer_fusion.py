"""UniBEVTransformer: camera and LiDAR BEV encoding, feature norms, fusion
with modality flags, object decoder.

Counterpart of ``unibev_tpu/models/transformer_fusion.py``, with every
option of the JAX module:

* ``fusion_method``: ``linear`` (``c * img + l * pts``), ``avg`` (the
  flag-weighted mean, denominator ``max(c + l, 1e-6)``) or ``cat`` (``[img *
  c, pts * l]`` on the channel axis; with ``ModalityProjection`` the
  pseudo-feature form).  ``cat`` runs the decoder and the reference-point
  projection at ``dec_dims = 2 * embed_dims``.
* ``feature_norm``: ``ChannelNormWeights`` (CNW, per-channel weights), the
  four ``*MLP_ChannelNormWeights`` (one Linear(2HW -> 2) and the variant's
  activation over (B, C, 2HW)), or ``ModalityProjection`` (each modality's
  features projected into the other's, concatenated to 2C).
* ``spatial_norm="SpatialNormWeights"``: (HW,) weights per modality.
* ``use_modal_embeds``: ``MLP`` (Linear(2 -> C/2), ReLU, Linear(C/2 -> C),
  ReLU over the flags ``[c, l]``) or ``Fixed`` (an (embed_dims,) embedding
  per modality, scaled by its flag), added to the fused map.
* ``dual_queries``: the BEV queries are (HW, 2C); the first C columns go to
  the camera encoder, the rest to the LiDAR encoder.

The modality flags ``l_flag`` and ``c_flag`` are float32 0-dim tensors, 0
or 1.  Every weighting norm softmaxes the two modalities against each other
only when both flags are on; otherwise each weight is exactly 1.0.  A
missing modality's features are zeros.  The flags come from which inputs
are present (LC, L without ``img_feats``, C without ``pts_feats``, on one LC
model) or, for modality dropout in training, from
:func:`sample_modality_flags`; a dropped modality's branch still runs and
its BEV is multiplied by 0, as in the JAX package.

Parameter names are the reference checkpoint's, its spellings included
(``modal_embbeding_*``); the reference names no ModalityProjection weights,
so those keep the JAX package's names, ``l_modal_proj`` / ``c_modal_proj``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from benchmark.reference.models.decoder import DetectionTransformerDecoder
from benchmark.reference.models.encoders import ImgEncoder, PtsEncoder
from benchmark.reference.registry import TRANSFORMERS

# the MLP-CNW variants and their activations (flax's leaky_relu slope 0.01,
# elu alpha 1)
MLP_CNW = {"MLP_ChannelNormWeights": nn.ReLU,
           "Leaky_ReLU_MLP_ChannelNormWeights": lambda: nn.LeakyReLU(0.01),
           "ELU_MLP_ChannelNormWeights": nn.ELU,
           "Sigmoid_MLP_ChannelNormWeights": nn.Sigmoid}
FEATURE_NORMS = (None, "ChannelNormWeights", "ModalityProjection", *MLP_CNW)


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


def _sca_levels(encoder_cfg: Optional[dict]) -> int:
    """The feature levels an encoder samples: its cross-attention's
    ``num_levels`` (the MSDA default, 1, when the config gives none)."""
    layers = (encoder_cfg or {}).get("transformerlayers") or {}
    attn_cfgs = layers.get("attn_cfgs", [{}, {}])
    sca = dict(attn_cfgs[1]) if len(attn_cfgs) > 1 else {}
    return int((sca.get("deformable_attention") or {}).get("num_levels", 1))


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
        if fusion_method not in ("linear", "avg", "cat"):
            raise NotImplementedError(f"fusion_method={fusion_method!r}")
        if feature_norm not in FEATURE_NORMS:
            raise ValueError(f"unknown feature_norm {feature_norm!r}")
        if spatial_norm not in (None, "SpatialNormWeights"):
            raise ValueError(f"unknown spatial_norm {spatial_norm!r}")
        if use_modal_embeds not in (None, "MLP", "Fixed"):
            raise ValueError(f"unknown use_modal_embeds {use_modal_embeds!r}")
        C = embed_dims
        HW = bev_h * bev_w
        self.embed_dims = C
        self.dec_dims = C * (2 if fusion_method == "cat" else 1)
        self.bev_h, self.bev_w = bev_h, bev_w
        self.fusion_method = fusion_method
        self.feature_norm = feature_norm
        self.spatial_norm = spatial_norm
        self.use_modal_embeds = use_modal_embeds
        self.dual_queries = dual_queries
        if feature_norm == "ChannelNormWeights":
            self.img_channel_weights = nn.Parameter(torch.empty(C))
            self.pts_channel_weights = nn.Parameter(torch.empty(C))
        elif feature_norm in MLP_CNW:
            self.channel_weights_proj = nn.Sequential(
                nn.Linear(2 * HW, 2), MLP_CNW[feature_norm]())
        elif feature_norm == "ModalityProjection":
            self.l_modal_proj = nn.Linear(C, C)
            self.c_modal_proj = nn.Linear(C, C)
        if spatial_norm:
            self.img_spatial_weights = nn.Parameter(torch.empty(HW))
            self.pts_spatial_weights = nn.Parameter(torch.empty(HW))
        if use_modal_embeds == "MLP":
            self.modal_embbeding_mlp = nn.Sequential(
                nn.Linear(2, C // 2), nn.ReLU(), nn.Linear(C // 2, C), nn.ReLU())
        elif use_modal_embeds == "Fixed":
            self.modal_embbeding_C = nn.Parameter(torch.empty(C))
            self.modal_embbeding_L = nn.Parameter(torch.empty(C))
        if use_img:
            self.cams_embeds = nn.Parameter(torch.empty(num_cams, C))
            self.img_level_embeds = nn.Parameter(
                torch.empty(_sca_levels(img_encoder), C))
            self.img_bev_encoder = self._build_encoder(ImgEncoder,
                                                       img_encoder or {})
        if use_pts:
            self.pts_level_embeds = nn.Parameter(
                torch.empty(_sca_levels(pts_encoder), C))
            self.pts_bev_encoder = self._build_encoder(PtsEncoder,
                                                       pts_encoder or {})
        self.reference_points = nn.Linear(self.dec_dims, 3)
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
            embed_dims=self.dec_dims,
            num_heads=mha.get("num_heads", 8),
            ffn_dims=layers.get("feedforward_channels", self.dec_dims * 2),
            cross_attn_cfg={k: v for k, v in ca.items() if k != "type"})

    def channel_feature_norm(self, img_bev, pts_bev, l_flag, c_flag):
        """CNW, MLP-CNW or ModalityProjection on (B, HW, C) BEV features;
        the JAX method of the same name.  A weight is exactly 1.0 unless both
        flags are on."""
        both = (l_flag > 0.5) & (c_flag > 0.5)
        if self.feature_norm == "ChannelNormWeights":
            joint = torch.softmax(torch.stack([self.img_channel_weights,
                                               self.pts_channel_weights]), 0)
            joint = torch.where(both, joint, 1.0)               # (2, C)
            img_bev = img_bev * joint[0].to(img_bev.dtype)
            pts_bev = pts_bev * joint[1].to(pts_bev.dtype)
        elif self.feature_norm in MLP_CNW:
            x = torch.cat([img_bev, pts_bev], dim=1).transpose(1, 2)  # (B, C, 2HW)
            joint = torch.softmax(self.channel_weights_proj(x), -1)   # (B, C, 2)
            joint = torch.where(both, joint, 1.0)
            img_bev = img_bev * joint[:, None, :, 0].to(img_bev.dtype)
            pts_bev = pts_bev * joint[:, None, :, 1].to(pts_bev.dtype)
        elif self.feature_norm == "ModalityProjection":
            pseudo_pts = self.l_modal_proj(img_bev)
            pseudo_img = self.c_modal_proj(pts_bev)
            img_bev = torch.cat([img_bev, pseudo_pts], dim=-1)
            pts_bev = torch.cat([pseudo_img, pts_bev], dim=-1)
        return img_bev, pts_bev

    def spatial_feature_norm(self, img_bev, pts_bev, l_flag, c_flag):
        """SpatialNormWeights: per-cell weights, softmaxed across the two
        modalities when both flags are on, else exactly 1.0."""
        if self.spatial_norm != "SpatialNormWeights":
            return img_bev, pts_bev
        both = (l_flag > 0.5) & (c_flag > 0.5)
        joint = torch.softmax(torch.stack([self.img_spatial_weights,
                                           self.pts_spatial_weights]), 0)
        joint = torch.where(both, joint, 1.0)                   # (2, HW)
        return (img_bev * joint[0, None, :, None].to(img_bev.dtype),
                pts_bev * joint[1, None, :, None].to(pts_bev.dtype))

    def multi_modal_fusion(self, img_bev, pts_bev, l_flag, c_flag):
        """The fused (B, HW, dec_dims) map, plus the modal embedding."""
        lf = l_flag.to(img_bev.dtype)
        cf = c_flag.to(img_bev.dtype)
        if self.fusion_method == "linear":
            fused = cf * img_bev + lf * pts_bev
        elif self.fusion_method == "avg":
            denom = torch.clamp(cf + lf, min=1e-6)
            fused = img_bev * cf / denom + pts_bev * lf / denom
        elif self.feature_norm == "ModalityProjection":
            # cat over the pseudo features: [img, pseudo_img] where the
            # camera is on / off, [pseudo_pts, pts] likewise for LiDAR
            C = self.embed_dims
            img_flags = torch.cat([cf.expand(C), (1 - lf).expand(C)])
            pts_flags = torch.cat([(1 - cf).expand(C), lf.expand(C)])
            fused = img_bev * img_flags + pts_bev * pts_flags
        else:
            fused = torch.cat([img_bev * cf, pts_bev * lf], dim=-1)

        # the embedding is (embed_dims,) even for cat, as in the JAX package
        # (no config combines the two)
        if self.use_modal_embeds == "MLP":
            status = torch.stack([cf, lf])
            emb = self.modal_embbeding_mlp(status.to(
                self.modal_embbeding_mlp[0].weight.dtype))
            fused = fused + emb.to(fused.dtype)[None, None, :]
        elif self.use_modal_embeds == "Fixed":
            emb = cf * self.modal_embbeding_C + lf * self.modal_embbeding_L
            fused = fused + emb.to(fused.dtype)[None, None, :]
        return fused

    def forward(self, img_feats, pts_feats, bev_queries, object_query_embed,
                bev_pos, lidar2img, img_shape, l_flag=None, c_flag=None,
                reg_branches=None):
        """img_feats: list of (B, N, H, W, C) or None (camera absent);
        pts_feats: list of (B, H, W, C) or None (LiDAR absent); at least one
        is given.  bev_queries (HW, C), (HW, 2C) with ``dual_queries``;
        object_query_embed (Nq, 2 * dec_dims); bev_pos (B, HW, C); l_flag /
        c_flag float32 0-dim, 0 or 1, by default :func:`present_flags`.

        Returns (bev_embed (B, HW, dec_dims), states (L, B, Nq, dec_dims),
        init_ref (B, Nq, 3), refs (L, B, Nq, 3), sca_overflow).
        """
        C = self.embed_dims
        feats = img_feats if img_feats is not None else pts_feats
        if feats is None:
            raise ValueError("the transformer needs img_feats or pts_feats")
        B = feats[0].shape[0]
        HW = self.bev_h * self.bev_w
        if self.dual_queries:
            img_q, pts_q = bev_queries[:, :C], bev_queries[:, C:]
        else:
            img_q = pts_q = bev_queries
        device = bev_queries.device

        img_bev = pts_bev = None
        sca_overflow = torch.zeros((), dtype=torch.int64, device=device)
        if img_feats is not None:
            flat, shapes = [], []
            for lvl, feat in enumerate(img_feats):
                _, N, H, W, _ = feat.shape
                f = feat.reshape(B, N, H * W, C) + self.cams_embeds[None, :, None, :]
                flat.append(f + self.img_level_embeds[lvl])
                shapes.append((H, W))
            value = torch.cat(flat, dim=2)                     # (B, N, sumHW, C)
            img_bev, sca_overflow = self.img_bev_encoder(
                img_q[None].expand(B, HW, C), value, bev_pos, self.bev_h,
                self.bev_w, lidar2img, img_shape, tuple(shapes))
        if pts_feats is not None:
            flat, shapes = [], []
            for lvl, feat in enumerate(pts_feats):
                _, H, W, _ = feat.shape
                flat.append(feat.reshape(B, H * W, C) + self.pts_level_embeds[lvl])
                shapes.append((H, W))
            value = torch.cat(flat, dim=1)                     # (B, sumHW, C)
            pts_bev = self.pts_bev_encoder(pts_q[None].expand(B, HW, C), value,
                                           bev_pos, self.bev_h, self.bev_w,
                                           tuple(shapes))

        if l_flag is None or c_flag is None:
            l_flag, c_flag = present_flags(img_feats, pts_feats, device)
        # with one input the flags cannot both be on: every weight would be
        # exactly 1.0, so the weighting norms are skipped and their weights
        # get no gradient (ModalityProjection still runs: it sets the width)
        both_present = img_bev is not None and pts_bev is not None
        # a missing modality's features are zeros
        img_bev = torch.zeros_like(pts_bev) if img_bev is None else img_bev
        pts_bev = torch.zeros_like(img_bev) if pts_bev is None else pts_bev
        if both_present or self.feature_norm == "ModalityProjection":
            img_bev, pts_bev = self.channel_feature_norm(img_bev, pts_bev,
                                                         l_flag, c_flag)
        if both_present:
            img_bev, pts_bev = self.spatial_feature_norm(img_bev, pts_bev,
                                                         l_flag, c_flag)
        fused = self.multi_modal_fusion(img_bev, pts_bev, l_flag, c_flag)

        query_pos, query = object_query_embed.split(self.dec_dims, dim=1)
        query_pos = query_pos[None].expand(B, -1, -1)
        query = query[None].expand(B, -1, -1)
        reference_points = torch.sigmoid(self.reference_points(query_pos))
        states, refs = self.decoder(query, fused, query_pos, reference_points,
                                    ((self.bev_h, self.bev_w),),
                                    reg_branches=reg_branches)
        return fused, states, reference_points, refs, sca_overflow
