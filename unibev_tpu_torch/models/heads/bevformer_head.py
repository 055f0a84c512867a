"""BEVFormer's detection head: UniBEV's head (BEV and object query
embeddings, positional encoding, per-layer class and box branches with box
refinement, NMS-free decoding) over BEVFormer's transformer.

The published ``BEVFormerHead`` is the DETR3D head UniBEV's was derived
from: the branches, the per-layer box decoding against each layer's
reference points and ``get_bboxes`` are ``UniBEVHead``'s, inherited.  What
differs: the transformer (``PerceptionTransformer``), which also takes the
previous BEV map, the CAN bus rows and the history flags, and the range,
which the head takes from its box coder's ``pc_range`` as the published
head does (+-51.2 m for BEVFormer-base), with the BEV cell's size in
metres (``grid_length``) from it.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from unibev_tpu_torch.models.heads.unibev_head import UniBEVHead
from unibev_tpu_torch.models.perception_transformer import \
    PerceptionTransformer
from unibev_tpu_torch.registry import HEADS
from unibev_tpu_torch.utils.timer import spanned


@HEADS.register_module(name="BEVFormerHead")
class BEVFormerHead(UniBEVHead):

    def _build_transformer(self, tcfg: dict, dual_queries: bool,
                           use_img: bool, use_pts: bool) -> nn.Module:
        if dual_queries or use_pts or not use_img:
            raise ValueError("BEVFormer's head takes the cameras alone and "
                             "one set of BEV queries")
        return PerceptionTransformer(**tcfg)

    @spanned("head")
    def forward(self, img_feats, lidar2img, img_shape, prev_bev, can_bus,
                history) -> Dict[str, torch.Tensor]:
        """img_feats: list of (B, N, h, w, C); prev_bev (B, HW, C) or None;
        can_bus (B, 18) float64 and history (B,) bool, as the detector forms
        them.  Returns UniBEVHead's outputs; ``bev_embed`` is the next
        frame's previous map."""
        B = img_feats[0].shape[0]
        bev_pos = self.positional_encoding(B, self.bev_h, self.bev_w)
        pr = self.pc_range
        grid_length = ((pr[4] - pr[1]) / self.bev_h,
                       (pr[3] - pr[0]) / self.bev_w)
        bev_embed, states, _, refs, sca_overflow = self.transformer(
            img_feats, self.bev_embedding.weight, self.query_embedding.weight,
            bev_pos, lidar2img, img_shape, prev_bev, can_bus, history,
            grid_length, reg_branches=self.reg_branches)
        return self.decode_layers(states, refs, bev_embed, sca_overflow)
