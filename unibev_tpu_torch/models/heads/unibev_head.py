"""UniBEV detection head (DETR3D/BEVFormer-style, NMS-free).

Counterpart of ``unibev_tpu/models/heads/unibev_head.py``: BEV query
embedding (one per modality with ``dual_queries``: the reference's
``bev_embedding_img`` / ``bev_embedding_pts``, the column halves of the JAX
package's one (HW, 2C) embedding), object query embedding, per-decoder-layer
cls/reg branches (independent copies, box refinement), per-layer box decode
against the layer's reference points, NMS-free top-k on the last layer with
z moved from the gravity center to the box bottom, and the training loss
(Hungarian assignment, sigmoid focal classification, L1 on normalized
boxes).  The decoder's width ``dec_dims`` is twice ``in_channels`` for the
cat fusion, which sizes the object queries and the branches.

The reference configs carry ``loss_iou`` (GIoU) at weight 0, a placeholder
neither package computes; a nonzero weight raises.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from unibev_tpu_torch.core.bbox.assigners import HungarianAssigner3D
from unibev_tpu_torch.core.bbox.coders import NMSFreeCoder
from unibev_tpu_torch.core.bbox.util import normalize_bbox
from unibev_tpu_torch.models.layers import (LearnedPositionalEncoding,
                                            inverse_sigmoid, layer_norm)
from unibev_tpu_torch.models.transformer_fusion import UniBEVTransformer
from unibev_tpu_torch.ops.losses import l1_loss, sigmoid_focal_loss
from unibev_tpu_torch.parallel.dist import sum_over_ranks
from unibev_tpu_torch.registry import HEADS
from unibev_tpu_torch.utils.timer import spanned


CODE_SIZE = 10    # (cx, cy, log w, log l, cz, log h, sin, cos, vx, vy)


@functools.lru_cache(maxsize=None)
def _code_weights(weights: tuple, device: torch.device) -> torch.Tensor:
    """The L1 loss's weights per box dimension on ``device``, made once: a
    tensor made from a list on a card is a blocking copy, which waits for
    the card to drain its stream (the loss would stall every step)."""
    return torch.tensor(weights, dtype=torch.float32, device=device)


def cls_branch(dims: int, num_classes: int) -> nn.Sequential:
    """[Linear, LayerNorm, ReLU] * 2 + Linear (reference indices 0,1,3,4,6)."""
    layers = []
    for _ in range(2):
        layers += [nn.Linear(dims, dims), layer_norm(dims), nn.ReLU(inplace=True)]
    return nn.Sequential(*layers, nn.Linear(dims, num_classes))


def reg_branch(dims: int) -> nn.Sequential:
    """[Linear, ReLU] * 2 + Linear (reference indices 0,2,4)."""
    layers = []
    for _ in range(2):
        layers += [nn.Linear(dims, dims), nn.ReLU(inplace=True)]
    return nn.Sequential(*layers, nn.Linear(dims, CODE_SIZE))


@HEADS.register_module(name="UniBEV_Head")
class UniBEVHead(nn.Module):

    def __init__(self, num_classes: int = 10, in_channels: int = 256,
                 num_query: int = 900, bev_h: int = 200, bev_w: int = 200,
                 pc_range: Sequence[float] = (-54, -54, -5, 54, 54, 3),
                 transformer: Optional[dict] = None,
                 bbox_coder: Optional[dict] = None,
                 positional_encoding: Optional[dict] = None,
                 loss_cls: Optional[dict] = None,
                 loss_bbox: Optional[dict] = None,
                 train_cfg: Optional[dict] = None,
                 code_weights: Sequence[float] = (1.0,) * 8 + (0.2, 0.2),
                 dual_queries: bool = False,
                 loss_iou: Optional[dict] = None,
                 use_img: bool = True, use_pts: bool = False):
        super().__init__()
        # mmdet's GIoULoss weighs 1.0 when the config names none
        if loss_iou is not None and dict(loss_iou).get("loss_weight", 1.0) != 0:
            raise ValueError(f"loss_iou {dict(loss_iou)}: the IoU loss is not "
                             f"computed; only weight 0 is accepted")
        self.num_classes = num_classes
        tcfg = {k: v for k, v in dict(transformer or {}).items() if k != "type"}
        self.bev_h, self.bev_w = bev_h, bev_w
        self.pc_range = tuple(pc_range)
        self.transformer = self._build_transformer(
            {**tcfg, "embed_dims": tcfg.get("embed_dims", in_channels),
             "bev_h": bev_h, "bev_w": bev_w},
            dual_queries=tcfg.get("dual_queries", dual_queries),
            use_img=use_img, use_pts=use_pts)
        # the JAX head's width rule, from in_channels
        dec_dims = in_channels * (2 if tcfg.get("fusion_method") == "cat" else 1)
        pe = {k: v for k, v in dict(positional_encoding or {}).items() if k != "type"}
        self.positional_encoding = LearnedPositionalEncoding(
            num_feats=pe.get("num_feats", in_channels // 2),
            row_num_embed=pe.get("row_num_embed", bev_h),
            col_num_embed=pe.get("col_num_embed", bev_w))
        self.dual_queries = bool(dual_queries or tcfg.get("dual_queries"))
        if self.dual_queries:
            self.bev_embedding_img = nn.Embedding(bev_h * bev_w, in_channels)
            self.bev_embedding_pts = nn.Embedding(bev_h * bev_w, in_channels)
        else:
            self.bev_embedding = nn.Embedding(bev_h * bev_w, in_channels)
        self.query_embedding = nn.Embedding(num_query, dec_dims * 2)
        num_layers = (tcfg.get("decoder") or {}).get("num_layers", 6)
        self.cls_branches = nn.ModuleList(
            [cls_branch(dec_dims, num_classes) for _ in range(num_layers)])
        self.reg_branches = nn.ModuleList(
            [reg_branch(dec_dims) for _ in range(num_layers)])
        coder_cfg = {k: v for k, v in dict(bbox_coder or {}).items() if k != "type"}
        coder_cfg.setdefault("pc_range", self.pc_range)
        coder_cfg.setdefault("num_classes", num_classes)
        self.coder = NMSFreeCoder(**coder_cfg)
        acfg = {k: v for k, v in dict((train_cfg or {}).get("assigner") or {}).items()
                if k != "type"}
        self.assigner = HungarianAssigner3D(**acfg)
        lc = dict(loss_cls or {})
        self.cls_weight = lc.get("loss_weight", 2.0)
        self.focal_alpha = lc.get("alpha", 0.25)
        self.focal_gamma = lc.get("gamma", 2.0)
        self.bbox_weight = dict(loss_bbox or {}).get("loss_weight", 0.25)
        self.code_weights = tuple(code_weights)

    @spanned("head")
    def forward(self, img_feats, pts_feats, lidar2img, img_shape,
                l_flag=None, c_flag=None) -> Dict[str, torch.Tensor]:
        """img_feats / pts_feats: lists of (B, N, h, w, C) / (B, h, w, C), or
        None for an absent modality; l_flag / c_flag the modality flags
        (float32 0-dim; by default those of the modalities present).
        Returns all_cls_scores (L, B, Q, ncls), all_bbox_preds (L, B, Q,
        10), bev_embed (B, HW, dec_dims) and sca_overflow (0-dim)."""
        B = (img_feats if img_feats is not None else pts_feats)[0].shape[0]
        bev_pos = self.positional_encoding(B, self.bev_h, self.bev_w)
        if self.dual_queries:
            bev_queries = torch.cat([self.bev_embedding_img.weight,
                                     self.bev_embedding_pts.weight], dim=1)
        else:
            bev_queries = self.bev_embedding.weight
        bev_embed, states, _, refs, sca_overflow = self.transformer(
            img_feats, pts_feats, bev_queries,
            self.query_embedding.weight, bev_pos, lidar2img, img_shape,
            l_flag, c_flag, reg_branches=self.reg_branches)
        return self.decode_layers(states, refs, bev_embed, sca_overflow)

    def _build_transformer(self, tcfg: dict, dual_queries: bool,
                           use_img: bool, use_pts: bool) -> nn.Module:
        """The BEV transformer of the head's ``transformer`` config (its
        width and BEV grid filled in)."""
        return UniBEVTransformer(**{**tcfg, "dual_queries": dual_queries,
                                    "use_img": use_img, "use_pts": use_pts})

    def decode_layers(self, states, refs, bev_embed, sca_overflow
                      ) -> Dict[str, torch.Tensor]:
        """Every decoder layer's class scores and boxes from its states
        (L, B, Q, C) and reference points (L, B, Q, 3): the head's
        outputs, with the BEV map and the SCA overflow passed through."""
        pr = self.pc_range
        cls_all, bbox_all = [], []
        for lvl in range(states.shape[0]):
            reference = inverse_sigmoid(refs[lvl])
            tmp = self.reg_branches[lvl](states[lvl])
            xy = torch.sigmoid(tmp[..., 0:2] + reference[..., 0:2])
            z = torch.sigmoid(tmp[..., 4:5] + reference[..., 2:3])
            cx = xy[..., 0:1] * (pr[3] - pr[0]) + pr[0]
            cy = xy[..., 1:2] * (pr[4] - pr[1]) + pr[1]
            cz = z * (pr[5] - pr[2]) + pr[2]
            bbox_all.append(torch.cat([cx, cy, tmp[..., 2:4], cz, tmp[..., 5:]],
                                      dim=-1))
            cls_all.append(self.cls_branches[lvl](states[lvl]))
        return dict(all_cls_scores=torch.stack(cls_all),
                    all_bbox_preds=torch.stack(bbox_all),
                    bev_embed=bev_embed, sca_overflow=sca_overflow)

    def loss(self, preds: Dict[str, torch.Tensor], gt_bboxes: torch.Tensor,
             gt_labels: torch.Tensor, gt_valid: torch.Tensor) -> Dict[str, torch.Tensor]:
        """gt_bboxes (B, G, 9); gt_labels (B, G); gt_valid (B, G) bool.

        Every decoder layer is assigned at once (L * B problems, one call of
        the solver, K12 on the card; nothing is read back to the host).  The
        average factor is the layer's matched count over the
        batch, clamped at 1; under a process group, over the global batch
        (summed over the ranks, as the JAX mesh's global batch has it), so
        that the ranks' losses sum to the global batch's and every rank must
        call this.  Keys: ``loss_cls`` / ``loss_bbox`` for the last layer and
        ``d{l}.loss_cls`` / ``d{l}.loss_bbox`` for the others.
        """
        all_cls = preds["all_cls_scores"].float()
        all_bbox = preds["all_bbox_preds"].float()
        L, B, Q = all_cls.shape[:3]
        flat_cls = all_cls.reshape(L * B, Q, -1)
        flat_bbox = all_bbox.reshape(L * B, Q, -1)

        def rep(x):
            return x[None].expand(L, *x.shape).reshape(L * B, *x.shape[1:])

        gt_b, gt_l = rep(gt_bboxes.float()), rep(gt_labels.long())
        gt_inds, pos = self.assigner.assign(flat_bbox.detach(), flat_cls.detach(),
                                            gt_b, gt_l, rep(gt_valid))
        labels = torch.where(pos, torch.gather(gt_l, 1, gt_inds),
                             self.num_classes)
        norm_gt = normalize_bbox(gt_b)                          # (LB, G, 10)
        targets = torch.gather(norm_gt, 1, gt_inds[..., None].expand(
            L * B, Q, norm_gt.shape[-1]))
        total_pos = sum_over_ranks(
            pos.reshape(L, B * Q).sum(1).float()).clamp(min=1.0)      # (L,)

        cls_loss = sigmoid_focal_loss(flat_cls, labels, self.num_classes,
                                      alpha=self.focal_alpha,
                                      gamma=self.focal_gamma)
        cls_losses = self.cls_weight * cls_loss.reshape(L, -1).sum(1) / total_pos

        cw = _code_weights(self.code_weights, flat_bbox.device)
        # the reference's isnotnan guard (nuScenes velocities can be NaN);
        # the guarded targets are zeroed first so that no NaN reaches the
        # gradient either
        finite = torch.isfinite(targets).all(-1, keepdim=True)
        targets = torch.where(finite, targets, 0.0)
        diff = l1_loss(flat_bbox, targets) * pos[..., None] * cw
        diff = torch.where(finite, diff, 0.0)
        bbox_losses = self.bbox_weight * diff.reshape(L, -1).sum(1) / total_pos

        losses = {}
        for lvl in range(L):
            prefix = "" if lvl == L - 1 else f"d{lvl}."
            losses[f"{prefix}loss_cls"] = cls_losses[lvl]
            losses[f"{prefix}loss_bbox"] = bbox_losses[lvl]
        return losses

    @spanned("head")
    def get_bboxes(self, preds: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        out = self.coder.decode(preds["all_cls_scores"], preds["all_bbox_preds"])
        boxes = out["bboxes"].clone()
        boxes[..., 2] -= 0.5 * boxes[..., 5]
        out["bboxes"] = boxes
        return out
