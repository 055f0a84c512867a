"""UniBEV detector, camera branch: images -> ResNet -> FPN -> fused BEV head.

Counterpart of ``unibev_tpu/models/detectors/unibev.py`` for the camera-only
(C) mode, inference and training.  The batch keeps the JAX package's
static-shape contract: ``img`` (B, N, H, W, 3) float and ``lidar2img``
(B, N, 4, 4), and for the loss ``gt_bboxes`` (B, G, 9), ``gt_labels`` (B, G)
and ``gt_valid`` (B, G); other keys are ignored.

``train()`` mode is the JAX package's ``train=True``: GridMask on the images
and dropout in the transformer, both drawn from the ``generator`` handed to
``forward``.  In C mode the modality flags are fixed, so there is no
modality dropout.  The LiDAR and radar branches are not ported yet:
``use_lidar=True`` or ``use_radar=True`` raises.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from unibev_tpu_torch.models.backbones.resnet import ResNet
from unibev_tpu_torch.models.gridmask import grid_mask
from unibev_tpu_torch.models.heads.unibev_head import UniBEVHead
from unibev_tpu_torch.models.layers import rng
from unibev_tpu_torch.models.necks.fpn import FPN
from unibev_tpu_torch.registry import DETECTORS


def _clean(cfg: Optional[dict]) -> dict:
    return {k: v for k, v in dict(cfg or {}).items() if k != "type"}


@DETECTORS.register_module(name="UniBEV")
class UniBEV(nn.Module):

    def __init__(self, use_grid_mask: bool = True, use_lidar: bool = True,
                 use_camera: bool = True, use_radar: bool = False,
                 pts_voxel_layer: Optional[dict] = None,
                 pts_voxel_encoder: Optional[dict] = None,
                 pts_middle_encoder: Optional[dict] = None,
                 radar_voxel_layer: Optional[dict] = None,
                 radar_voxel_encoder: Optional[dict] = None,
                 radar_middle_encoder: Optional[dict] = None,
                 pts_backbone: Optional[dict] = None,
                 pts_neck: Optional[dict] = None,
                 img_backbone: Optional[dict] = None,
                 img_neck: Optional[dict] = None,
                 pts_bbox_head: Optional[dict] = None,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None,
                 img_shape: Tuple[int, int] = (900, 1600),
                 dtype: torch.dtype = torch.float32):
        # The pts_*/radar_* configs belong to parts not yet ported; they are
        # accepted so the JAX config dicts build.
        super().__init__()
        if use_lidar or use_radar:
            raise NotImplementedError(
                "LiDAR and radar branches not yet ported: build with "
                "use_lidar=False, use_radar=False")
        if not use_camera:
            raise ValueError("the camera-only detector needs use_camera=True")
        self.img_shape = tuple(img_shape)
        self.compute_dtype = dtype
        self.use_grid_mask = use_grid_mask

        cfg = _clean(img_backbone)
        self.img_backbone = ResNet(
            depth=cfg.get("depth", 101), num_stages=cfg.get("num_stages", 4),
            out_indices=tuple(cfg.get("out_indices", (3,))),
            frozen_stages=cfg.get("frozen_stages", 1),
            style=cfg.get("style", "caffe"),
            with_cp=cfg.get("with_cp", False),
            stage_with_dcn=tuple(cfg.get("stage_with_dcn", (False,) * 4)),
            dcn=cfg.get("dcn"))
        ncfg = _clean(img_neck)
        self.img_neck = FPN(
            in_channels=tuple(ncfg.get("in_channels", (2048,))),
            out_channels=ncfg.get("out_channels", 256),
            num_outs=ncfg.get("num_outs", 1))
        hcfg = _clean(pts_bbox_head)
        # As in the JAX package, the head keeps its default pc_range: the
        # config's pts_bbox_head.pc_range is not passed on.
        self.pts_bbox_head = UniBEVHead(
            num_classes=hcfg.get("num_classes", 10),
            in_channels=hcfg.get("in_channels", 256),
            num_query=hcfg.get("num_query", 900),
            bev_h=hcfg.get("bev_h", 200), bev_w=hcfg.get("bev_w", 200),
            transformer=hcfg.get("transformer"),
            bbox_coder=hcfg.get("bbox_coder"),
            positional_encoding=hcfg.get("positional_encoding"),
            loss_cls=hcfg.get("loss_cls"),
            loss_bbox=hcfg.get("loss_bbox"),
            train_cfg=(train_cfg or {}).get("pts"))

    def extract_img_feat(self, img: torch.Tensor,
                         generator: Optional[torch.Generator] = None):
        """img (B, N, H, W, 3) -> list of (B, N, h, w, C)."""
        B, N, H, W, _ = img.shape
        # an NCHW view of NHWC memory: channels_last without a copy
        x = img.reshape(B * N, H, W, 3).permute(0, 3, 1, 2)
        if self.use_grid_mask and self.training:
            if generator is None:
                raise RuntimeError("a train-mode forward needs a generator")
            x = grid_mask(x, generator)
        feats = self.img_neck(self.img_backbone(x.to(self.compute_dtype)))
        return [f.permute(0, 2, 3, 1).reshape(B, N, f.shape[2], f.shape[3], -1)
                for f in feats]

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """The head's outputs.  In ``train()`` mode GridMask and dropout draw
        from ``generator`` (on the batch's device), which is then required."""
        with rng(generator):
            img_feats = self.extract_img_feat(batch["img"], generator)
            return self.pts_bbox_head(img_feats, None, batch["lidar2img"],
                                      self.img_shape)

    def loss(self, batch: Dict[str, torch.Tensor],
             preds: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The head's losses against the batch's ground truth."""
        return self.pts_bbox_head.loss(preds, batch["gt_bboxes"],
                                       batch["gt_labels"], batch["gt_valid"])

    @torch.inference_mode()
    def predict(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Decoded boxes: bboxes (B, max_num, 9), scores, labels, valid, and
        sca_overflow, the most hit queries any camera had beyond the SCA
        top-K capacity (0 means the rebatch dropped nothing)."""
        preds = self(batch)
        out = self.pts_bbox_head.get_bboxes(preds)
        out["sca_overflow"] = preds["sca_overflow"]
        return out
