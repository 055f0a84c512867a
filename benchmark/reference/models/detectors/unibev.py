"""UniBEV detector: camera and LiDAR or radar branches -> fused BEV head.

Counterpart of ``unibev_tpu/models/detectors/unibev.py``.  The camera branch
is images -> ResNet -> FPN; the LiDAR branch is voxelize + mean VFE ->
SparseEncoder -> SECOND -> SECONDFPN; the radar branch is pillar voxelize +
mean -> PillarFeatureNet -> PointPillarsScatter (kernel K5) -> SECOND ->
SECONDFPN.  LiDAR and radar share SECOND and SECONDFPN and fill the same
("pts") slot of the head, so one batch holds one of them: both raise, as
in the JAX package.  The batch keeps the JAX package's static-shape
contract: ``img`` (B, N, H, W, 3) float, ``points`` (B, P, 5) with
``points_mask`` (B, P), ``radar`` (B, R, 7) with ``radar_mask`` (B, R),
``lidar2img`` (B, N, 4, 4), and for the loss ``gt_bboxes`` (B, G, 9),
``gt_labels`` (B, G) and ``gt_valid`` (B, G); other keys are ignored.  An
LC model runs LC, L (no ``img`` in the batch) or C (no ``points``), an RC
model RC, R or C, as in the JAX package: the modality flags follow from
which inputs are present.

``train()`` mode is the JAX package's ``train=True``: GridMask on the images,
dropout in the transformer and, with both inputs and the config's
``drop_modality``, modality dropout, all drawn from the ``generator`` handed
to ``forward`` (the flags from ``flag_generator`` where one is given: data
parallel ranks draw them from generators seeded alike, so that every rank
drops the same modality); the LiDAR branch's BatchNorms use and update their
batch statistics.  Both branches run whatever the flags say, and the
fusion multiplies a dropped one by 0.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from benchmark.reference.models.backbones.resnet import ResNet
from benchmark.reference.models.backbones.second import SECOND
from benchmark.reference.models.gridmask import grid_mask
from benchmark.reference.models.heads.unibev_head import UniBEVHead
from benchmark.reference.models.layers import rng
from benchmark.reference.models.middle_encoder import SparseEncoder
from benchmark.reference.models.necks.fpn import FPN, SECONDFPN
from benchmark.reference.models.radar import PillarFeatureNet, PointPillarsScatter
from benchmark.reference.models.transformer_fusion import (present_flags,
                                                        sample_modality_flags)
from benchmark.reference.ops.voxelize import voxelize_and_encode
from benchmark.reference.registry import DETECTORS


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
        # pts_voxel_encoder (HardSimpleVFE: the mean is part of the
        # voxelizer) is accepted so that the JAX config dicts build.
        super().__init__()
        if not (use_camera or use_lidar or use_radar):
            raise ValueError("UniBEV needs use_camera, use_lidar or use_radar")
        self.use_camera, self.use_lidar = use_camera, use_lidar
        self.use_radar = use_radar
        self.img_shape = tuple(img_shape)
        self.compute_dtype = dtype
        self.use_grid_mask = use_grid_mask

        if use_camera:
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
                num_outs=ncfg.get("num_outs", 1),
                start_level=ncfg.get("start_level", 0),
                add_extra_convs=ncfg.get("add_extra_convs", "on_output"),
                relu_before_extra_convs=ncfg.get("relu_before_extra_convs",
                                                 True))
        if use_lidar:
            self._build_lidar(pts_voxel_layer, pts_middle_encoder)
        if use_radar:
            self._build_radar(radar_voxel_layer, radar_voxel_encoder,
                              radar_middle_encoder)
        if use_lidar or use_radar:
            self._build_bev_backbone(pts_backbone, pts_neck)
        hcfg = _clean(pts_bbox_head)
        # modality dropout: (dropout probability, LiDAR-survives
        # probability), or None
        drop = (hcfg.get("transformer") or {}).get("drop_modality")
        if isinstance(drop, dict):
            self.drop_modality = (drop.get("dropout_prob", 0.5),
                                  drop.get("lidar_prob", 0.5))
        else:
            self.drop_modality = (float(drop), 0.5) if drop else None
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
            loss_iou=hcfg.get("loss_iou"),
            train_cfg=(train_cfg or {}).get("pts"),
            dual_queries=hcfg.get("dual_queries", False),
            use_img=use_camera, use_pts=use_lidar or use_radar)

    def _build_lidar(self, voxel_layer, middle_encoder):
        vcfg = dict(voxel_layer or {})
        self.voxel_size = tuple(vcfg.get("voxel_size", (0.075, 0.075, 0.2)))
        self.pc_range = tuple(vcfg.get("point_cloud_range",
                                       (-54, -54, -5, 54, 54, 3)))
        mv = vcfg.get("max_voxels", (90000, 120000))
        self.max_voxels = mv[1] if isinstance(mv, (tuple, list)) else mv
        self.max_points_per_voxel = vcfg.get("max_num_points", 10)
        self.grid_size = tuple(
            int(round((self.pc_range[i + 3] - self.pc_range[i]) / self.voxel_size[i]))
            for i in range(3))
        mcfg = _clean(middle_encoder)
        self.pts_middle_encoder = SparseEncoder(
            in_channels=mcfg.get("in_channels", 5),
            sparse_shape=tuple(mcfg.get("sparse_shape", (41, 1440, 1440))),
            output_channels=mcfg.get("output_channels", 128),
            encoder_channels=tuple(tuple(c) for c in mcfg.get(
                "encoder_channels",
                ((16, 16, 32), (32, 32, 64), (64, 64, 128), (128, 128)))),
            encoder_paddings=mcfg.get("encoder_paddings",
                                      ((0, 0, 1), (0, 0, 1), (0, 0, (0, 1, 1)),
                                       (0, 0))),
            capacities=tuple(mcfg.get("capacities",
                                      (120000, 90000, 60000, 40000))),
            table_dtype=mcfg.get("table_dtype", "bf16"))

    def _build_radar(self, voxel_layer, voxel_encoder, middle_encoder):
        """The pillar grid (z collapsed) from the range, as the JAX
        detector reads it: ``max_voxels[1]`` pillars of at most
        ``max_num_points`` points."""
        rv = dict(voxel_layer or {})
        self.radar_voxel_size = tuple(rv.get("voxel_size", (0.8, 0.8, 8.0)))
        self.radar_pc_range = tuple(rv.get("point_cloud_range",
                                           (-54, -54, -5, 54, 54, 3)))
        mv = rv.get("max_voxels", (30000, 40000))
        self.radar_max_voxels = mv[1] if isinstance(mv, (tuple, list)) else mv
        self.radar_max_points = rv.get("max_num_points", 20)
        gx, gy = (int(round((self.radar_pc_range[i + 3] - self.radar_pc_range[i])
                            / self.radar_voxel_size[i])) for i in range(2))
        self.radar_grid = (gx, gy, 1)
        ve = _clean(voxel_encoder)
        self.radar_voxel_encoder = PillarFeatureNet(
            in_channels=ve.get("in_channels", 7),
            feat_channels=tuple(ve.get("feat_channels", (64,))),
            voxel_size=self.radar_voxel_size,
            point_cloud_range=self.radar_pc_range)
        me = _clean(middle_encoder)
        self.radar_middle_encoder = PointPillarsScatter(
            in_channels=me.get("in_channels", 64),
            output_shape=tuple(me.get("output_shape", (gy, gx))))

    def _build_bev_backbone(self, backbone, neck):
        """SECOND and SECONDFPN, which LiDAR and radar share."""
        bcfg = _clean(backbone)
        self.pts_backbone = SECOND(
            in_channels=bcfg.get("in_channels", 256),
            out_channels=tuple(bcfg.get("out_channels", (128, 256))),
            layer_nums=tuple(bcfg.get("layer_nums", (5, 5))),
            layer_strides=tuple(bcfg.get("layer_strides", (1, 2))))
        ncfg = _clean(neck)
        self.pts_neck = SECONDFPN(
            in_channels=tuple(ncfg.get("in_channels", (128, 256))),
            out_channels=tuple(ncfg.get("out_channels", (128, 128))),
            upsample_strides=tuple(ncfg.get("upsample_strides", (1, 2))),
            use_conv_for_no_stride=ncfg.get("use_conv_for_no_stride", True))

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

    @staticmethod
    def _voxelize(points, mask, voxel_size, pc_range, grid, max_voxels,
                  max_points):
        """Each sample's voxels, folded over the batch: (feats (B*V, F),
        coords (B*V, 4) (b, z, y, x), -1 on padding, mask (B*V,), the
        per-sample results)."""
        B = points.shape[0]
        res = [voxelize_and_encode(points[b], mask[b], voxel_size, pc_range,
                                   grid, max_voxels, max_points)
               for b in range(B)]
        vmask = torch.cat([r.mask for r in res])
        batch_idx = torch.arange(B, dtype=torch.int32, device=points.device)
        coords = torch.cat([batch_idx.repeat_interleave(max_voxels)[:, None],
                            torch.cat([r.coords for r in res])], dim=1)
        coords = torch.where(vmask[:, None], coords, -1)
        return torch.cat([r.feats for r in res]), coords, vmask, res

    def extract_pts_feat(self, points: torch.Tensor, points_mask: torch.Tensor):
        """points (B, P, 5), points_mask (B, P) -> (list of one (B, h, w, C)
        BEV map, stats): ``num_distinct_voxels`` (B,) occupied voxels before
        the ``max_voxels`` cap and ``sparse_overflow`` (4,) active sites each
        strided conv found beyond its capacity."""
        B = points.shape[0]
        feats, coords, mask, res = self._voxelize(
            points, points_mask, self.voxel_size, self.pc_range,
            self.grid_size, self.max_voxels, self.max_points_per_voxel)
        bev, overflow = self.pts_middle_encoder(feats.to(self.compute_dtype),
                                                coords, mask, B)
        bev = self.pts_neck(self.pts_backbone(bev))           # (B, C, h, w)
        stats = dict(num_distinct_voxels=torch.stack([r.num_distinct for r in res]),
                     sparse_overflow=overflow)
        return [bev.permute(0, 2, 3, 1)], stats

    def extract_radar_feat(self, radar: torch.Tensor,
                           radar_mask: torch.Tensor):
        """radar (B, R, F), radar_mask (B, R) -> list of one (B, h, w, C) BEV
        map: pillars (the mean of at most ``max_num_points`` points each),
        the pillar feature net, the scatter to the (B, H, W) canvas (K5),
        SECOND and SECONDFPN."""
        B = radar.shape[0]
        feats, coords, mask, _ = self._voxelize(
            radar, radar_mask, self.radar_voxel_size, self.radar_pc_range,
            self.radar_grid, self.radar_max_voxels, self.radar_max_points)
        pillars = self.radar_voxel_encoder(feats.to(self.compute_dtype),
                                           coords[:, 1:], mask)
        bev = self.radar_middle_encoder(pillars, coords, mask, B)
        bev = self.pts_neck(self.pts_backbone(bev))           # (B, C, h, w)
        return [bev.permute(0, 2, 3, 1)]

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None,
                flag_generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """The head's outputs, the modality flags ``l_flag`` / ``c_flag``
        (float32 0-dim; ``l_flag`` is LiDAR's or radar's) and with LiDAR the
        branch's capacity counts (``num_distinct_voxels``,
        ``sparse_overflow``).  Modalities follow from the batch: ``img``,
        ``points`` and ``radar`` are each used when present and built; a
        batch with both ``points`` and ``radar`` raises.  In ``train()``
        mode GridMask, dropout and, with both inputs, modality dropout draw
        from ``generator`` (on the batch's device), which is then required;
        the flags draw from ``flag_generator`` instead where it is given."""
        img = batch.get("img") if self.use_camera else None
        points = batch.get("points") if self.use_lidar else None
        radar = batch.get("radar") if self.use_radar else None
        if img is None and points is None and radar is None:
            raise ValueError("the batch holds no input of a built modality")
        if points is not None and radar is not None:
            raise ValueError("LiDAR and radar are mutually exclusive: both "
                             "fill the head's pts input")
        with rng(generator):
            img_feats = pts_feats = None
            stats = {}
            if img is not None:
                img_feats = self.extract_img_feat(img, generator)
            if points is not None:
                mask = batch.get("points_mask")
                if mask is None:
                    mask = torch.ones(points.shape[:2], dtype=torch.bool,
                                      device=points.device)
                pts_feats, stats = self.extract_pts_feat(points, mask)
            if radar is not None:
                mask = batch.get("radar_mask")
                if mask is None:
                    mask = torch.ones(radar.shape[:2], dtype=torch.bool,
                                      device=radar.device)
                pts_feats = self.extract_radar_feat(radar, mask)
            if (self.training and self.drop_modality
                    and img_feats is not None and pts_feats is not None):
                if flag_generator is None:
                    flag_generator = generator
                if flag_generator is None:
                    raise RuntimeError("a train-mode forward needs a generator")
                l_flag, c_flag = sample_modality_flags(flag_generator,
                                                       *self.drop_modality)
            else:
                device = next(x for x in (img, points, radar)
                              if x is not None).device
                l_flag, c_flag = present_flags(img_feats, pts_feats, device)
            preds = self.pts_bbox_head(img_feats, pts_feats,
                                       batch.get("lidar2img"), self.img_shape,
                                       l_flag, c_flag)
        preds.update(stats, l_flag=l_flag, c_flag=c_flag)
        return preds

    def loss(self, batch: Dict[str, torch.Tensor],
             preds: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The head's losses against the batch's ground truth."""
        return self.pts_bbox_head.loss(preds, batch["gt_bboxes"],
                                       batch["gt_labels"], batch["gt_valid"])

    @torch.inference_mode()
    def predict(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Decoded boxes: bboxes (B, max_num, 9), scores, labels, valid, and
        sca_overflow, the most hit queries any camera had beyond the SCA
        top-K capacity (0 means the rebatch dropped nothing; 0 without
        cameras); with LiDAR also ``num_distinct_voxels`` and
        ``sparse_overflow`` (see :meth:`extract_pts_feat`)."""
        preds = self(batch)
        out = self.pts_bbox_head.get_bboxes(preds)
        for k in ("sca_overflow", "num_distinct_voxels", "sparse_overflow"):
            if k in preds:
                out[k] = preds[k]
        return out
