"""Flagship model builder and batches: unibev_nus_LC_cnw_256_modality_dropout.

Counterpart of ``unibev_tpu/flagship.py``.  ``flagship_model_cfg`` returns the
JAX package's flagship dict (full widths: ResNet-101-caffe with DCNv2 in
stages 3-4, the SECOND LiDAR branch on a [41, 1440, 1440] voxel grid,
256-wide BEV features on a 200x200 grid, 6 cameras, 3 encoder layers per
modality and 6 decoder layers, 900 queries) with torch dtypes, with the
JAX package's ``fp8_tables=False`` (plain sparse gather tables).  The LC
model predicts in LC, L (a batch without ``img``) and C (without
``points``) mode::

    model = build_flagship(device="cuda", dtype=torch.bfloat16)
    batch = synthetic_batch(np.random.RandomState(0), device="cuda")
    out = model.predict(batch)                                   # LC
    out_l = model.predict({k: v for k, v in batch.items() if k != "img"})

The camera-only model trains (float32 parameters, bf16 compute under
autocast); LiDAR training is not ported yet::

    model = build_flagship(use_lidar=False, device="cuda", train=True)
    opt, sched = make_optimizer(model)          # parallel/train_state.py
    gen = torch.Generator(device="cuda").manual_seed(0)
    metrics = train_step(model, opt, sched, batch, gen)

``tiny_model_cfg`` / ``tiny_batch`` are a scaled-down C or LC model and batch
(2 cameras, 8x8 BEV, depth-50 backbone, [25, 32, 32] voxel grid) for parity
and smoke checks.
"""

from __future__ import annotations

import numpy as np
import torch

from unibev_tpu_torch.models.detectors.unibev import UniBEV
from unibev_tpu_torch.models.init import init_weights

PC_RANGE = (-54.0, -54.0, -5.0, 54.0, 54.0, 3.0)
VOXEL_SIZE = (0.075, 0.075, 0.2)
DIM = 256


def flagship_model_cfg(use_lidar=True, use_camera=True, dtype=torch.bfloat16):
    """The JAX package's flagship dict (``unibev_tpu/flagship.py``) at its
    defaults (``fp8_tables=False``), with a torch dtype.

    Keys the port does not read (query_chunk, the DCN table dtype,
    drop_modality) are kept so the two dicts stay the same."""
    dim = DIM
    max_voxels = 120000
    img_attn = [
        dict(type="MultiScaleDeformableAttention", embed_dims=dim, num_levels=1),
        # per-camera top-K query capacity of the camera cross-attention:
        # the worst flagship camera hits 10000 pillars, so 10240 drops none
        dict(deformable_attention=dict(embed_dims=dim, num_points=8,
                                       num_levels=1),
             rebatch_k=10240),
    ]
    pts_attn = [
        dict(type="MultiScaleDeformableAttention", embed_dims=dim, num_levels=1),
        dict(deformable_attention=dict(embed_dims=dim, num_points=8,
                                       num_levels=1)),
    ]
    return dict(
        use_grid_mask=True,
        use_lidar=use_lidar,
        use_camera=use_camera,
        img_shape=(900, 1600),
        dtype=dtype,
        pts_voxel_layer=dict(max_num_points=10, voxel_size=VOXEL_SIZE,
                             point_cloud_range=PC_RANGE,
                             max_voxels=(90000, max_voxels)),
        pts_voxel_encoder=dict(type="HardSimpleVFE", num_features=5),
        pts_middle_encoder=dict(in_channels=5, sparse_shape=(41, 1440, 1440),
                                output_channels=128,
                                encoder_channels=((16, 16, 32), (32, 32, 64),
                                                  (64, 64, 128), (128, 128)),
                                encoder_paddings=((0, 0, 1), (0, 0, 1),
                                                  (0, 0, (0, 1, 1)), (0, 0)),
                                capacities=(max_voxels, 90000, 60000, 40000),
                                table_dtype="bf16"),
        pts_backbone=dict(in_channels=256, out_channels=(128, 256),
                          layer_nums=(5, 5), layer_strides=(1, 2)),
        pts_neck=dict(in_channels=(128, 256), out_channels=(dim // 2, dim // 2),
                      upsample_strides=(1, 2), use_conv_for_no_stride=True),
        img_backbone=dict(depth=101, num_stages=4, out_indices=(3,),
                          frozen_stages=1, style="caffe", with_cp=True,
                          dcn=dict(type="DCNv2", deform_groups=1,
                                   table_dtype="bf16"),
                          stage_with_dcn=(False, False, True, True)),
        img_neck=dict(in_channels=(2048,), out_channels=dim, num_outs=1,
                      start_level=0, add_extra_convs="on_output",
                      relu_before_extra_convs=True),
        pts_bbox_head=dict(
            num_classes=10, in_channels=dim, num_query=900,
            bev_h=200, bev_w=200, sync_cls_avg_factor=True,
            with_box_refine=True, as_two_stage=False,
            query_chunk=10000,
            transformer=dict(
                embed_dims=dim,
                fusion_method="linear",
                feature_norm="ChannelNormWeights",
                drop_modality=0.5,
                num_cams=6,
                img_encoder=dict(num_layers=3, pc_range=PC_RANGE,
                                 num_points_in_pillar=4,
                                 transformerlayers=dict(
                                     attn_cfgs=img_attn,
                                     feedforward_channels=dim * 2)),
                pts_encoder=dict(num_layers=3, pc_range=PC_RANGE,
                                 num_points_in_pillar_lidar=4,
                                 transformerlayers=dict(
                                     attn_cfgs=pts_attn,
                                     feedforward_channels=dim * 2)),
                decoder=dict(num_layers=6,
                             transformerlayers=dict(
                                 attn_cfgs=[
                                     dict(embed_dims=dim, num_heads=8,
                                          dropout=0.1),
                                     dict(embed_dims=dim, num_levels=1),
                                 ],
                                 feedforward_channels=dim * 2))),
            bbox_coder=dict(post_center_range=(-61.2, -61.2, -10.0, 61.2,
                                               61.2, 10.0),
                            pc_range=PC_RANGE, max_num=300, num_classes=10),
            positional_encoding=dict(num_feats=dim // 2, row_num_embed=200,
                                     col_num_embed=200),
            loss_cls=dict(use_sigmoid=True, gamma=2.0, alpha=0.25,
                          loss_weight=2.0),
            loss_bbox=dict(loss_weight=0.25),
            pc_range=PC_RANGE),
        train_cfg=dict(pts=dict(assigner=dict(
            cls_cost=dict(type="FocalLossCost", weight=2.0),
            reg_cost=dict(type="BBox3DL1CostBEVFormer", weight=0.25)))),
    )


def build_model(cfg: dict, device="cpu", seed: int = 0,
                train: bool = False) -> UniBEV:
    """UniBEV(**cfg) with seeded random weights on ``device``; the backbone
    runs channels_last.

    Inference (``train=False``): parameters in cfg's dtype, eval mode,
    gradients off.  Training: parameters stay float32 (compute in cfg's dtype
    comes from autocast in the train step), train mode, gradients on except
    for the backbone's frozen stages.
    """
    with torch.device("meta"):
        model = UniBEV(**cfg)
    model = model.to_empty(device=device)
    init_weights(model, torch.Generator(device=device).manual_seed(seed))
    if not train:
        model = model.to(dtype=cfg.get("dtype", torch.float32))
    for name in ("img_backbone", "pts_backbone", "pts_neck"):
        if hasattr(model, name):
            getattr(model, name).to(memory_format=torch.channels_last)
    if train:
        return model.requires_grad_(True).train()
    return model.eval().requires_grad_(False)


def build_flagship(device="cuda", dtype=torch.bfloat16, seed: int = 0,
                   train: bool = False, **kwargs) -> UniBEV:
    """The flagship model with seeded random weights: LC by default,
    ``use_lidar=False`` for the camera-only model (the one that trains)."""
    return build_model(flagship_model_cfg(dtype=dtype, **kwargs), device, seed,
                       train)


def synthetic_batch(rng: np.random.RandomState, B=1, N=6, H=928, W=1600,
                    P=300000, G=64, img_hw=(900, 1600), device="cpu"):
    """Realistic-scale synthetic batch (nuScenes geometry), the JAX package's
    draws from the same ``rng``, as torch tensors on ``device``."""
    img = rng.randn(B, N, H, W, 3).astype(np.float32)
    points = np.empty((B, P, 5), np.float32)
    points[..., 0] = rng.uniform(-54, 54, (B, P))
    points[..., 1] = rng.uniform(-54, 54, (B, P))
    points[..., 2] = rng.uniform(-3, 1, (B, P))
    points[..., 3:] = rng.rand(B, P, 2)
    l2i = np.zeros((B, N, 4, 4), np.float32)
    f = 1266.0
    for n in range(N):
        K = np.array([[f, 0., img_hw[1] / 2, 0.], [0., f, img_hw[0] / 2, 0.],
                      [0., 0., 1., 0.], [0., 0., 0., 1.]], np.float32)
        th = n * np.pi / 3
        R = np.eye(4, dtype=np.float32)
        R[:3, :3] = np.array([[np.cos(th), -np.sin(th), 0.],
                              [0., 0., -1.],
                              [np.sin(th), np.cos(th), 0.]], np.float32)
        l2i[:, n] = K @ R
    gt = np.zeros((B, G, 9), np.float32)
    gt[..., 0:2] = rng.uniform(-50, 50, (B, G, 2))
    gt[..., 2] = rng.uniform(-2, 0, (B, G))
    gt[..., 3:6] = rng.uniform(0.5, 4.0, (B, G, 3))
    gt[..., 6] = rng.uniform(-np.pi, np.pi, (B, G))
    labels = rng.randint(0, 10, (B, G))
    valid = np.broadcast_to(np.arange(G)[None, :] < 40, (B, G)).copy()
    arrays = dict(img=img, points=points, points_mask=np.ones((B, P), bool),
                  lidar2img=l2i, gt_bboxes=gt, gt_labels=labels, gt_valid=valid)
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


TINY_PC_RANGE = (-9.6, -9.6, -2.0, 9.6, 9.6, 2.0)


def tiny_model_cfg(use_lidar=False):
    """The tests' tiny UniBEV (``tests/test_detector.py``: 2 cameras, 8x8
    BEV, depth-50 backbone with DCN in stage 4, dims 32; with ``use_lidar``
    the LiDAR branch on a [25, 32, 32] grid, capacities 2000 / 1500 / 1000 /
    800), float32, with the camera cross-attention rebatched to 16 queries
    per camera (:func:`tiny_batch` hits 12 per camera).  Camera-only by
    default."""
    dim = 32
    sub_attn = [dict(embed_dims=dim, num_levels=1),
                dict(deformable_attention=dict(embed_dims=dim, num_points=4,
                                               num_levels=1))]
    img_attn = [sub_attn[0], dict(sub_attn[1], rebatch_k=16)]
    transformer = dict(
        embed_dims=dim, fusion_method="linear",
        feature_norm="ChannelNormWeights", drop_modality=0.5,
        num_cams=2,
        img_encoder=dict(num_layers=1, pc_range=TINY_PC_RANGE,
                         num_points_in_pillar=2,
                         transformerlayers=dict(attn_cfgs=img_attn,
                                                feedforward_channels=dim * 2)),
        decoder=dict(num_layers=2,
                     transformerlayers=dict(
                         attn_cfgs=[
                             dict(embed_dims=dim, num_heads=4, dropout=0.1),
                             dict(embed_dims=dim, num_levels=1),
                         ],
                         feedforward_channels=dim * 2)))
    cfg = dict(
        use_grid_mask=True, use_lidar=use_lidar, use_camera=True,
        img_shape=(64, 96),
        img_backbone=dict(depth=50, num_stages=4, out_indices=(3,),
                          style="caffe",
                          stage_with_dcn=(False, False, False, True),
                          dcn=dict(type="DCNv2")),
        img_neck=dict(in_channels=(2048,), out_channels=dim, num_outs=1),
        pts_bbox_head=dict(
            num_classes=10, in_channels=dim, num_query=24, bev_h=8, bev_w=8,
            transformer=transformer,
            bbox_coder=dict(post_center_range=(-12, -12, -4, 12, 12, 4),
                            pc_range=TINY_PC_RANGE, max_num=16, num_classes=10),
            positional_encoding=dict(num_feats=dim // 2, row_num_embed=8,
                                     col_num_embed=8),
            pc_range=TINY_PC_RANGE),
        train_cfg=dict(pts=dict(assigner=dict(
            cls_cost=dict(type="FocalLossCost", weight=2.0),
            reg_cost=dict(type="BBox3DL1CostBEVFormer", weight=0.25)))),
    )
    if use_lidar:
        transformer["pts_encoder"] = dict(
            num_layers=1, pc_range=TINY_PC_RANGE, num_points_in_pillar_lidar=2,
            transformerlayers=dict(attn_cfgs=sub_attn,
                                   feedforward_channels=dim * 2))
        cfg.update(
            pts_voxel_layer=dict(max_num_points=5,
                                 voxel_size=(0.6, 0.6, 4.0 / 24),
                                 point_cloud_range=TINY_PC_RANGE,
                                 max_voxels=(2000, 2000)),
            # z chain 25 -> 13 -> 7 -> 3 -> conv_out 1, as the flagship's
            # 41 -> 21 -> 11 -> 5 -> 2
            pts_middle_encoder=dict(in_channels=5, sparse_shape=(25, 32, 32),
                                    output_channels=32,
                                    encoder_channels=((8, 8, 16), (16, 16, 32),
                                                      (32, 32, 32), (32, 32)),
                                    encoder_paddings=((0, 0, 1), (0, 0, 1),
                                                      (0, 0, (0, 1, 1)), (0, 0)),
                                    capacities=(2000, 1500, 1000, 800)),
            pts_backbone=dict(in_channels=32, out_channels=(32, 64),
                              layer_nums=(1, 1), layer_strides=(1, 2)),
            pts_neck=dict(in_channels=(32, 64), out_channels=(16, 16),
                          upsample_strides=(1, 2)))
    return cfg


def tiny_batch(rng: np.random.RandomState, B=1, N=2, P=1024, G=6, device="cpu"):
    """The tests' tiny batch: images (B, N, 64, 96, 3), P LiDAR points
    (x, y, intensity-like extras uniform in +-9 m, z in +-1.8 m) with their
    mask, the pinhole ``lidar2img`` (cameras 90 degrees apart) and G
    ground-truth boxes, the last two padding.  The same draws from ``rng``
    as the JAX package's tests."""
    img = rng.randn(B, N, 64, 96, 3).astype(np.float32)
    points = rng.uniform(-9, 9, (B, P, 5)).astype(np.float32)
    points[..., 2] = rng.uniform(-1.8, 1.8, (B, P))
    l2i = np.zeros((B, N, 4, 4), np.float32)
    for n in range(N):
        K = np.array([[60., 0., 48., 0.], [0., 60., 32., 0.],
                      [0., 0., 1., 0.], [0., 0., 0., 1.]], np.float32)
        R = np.eye(4, dtype=np.float32)
        th = n * np.pi / 2
        R[:3, :3] = np.array([[np.cos(th), -np.sin(th), 0],
                              [0, 0, -1],
                              [np.sin(th), np.cos(th), 0]], np.float32)
        l2i[:, n] = K @ R
    gt = rng.randn(B, G, 9).astype(np.float32)
    gt[..., :2] *= 5
    gt[..., 3:6] = np.abs(gt[..., 3:6]) + 0.5
    labels = rng.randint(0, 10, (B, G))
    valid = np.ones((B, G), bool)
    valid[:, -2:] = False
    arrays = dict(img=img, points=points, points_mask=np.ones((B, P), bool),
                  lidar2img=l2i, gt_bboxes=gt, gt_labels=labels,
                  gt_valid=valid)
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
