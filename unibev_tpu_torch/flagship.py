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

The LC model trains with modality dropout (float32 parameters, bf16
compute under autocast; ``use_lidar=False`` trains the camera-only model)::

    model = build_flagship(train=True)                           # LC, cuda
    opt, sched = make_optimizer(model)          # parallel/train_state.py
    gen = torch.Generator(device="cuda").manual_seed(0)
    metrics = train_step(model, opt, sched, batch, gen)
    metrics["l_flag"], metrics["c_flag"]        # the modalities it kept

Any config file of ``configs/`` builds the model it describes, as the JAX
CLIs build it (its ``input_modality`` merged into the detector, its
``dtype`` string a torch dtype, float32 where it names none), of the
detector its ``model.type`` names (UniBEV, or BEVFormer for
``configs/bevformer/``)::

    model = build_model_from_config(
        "configs/unibev/unibev_nus_LC_cat_128_modality_dropout.py")

``tiny_model_cfg`` / ``tiny_batch`` are a scaled-down C or LC model and batch
(2 cameras, 8x8 BEV, depth-50 backbone, [25, 32, 32] voxel grid) for parity
and smoke checks.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from unibev_tpu_torch.config.config import Config
# registers BEVFormer beside UniBEV
from unibev_tpu_torch.models.detectors import bevformer  # noqa: F401
from unibev_tpu_torch.models.detectors.unibev import UniBEV
from unibev_tpu_torch.models.init import init_weights
from unibev_tpu_torch.registry import DETECTORS

PC_RANGE = (-54.0, -54.0, -5.0, 54.0, 54.0, 3.0)
VOXEL_SIZE = (0.075, 0.075, 0.2)
RADAR_VOXEL_SIZE = (0.6, 0.6, 8.0)
# the radar loader's point budget (LoadRadarPointsFromMultiSweeps.max_num)
RADAR_POINTS = 2048
DIM = 256


def flagship_model_cfg(use_lidar=True, use_camera=True, dtype=torch.bfloat16,
                       use_radar=False):
    """The JAX package's flagship dict (``unibev_tpu/flagship.py``) at its
    defaults (``fp8_tables=False``), with a torch dtype.

    Keys the port does not read (query_chunk, the DCN table dtype,
    drop_modality) are kept so the two dicts stay the same.

    ``use_radar=True`` (with ``use_lidar=False``) is the full-width RC
    model, which no published config describes: radar in LiDAR's slot,
    0.6 m pillars over the flagship range (a 180x180 grid, the map the
    flagship's SECOND / SECONDFPN and LiDAR SCA take; the JAX defaults'
    0.8 m pillars give 135x135, on which SECONDFPN's two branches come
    back 135 and 136 wide), at most 20 points a pillar and 40,000 pillars,
    a 64-wide ``PillarFeatureNet`` and SECOND on 64 channels."""
    if use_radar and use_lidar:
        raise ValueError("the RC model takes use_lidar=False: LiDAR and "
                         "radar fill the same slot")
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
    cfg = dict(
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
    if use_radar:
        cfg.update(
            use_radar=True,
            radar_voxel_layer=dict(max_num_points=20,
                                   voxel_size=RADAR_VOXEL_SIZE,
                                   point_cloud_range=PC_RANGE,
                                   max_voxels=(30000, 40000)),
            radar_voxel_encoder=dict(in_channels=7, feat_channels=(64,)),
            radar_middle_encoder=dict(in_channels=64, output_shape=(180, 180)))
        cfg["pts_backbone"] = dict(cfg["pts_backbone"], in_channels=64)
    return cfg


def build_model(cfg: dict, device="cuda", seed: int = 0,
                train: bool = False, kind: str = "UniBEV") -> UniBEV:
    """The detector ``kind`` (a registered ``model.type``: UniBEV,
    BEVFormer) of ``cfg`` with seeded random weights on ``device``; the
    backbone runs channels_last.

    Inference (``train=False``): parameters in cfg's dtype, eval mode,
    gradients off.  Training: parameters stay float32 (compute in cfg's dtype
    comes from autocast in the train step), train mode, gradients on except
    for the backbone's frozen stages.  On the ``meta`` device the model has
    shapes and dtypes and no values.
    """
    with torch.device("meta"):
        model = DETECTORS.get(kind)(**cfg)
    if torch.device(device).type != "meta":
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


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _frozen(obj):
    """A config value as plain dicts and tuples (lists become tuples, as the
    flagship dict has them)."""
    if isinstance(obj, dict):
        return {k: _frozen(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return tuple(_frozen(v) for v in obj)
    return obj


def _config(path_or_cfg):
    """A config file's ``Config`` (a path is read; a loaded one passes)."""
    return (Config.fromfile(os.fspath(path_or_cfg))
            if isinstance(path_or_cfg, (str, os.PathLike)) else path_or_cfg)


def detector_type(path_or_cfg) -> str:
    """The config file's ``model.type`` (UniBEV where it names none); a
    type the port has not registered raises."""
    kind = dict(_config(path_or_cfg)["model"]).get("type", "UniBEV")
    if DETECTORS.get(kind) is None:
        raise ValueError(f"the port builds {sorted(DETECTORS._module_dict)} "
                         f"detectors, not {kind!r}")
    return kind


def model_cfg_from_config(path_or_cfg) -> dict:
    """The detector's arguments from a config file (a path, a loaded
    ``Config`` or its dict), as the JAX CLIs and ``tests/test_configs.py``
    take them: ``model`` without its ``type`` (which
    :func:`detector_type` reads), ``use_lidar`` / ``use_camera`` from
    ``input_modality`` where ``model`` does not set them, and the ``dtype``
    string as a torch dtype (float32 where the file gives none, as the JAX
    package defaults)."""
    cfg = _config(path_or_cfg)
    detector_type(cfg)
    model = _frozen(dict(cfg["model"]))
    model.pop("type", None)
    modality = cfg.get("input_modality") or {}
    for key in ("use_lidar", "use_camera"):
        if key in modality:
            model.setdefault(key, modality[key])
    dtype = model.get("dtype", torch.float32)
    model["dtype"] = DTYPES[dtype] if isinstance(dtype, str) else dtype
    return model


def build_model_from_config(path_or_cfg, device="cuda", seed: int = 0,
                            train: bool = False) -> UniBEV:
    """The model a config file describes (:func:`model_cfg_from_config`),
    of the detector its ``model.type`` names, with seeded random weights,
    through :func:`build_model`; the file alone decides the model."""
    cfg = _config(path_or_cfg)
    return build_model(model_cfg_from_config(cfg), device, seed, train,
                       kind=detector_type(cfg))


def build_flagship(device="cuda", dtype=torch.bfloat16, seed: int = 0,
                   train: bool = False, **kwargs) -> UniBEV:
    """The flagship model with seeded random weights: LC by default,
    ``use_lidar=False`` for the camera-only model, ``use_lidar=False,
    use_radar=True`` for the RC model."""
    return build_model(flagship_model_cfg(dtype=dtype, **kwargs), device, seed,
                       train)


def synthetic_batch(rng: np.random.RandomState, B=1, N=6, H=928, W=1600,
                    P=300000, G=64, img_hw=(900, 1600), device="cuda", R=0):
    """Realistic-scale synthetic batch (nuScenes geometry), the JAX package's
    draws from the same ``rng``, as torch tensors on ``device``.

    ``R`` > 0 adds a radar cloud drawn after everything else (so the other
    keys keep their draws): ``radar`` (B, R, 7) with columns (x, y, z, vx,
    vy, rcs, time lag), positions uniform over the flagship range,
    velocities within +-20 m/s, rcs in [-10, 40] dBsm and lags in [0, 0.3]
    s (four sweeps at ~13 Hz), and an all-True ``radar_mask``; the RC
    model takes ``R=RADAR_POINTS``."""
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
        rot = np.eye(4, dtype=np.float32)
        rot[:3, :3] = np.array([[np.cos(th), -np.sin(th), 0.],
                                [0., 0., -1.],
                                [np.sin(th), np.cos(th), 0.]], np.float32)
        l2i[:, n] = K @ rot
    gt = np.zeros((B, G, 9), np.float32)
    gt[..., 0:2] = rng.uniform(-50, 50, (B, G, 2))
    gt[..., 2] = rng.uniform(-2, 0, (B, G))
    gt[..., 3:6] = rng.uniform(0.5, 4.0, (B, G, 3))
    gt[..., 6] = rng.uniform(-np.pi, np.pi, (B, G))
    labels = rng.randint(0, 10, (B, G))
    valid = np.broadcast_to(np.arange(G)[None, :] < 40, (B, G)).copy()
    arrays = dict(img=img, points=points, points_mask=np.ones((B, P), bool),
                  lidar2img=l2i, gt_bboxes=gt, gt_labels=labels, gt_valid=valid)
    if R:
        radar = np.empty((B, R, 7), np.float32)
        for col, (lo, hi) in enumerate(zip(PC_RANGE[:3], PC_RANGE[3:])):
            radar[..., col] = rng.uniform(lo, hi, (B, R))
        radar[..., 3:5] = rng.uniform(-20, 20, (B, R, 2))
        radar[..., 5] = rng.uniform(-10, 40, (B, R))
        radar[..., 6] = rng.uniform(0, 0.3, (B, R))
        arrays.update(radar=radar, radar_mask=np.ones((B, R), bool))
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


TINY_PC_RANGE = (-9.6, -9.6, -2.0, 9.6, 9.6, 2.0)


def tiny_model_cfg(use_lidar=False, fusion="linear",
                   feature_norm="ChannelNormWeights", dual_queries=False,
                   use_radar=False):
    """The tests' tiny UniBEV (``tests/test_detector.py``: 2 cameras, 8x8
    BEV, depth-50 backbone with DCN in stage 4, dims 32; with ``use_lidar``
    the LiDAR branch on a [25, 32, 32] grid, capacities 2000 / 1500 / 1000 /
    800), float32, with the camera cross-attention rebatched to 16 queries
    per camera (:func:`tiny_batch` hits 12 per camera).  Camera-only by
    default.  ``fusion`` / ``feature_norm`` as the tests' config takes them
    (``cat`` runs the decoder at twice the width, as the cat_128 config
    does); ``dual_queries`` gives each modality its BEV queries.
    ``use_radar`` (without ``use_lidar``) is the tests' RC model
    (``tests/test_radar.py``): 1.2 m pillars on a 16x16 grid, at most 8
    points a pillar and 256 pillars, a 32-wide pillar feature net, and the
    LiDAR model's SECOND and SECONDFPN."""
    dim = 32
    dec = dim * (2 if fusion == "cat" else 1)
    sub_attn = [dict(embed_dims=dim, num_levels=1),
                dict(deformable_attention=dict(embed_dims=dim, num_points=4,
                                               num_levels=1))]
    img_attn = [sub_attn[0], dict(sub_attn[1], rebatch_k=16)]
    transformer = dict(
        embed_dims=dim, fusion_method=fusion,
        feature_norm=feature_norm, drop_modality=0.5,
        num_cams=2,
        img_encoder=dict(num_layers=1, pc_range=TINY_PC_RANGE,
                         num_points_in_pillar=2,
                         transformerlayers=dict(attn_cfgs=img_attn,
                                                feedforward_channels=dim * 2)),
        decoder=dict(num_layers=2,
                     transformerlayers=dict(
                         attn_cfgs=[
                             dict(embed_dims=dec, num_heads=4, dropout=0.1),
                             dict(embed_dims=dec, num_levels=1),
                         ],
                         feedforward_channels=dec * 2)))
    if dual_queries:
        transformer["dual_queries"] = True
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
    if dual_queries:
        cfg["pts_bbox_head"]["dual_queries"] = True
    if use_lidar or use_radar:
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
    if use_radar:
        cfg.update(
            use_radar=True,
            radar_voxel_layer=dict(max_num_points=8, voxel_size=(1.2, 1.2, 4.0),
                                   point_cloud_range=TINY_PC_RANGE,
                                   max_voxels=(256, 256)),
            radar_voxel_encoder=dict(in_channels=7, feat_channels=(32,)),
            radar_middle_encoder=dict(in_channels=32, output_shape=(16, 16)),
            pts_backbone=dict(in_channels=32, out_channels=(32, 64),
                              layer_nums=(1, 1), layer_strides=(1, 2)),
            pts_neck=dict(in_channels=(32, 64), out_channels=(16, 16),
                          upsample_strides=(1, 2)))
    return cfg


def tiny_bevformer_cfg():
    """The tests' tiny BEVFormer: the tiny UniBEV's backbone (depth 50, DCN
    in stage 4) on 2 cameras at 64 x 96, two FPN levels (strides 16 and
    32), a 20 x 20 BEV over the tiny range, 2 encoder layers of temporal
    self-attention and 2-level camera SCA (every hit query kept), 2 decoder
    layers, dims 32, float32."""
    dim = 32
    return dict(
        use_grid_mask=True, video_test_mode=True, img_shape=(64, 96),
        img_backbone=dict(depth=50, num_stages=4, out_indices=(2, 3),
                          style="caffe",
                          stage_with_dcn=(False, False, False, True),
                          dcn=dict(type="DCNv2")),
        img_neck=dict(in_channels=(1024, 2048), out_channels=dim, num_outs=2,
                      start_level=0, add_extra_convs="on_output",
                      relu_before_extra_convs=True),
        pts_bbox_head=dict(
            num_classes=10, in_channels=dim, num_query=24, bev_h=20,
            bev_w=20,
            transformer=dict(
                embed_dims=dim, num_cams=2, num_feature_levels=2,
                rotate_center=(10, 10),
                encoder=dict(
                    num_layers=2, pc_range=TINY_PC_RANGE,
                    num_points_in_pillar=2,
                    transformerlayers=dict(
                        attn_cfgs=[
                            dict(type="TemporalSelfAttention",
                                 embed_dims=dim, num_levels=1),
                            dict(deformable_attention=dict(
                                embed_dims=dim, num_points=4, num_levels=2),
                                rebatch_k=400)],
                        feedforward_channels=dim * 2)),
                decoder=dict(
                    num_layers=2,
                    transformerlayers=dict(
                        attn_cfgs=[dict(embed_dims=dim, num_heads=4),
                                   dict(embed_dims=dim, num_levels=1)],
                        feedforward_channels=dim * 2))),
            bbox_coder=dict(post_center_range=(-12, -12, -4, 12, 12, 4),
                            pc_range=TINY_PC_RANGE, max_num=16,
                            num_classes=10),
            positional_encoding=dict(num_feats=dim // 2, row_num_embed=20,
                                     col_num_embed=20)))


def tiny_batch(rng: np.random.RandomState, B=1, N=2, P=1024, G=6, device="cpu",
               R=0):
    """The tests' tiny batch: images (B, N, 64, 96, 3), P LiDAR points
    (x, y, intensity-like extras uniform in +-9 m, z in +-1.8 m) with their
    mask, the pinhole ``lidar2img`` (cameras 90 degrees apart) and G
    ground-truth boxes, the last two padding.  The same draws from ``rng``
    as the JAX package's tests; ``R`` > 0 then draws ``radar`` (B, R, 7)
    uniform in +-9 with an all-True ``radar_mask``, as
    ``tests/test_radar.py`` does after its tiny batch."""
    img = rng.randn(B, N, 64, 96, 3).astype(np.float32)
    points = rng.uniform(-9, 9, (B, P, 5)).astype(np.float32)
    points[..., 2] = rng.uniform(-1.8, 1.8, (B, P))
    l2i = np.zeros((B, N, 4, 4), np.float32)
    for n in range(N):
        K = np.array([[60., 0., 48., 0.], [0., 60., 32., 0.],
                      [0., 0., 1., 0.], [0., 0., 0., 1.]], np.float32)
        rot = np.eye(4, dtype=np.float32)
        th = n * np.pi / 2
        rot[:3, :3] = np.array([[np.cos(th), -np.sin(th), 0],
                                [0, 0, -1],
                                [np.sin(th), np.cos(th), 0]], np.float32)
        l2i[:, n] = K @ rot
    gt = rng.randn(B, G, 9).astype(np.float32)
    gt[..., :2] *= 5
    gt[..., 3:6] = np.abs(gt[..., 3:6]) + 0.5
    labels = rng.randint(0, 10, (B, G))
    valid = np.ones((B, G), bool)
    valid[:, -2:] = False
    arrays = dict(img=img, points=points, points_mask=np.ones((B, P), bool),
                  lidar2img=l2i, gt_bboxes=gt, gt_labels=labels,
                  gt_valid=valid)
    if R:
        arrays.update(radar=rng.uniform(-9, 9, (B, R, 7)).astype(np.float32),
                      radar_mask=np.ones((B, R), bool))
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
