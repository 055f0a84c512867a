"""BEVFormer detector, written from the published ``bevformer.py``
(fundamentalvision/BEVFormer, ``projects/mmdet3d_plugin/bevformer/
detectors``): its ``forward_test`` in ``video_test_mode``, one sample a
forward.

The camera branch is the reference's (the shared detector's constructor
builds the ResNet and the FPN of the config, and its ``extract_img_feat``
runs them); the head is BEVFormer's (``models/bevformer.py``).  The state
is the published ``prev_frame_info``: the previous BEV map, the scene, the
previous pose ``can_bus[:3]`` and yaw ``can_bus[-1]``, the deltas formed in
float64 on the host.  The batch holds ``img``, ``lidar2img``, ``can_bus``
(1, 18) float64 and ``scene_id`` (1,); a batch of another size raises.
The output adds ``history`` (1,) bool, whether the frame used a previous
map, and ``scene_frame`` (1,), the frame's index in its scene (the frames
with history since the scene's first).
"""

from __future__ import annotations

import copy
from typing import Dict, Optional, Tuple

import torch

from benchmark.reference.models.bevformer import BEVFormerHead
from benchmark.reference.models.detectors.unibev import UniBEV


class BEVFormer(UniBEV):

    def __init__(self, use_grid_mask: bool = True,
                 video_test_mode: bool = True,
                 img_backbone: Optional[dict] = None,
                 img_neck: Optional[dict] = None,
                 pts_bbox_head: Optional[dict] = None,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None,
                 img_shape: Tuple[int, int] = (928, 1600),
                 dtype: torch.dtype = torch.float32,
                 use_camera: bool = True, use_lidar: bool = False):
        # the shared constructor builds the camera branch (and a head of
        # its own, replaced here)
        super().__init__(use_grid_mask=use_grid_mask, use_lidar=False,
                         use_camera=True, img_backbone=img_backbone,
                         img_neck=img_neck, img_shape=img_shape, dtype=dtype)
        self.pts_bbox_head = BEVFormerHead(**dict(pts_bbox_head))
        self.video_test_mode = video_test_mode
        self.prev_frame_info = {"prev_bev": None, "scene_token": None,
                                "prev_pos": 0, "prev_angle": 0, "frame": 0}

    def forward(self, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        # float32 throughout: a float32 matmul or convolution on the card
        # may otherwise run in TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        img = batch["img"]
        if img.shape[0] != 1:
            raise ValueError("the reference runs one sample a forward")
        scene = int(batch["scene_id"][0])
        can_bus = batch["can_bus"][0].double().cpu().numpy().copy()
        info = self.prev_frame_info
        if scene != info["scene_token"]:
            # the first sample of each scene is truncated
            info["prev_bev"] = None
        info["scene_token"] = scene
        if not self.video_test_mode:
            info["prev_bev"] = None
        tmp_pos = copy.deepcopy(can_bus[:3])
        tmp_angle = copy.deepcopy(can_bus[-1])
        if info["prev_bev"] is not None:
            can_bus[:3] -= info["prev_pos"]
            can_bus[-1] -= info["prev_angle"]
        else:
            can_bus[-1] = 0
            can_bus[:3] = 0
        history = info["prev_bev"] is not None
        info["frame"] = info["frame"] + 1 if history else 0
        img_feats = self.extract_img_feat(img)
        preds = self.pts_bbox_head(img_feats, batch["lidar2img"],
                                   self.img_shape, info["prev_bev"],
                                   can_bus[None])
        info["prev_pos"] = tmp_pos
        info["prev_angle"] = tmp_angle
        info["prev_bev"] = preds["bev_embed"]
        preds["history"] = torch.tensor([history], device=img.device)
        preds["scene_frame"] = torch.tensor([info["frame"]],
                                            device=img.device)
        return preds
