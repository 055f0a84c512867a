"""BEVFormer detector: six cameras -> ResNet -> FPN -> BEV encoder with
temporal self-attention over the previous frame's BEV map -> decoder and
head, frame by frame.

Written from the published ``bevformer.py`` (fundamentalvision/BEVFormer,
``projects/mmdet3d_plugin/bevformer/detectors``) in its ``video_test_mode``:
the camera branch, head and decoding are UniBEV's (inherited: the port's
``ResNet``, ``FPN``, ``extract_img_feat`` and ``UniBEVHead``'s branches and
``get_bboxes``), the head BEVFormer's (``BEVFormerHead``, its range the
box coder's).

The state is the published ``prev_frame_info`` kept per batch slot
(:class:`SceneHistory`, ``history``): the previous frame's BEV map (the
encoder's output), its ego position ``can_bus[:3]`` (float64) and yaw
``can_bus[-1]`` (degrees), and its ``scene_id``.  Where a slot's scene
goes on, the frame's CAN bus row becomes ``can_bus[:3] - prev_pos`` and
``can_bus[-1] - prev_angle``; where it starts, or where no state is held,
those are zero and the slot uses no history.  All of it stays on the
device: no ``.item()``, no host copy.  The state lives outside the
``state_dict``.  ``predict`` returns ``history`` (B,) bool, whether each
sample used a previous map, and ``scene_frame`` (B,) int64, the frame's
index in its scene as the state counts it (0 where one starts): a state
that leaks across scenes, or restarts within one, shows in it at every
frame, where the maps' error from a wrong history fades within a few
frames.  The batch takes UniBEV's ``img`` and ``lidar2img`` and, besides,
``can_bus`` (B, 18) float64 (nuScenes' layout, absolute: [0:3] position,
[-2] yaw in radians, [-1] the same in degrees) and ``scene_id`` (B,)
int64.

Noted departures from the published code: every LayerNorm takes the
port's eps, 1e-6, where mmcv's is 1e-5 (below 1e-5 relative at
unit-variance activations; the benchmark's reference does the same); the
temporal self-attention reads each sample's own previous map
(``models/attention/temporal.py``).  Training is not ported: the
published training forward builds the previous map from a queue of
earlier frames; this detector serves.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from unibev_tpu_torch.models.detectors.unibev import UniBEV
from unibev_tpu_torch.models.heads.bevformer_head import BEVFormerHead
from unibev_tpu_torch.models.layers import rng
from unibev_tpu_torch.registry import DETECTORS


class SceneHistory(nn.Module):
    """The previous frame of each batch slot: BEV map, pose, yaw, scene.
    Plain attributes, not buffers: no ``state_dict`` entry, no dtype cast.
    A batch of another size than the state's starts over."""

    def __init__(self):
        super().__init__()
        self.reset()

    def reset(self) -> None:
        self._bev = self._pos = self._angle = self._scene = None
        self._frame = None

    def forward(self, can_bus: torch.Tensor, scene_id: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor],
                           torch.Tensor]:
        """-> (the frame's CAN bus rows with the deltas (B, 18) float64,
        history (B,) bool, the stored previous maps (B, HW, C) or None, the
        frame's index in its scene (B,) int64, 0 where it starts one)."""
        can_bus = can_bus.to(torch.float64)
        B = can_bus.shape[0]
        if self._bev is None or self._bev.shape[0] != B:
            history = torch.zeros(B, dtype=torch.bool, device=can_bus.device)
            prev = None
            pos = torch.zeros_like(can_bus[:, :3])
            angle = torch.zeros_like(can_bus[:, -1:])
            frame = torch.zeros(B, dtype=torch.int64, device=can_bus.device)
        else:
            history = scene_id == self._scene
            prev = self._bev
            keep = history[:, None]
            pos = torch.where(keep, can_bus[:, :3] - self._pos, 0.0)
            angle = torch.where(keep, can_bus[:, -1:] - self._angle, 0.0)
            frame = torch.where(history, self._frame + 1, 0)
        return (torch.cat([pos, can_bus[:, 3:-1], angle], 1), history, prev,
                frame)

    def keep(self, bev: torch.Tensor, can_bus: torch.Tensor,
             scene_id: torch.Tensor, frame: torch.Tensor) -> None:
        """Hold this frame's map (B, HW, C), pose, scene and index for the
        next."""
        can_bus = can_bus.to(torch.float64)
        self._bev, self._scene, self._frame = bev, scene_id, frame
        self._pos, self._angle = can_bus[:, :3], can_bus[:, -1:]


@DETECTORS.register_module(name="BEVFormer")
class BEVFormer(UniBEV):

    PREDICT_KEYS = UniBEV.PREDICT_KEYS + ("history", "scene_frame")

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
        if use_lidar or not use_camera:
            raise ValueError("BEVFormer takes the cameras alone")
        if not video_test_mode:
            raise ValueError("the port's BEVFormer serves in video_test_mode "
                             "alone, as published")
        super().__init__(use_grid_mask=use_grid_mask, use_lidar=False,
                         use_camera=True, img_backbone=img_backbone,
                         img_neck=img_neck, pts_bbox_head=pts_bbox_head,
                         train_cfg=train_cfg, test_cfg=test_cfg,
                         img_shape=img_shape, dtype=dtype)
        self.video_test_mode = video_test_mode
        self.history = SceneHistory()

    def _build_head(self, hcfg: dict, train_cfg: Optional[dict],
                    use_img: bool, use_pts: bool) -> nn.Module:
        coder = dict(hcfg.get("bbox_coder") or {})
        return BEVFormerHead(**self._head_args(hcfg, train_cfg),
                             pc_range=tuple(coder["pc_range"]),
                             use_img=use_img, use_pts=use_pts)

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """The head's outputs for one frame of each slot, with ``history``,
        ``scene_frame`` and ``sca_overflow``; the frame's BEV map is kept
        for the next."""
        if self.training:
            raise NotImplementedError("BEVFormer is served frame by frame; "
                                      "its training is not ported")
        with rng(generator):
            img_feats = self.extract_img_feat(batch["img"], generator)
            can_bus, history, prev, frame = self.history(batch["can_bus"],
                                                         batch["scene_id"])
            preds = self.pts_bbox_head(img_feats, batch["lidar2img"],
                                       self.img_shape, prev, can_bus, history)
        self.history.keep(preds["bev_embed"], batch["can_bus"],
                          batch["scene_id"], frame)
        preds.update(history=history, scene_frame=frame)
        return preds
