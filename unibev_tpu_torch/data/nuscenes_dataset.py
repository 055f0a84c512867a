"""NuScenesDataset, without the nuScenes devkit.

Counterpart of ``unibev_tpu/data/nuscenes_dataset.py``, the port's own
copy.  It reads the info files of ``tools/create_data.py`` (an mmdet3d v0.18
pickle, or a JSON with the same fields) and runs the registered pipeline per
sample; evaluation uses ``unibev_tpu_torch/data/eval.py``.
``SyntheticNuScenes`` gives the same batch contract without data on disk:
the port's ``flagship.synthetic_batch`` drawn on the CPU, as numpy.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import pickle
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from unibev_tpu_torch.data.pipelines import Compose
from unibev_tpu_torch.registry import DATASETS

DEFAULT_CLASSES = (
    "car", "truck", "trailer", "bus", "construction_vehicle", "bicycle",
    "motorcycle", "pedestrian", "traffic_cone", "barrier")

# mmdet3d v0.18 nuScenes name -> detection class mapping.
NAME_MAPPING = {
    "movable_object.barrier": "barrier",
    "vehicle.bicycle": "bicycle",
    "vehicle.bus.bendy": "bus",
    "vehicle.bus.rigid": "bus",
    "vehicle.car": "car",
    "vehicle.construction": "construction_vehicle",
    "vehicle.motorcycle": "motorcycle",
    "human.pedestrian.adult": "pedestrian",
    "human.pedestrian.child": "pedestrian",
    "human.pedestrian.construction_worker": "pedestrian",
    "human.pedestrian.police_officer": "pedestrian",
    "movable_object.trafficcone": "traffic_cone",
    "vehicle.trailer": "trailer",
    "vehicle.truck": "truck",
}

CAM_ORDER = ("CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_FRONT_LEFT", "CAM_BACK",
             "CAM_BACK_LEFT", "CAM_BACK_RIGHT")


def _load_infos(path: str):
    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            data = pickle.load(f)
    else:
        with open(path) as f:
            data = json.load(f)
    if isinstance(data, dict):
        infos = data.get("infos", data.get("data_list", []))
        metadata = data.get("metadata", {})
    else:
        infos, metadata = data, {}
    return infos, metadata


def lidar2img_from_info(cam_info: Dict[str, Any]) -> np.ndarray:
    """4x4 lidar->image matrix from an mmdet3d v0.18 camera info dict."""
    r = np.asarray(cam_info["sensor2lidar_rotation"], np.float64)
    t = np.asarray(cam_info["sensor2lidar_translation"], np.float64)
    lidar2cam = np.eye(4)
    lidar2cam[:3, :3] = r.T
    lidar2cam[:3, 3] = -r.T @ t
    intr = np.asarray(cam_info["cam_intrinsic"], np.float64)
    viewpad = np.eye(4)
    viewpad[:intr.shape[0], :intr.shape[1]] = intr
    return (viewpad @ lidar2cam).astype(np.float32)


@DATASETS.register_module()
class NuScenesDataset:
    def __init__(self, ann_file: str, pipeline: Sequence[dict],
                 data_root: str = "", classes: Sequence[str] = DEFAULT_CLASSES,
                 modality: Optional[dict] = None, test_mode: bool = False,
                 use_valid_flag: bool = False, load_interval: int = 1,
                 box_type_3d: str = "LiDAR", filter_empty_gt: bool = True,
                 max_points: int = 300000, max_gt: int = 140,
                 with_velocity: bool = True, seed: int = 0, **kwargs):
        self.data_root = data_root
        self.seed = seed
        self.epoch = 0   # bump per epoch for fresh augmentations
        self.classes = list(classes)
        self.modality = modality or dict(use_lidar=True, use_camera=True)
        self.test_mode = test_mode
        self.use_valid_flag = use_valid_flag
        self.with_velocity = with_velocity
        self.max_points = max_points
        self.max_gt = max_gt
        path = ann_file if osp.isabs(ann_file) else osp.join(data_root, ann_file)
        self.infos, self.metadata = _load_infos(path)
        self.infos = list(self.infos)[::load_interval]
        # sort by timestamp like mmdet3d
        try:
            self.infos = sorted(self.infos, key=lambda e: e["timestamp"])
        except (KeyError, TypeError):
            pass
        self.pipeline = Compose(list(pipeline) +
                                [dict(type="PadShapes", max_points=max_points,
                                      max_gt=max_gt)])

    def __len__(self):
        return len(self.infos)

    # ------------------------------------------------------------- raw info

    def get_data_info(self, index: int) -> Dict[str, Any]:
        info = self.infos[index]
        results: Dict[str, Any] = dict(
            sample_idx=info.get("token", index),
            pts_filename=self._abspath(info.get("lidar_path", "")),
            sweeps=[{**s, "data_path": self._abspath(s.get("data_path", ""))}
                    for s in info.get("sweeps", [])],
            timestamp=info.get("timestamp", 0) / 1e6,
            scene_token=info.get("scene_token", ""),
        )
        if self.modality.get("use_camera"):
            img_files, l2i = [], []
            cams = info.get("cams", {})
            for cam in CAM_ORDER:
                if cam not in cams:
                    continue
                c = cams[cam]
                img_files.append(self._abspath(c["data_path"]))
                l2i.append(lidar2img_from_info(c))
            results["img_filename"] = img_files
            results["lidar2img"] = l2i
        if not self.test_mode:
            results["ann_info"] = self.get_ann_info(index)
        return results

    def _abspath(self, p: str) -> str:
        if not p or osp.isabs(p):
            return p
        return osp.join(self.data_root, p)

    def get_ann_info(self, index: int) -> Dict[str, Any]:
        info = self.infos[index]
        if self.use_valid_flag and "valid_flag" in info:
            mask = np.asarray(info["valid_flag"], bool)
        else:
            mask = np.asarray(info.get("num_lidar_pts",
                                       [1] * len(info.get("gt_names", [])))) > 0
        boxes = np.asarray(info.get("gt_boxes", np.zeros((0, 7))),
                           np.float32).reshape(-1, 7)
        names = list(info.get("gt_names", []))
        labels = np.array(
            [self.classes.index(NAME_MAPPING.get(n, n))
             if NAME_MAPPING.get(n, n) in self.classes else -1 for n in names],
            np.int64) if names else np.zeros((0,), np.int64)
        if self.with_velocity:
            vel = np.asarray(info.get("gt_velocity",
                                      np.zeros((len(boxes), 2))), np.float32)
            vel = np.nan_to_num(vel)
            boxes = np.concatenate([boxes, vel.reshape(-1, 2)], axis=-1)
        if len(mask) == len(boxes):
            boxes, labels = boxes[mask], labels[mask]
        keep = labels >= 0
        ann = dict(gt_bboxes_3d=boxes[keep], gt_labels_3d=labels[keep])
        if "lidar2ego_rotation" in info:
            ann["l2e_rot"] = np.asarray(info["lidar2ego_rotation"],
                                        np.float64).reshape(3, 3)
            ann["l2e_trans"] = np.asarray(info["lidar2ego_translation"],
                                          np.float64).reshape(3)
        return ann

    # ------------------------------------------------------------- pipeline

    def __getitem__(self, index: int) -> Dict[str, Any]:
        results = self.get_data_info(index)
        results["box_type_3d"] = "LiDAR"
        # per-sample seeded generator: the same augmentations whatever the
        # loader's workers and their order (--seed)
        results["rng"] = np.random.default_rng(
            (self.seed * 1_000_003 + self.epoch * 97 + index) & 0x7FFFFFFF)
        return self.pipeline(results)


@DATASETS.register_module()
class SyntheticNuScenes:
    """Synthetic stand-in with the exact batch contract of NuScenesDataset:
    sample ``index`` is ``flagship.synthetic_batch`` of
    ``RandomState(seed + index)`` at B=1, drawn on the CPU."""

    def __init__(self, length: int = 8, num_cams: int = 6,
                 img_hw=(928, 1600), max_points: int = 300000,
                 max_gt: int = 140, seed: int = 0, classes=DEFAULT_CLASSES,
                 **kwargs):
        self.length = length
        self.num_cams = num_cams
        self.img_hw = img_hw
        self.max_points = max_points
        self.max_gt = max_gt
        self.seed = seed
        self.classes = list(classes)

    def __len__(self):
        return self.length

    def __getitem__(self, index: int) -> Dict[str, Any]:
        from unibev_tpu_torch.flagship import synthetic_batch
        rng = np.random.RandomState(self.seed + index)
        b = synthetic_batch(rng, B=1, N=self.num_cams, H=self.img_hw[0],
                            W=self.img_hw[1], P=self.max_points, G=self.max_gt,
                            device="cpu")
        out = {k: v[0].numpy() for k, v in b.items()}
        # int32 labels, as PadShapes gives them
        out["gt_labels"] = out["gt_labels"].astype(np.int32)
        out["img_metas"] = dict(sample_idx=index)
        return out


def collate(samples: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack per-sample dicts into a batch; img_metas becomes a list."""
    batch: Dict[str, Any] = {}
    for k in samples[0]:
        if k == "img_metas":
            batch[k] = [s[k] for s in samples]
        else:
            batch[k] = np.stack([np.asarray(s[k]) for s in samples])
    return batch
