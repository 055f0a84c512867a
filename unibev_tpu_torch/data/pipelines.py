"""Data pipeline transforms (numpy, on the host).

Counterpart of ``unibev_tpu/data/pipelines.py``, the port's own copy: the
reference's pipeline ops (its first-party transform_3d / loading /
formating ones and the mmdet3d ops its configs name), each registered under
the reference's type string and mapping a results dict to a results dict.
Random transforms draw from the per-sample generator ``results["rng"]``
exactly as the JAX copy does, so both packages give the same items for the
same seed.

``PadShapes`` pads points and ground truth to the static sizes the model
takes and emits plain numpy arrays (no DataContainer).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from unibev_tpu_torch.registry import PIPELINES


# --------------------------------------------------------------------- utils

def _rng(results) -> np.random.Generator:
    """The per-sample generator the dataset seeds (a global one would make
    runs depend on the loader's scheduling)."""
    rng = results.get("rng")
    if rng is None:
        rng = np.random.default_rng()
        results["rng"] = rng
    return rng


def _imnormalize(img, mean, std, to_rgb):
    img = img.astype(np.float32)
    if to_rgb:
        img = img[..., ::-1]
    return (img - mean) / std


# ------------------------------------------------------------------- loading

@PIPELINES.register_module()
class LoadPointsFromFile:
    """nuScenes .bin loader: float32 (N, load_dim) -> use_dim columns."""

    def __init__(self, coord_type="LIDAR", load_dim=5, use_dim=5,
                 file_client_args=None):
        self.load_dim = load_dim
        self.use_dim = list(range(use_dim)) if isinstance(use_dim, int) else use_dim

    def __call__(self, results: Dict[str, Any]) -> Dict[str, Any]:
        path = results["pts_filename"]
        from unibev_tpu_torch.data import native
        points = native.load_points_bin(path, max_points=1 << 22,
                                        dim=self.load_dim)
        results["points"] = points[:, self.use_dim]
        return results


@PIPELINES.register_module()
class LoadPointsFromMultiSweeps:
    """Accumulate up to ``sweeps_num`` past sweeps into the key frame.

    Sweep points are transformed into the key LiDAR frame via the stored
    sensor2lidar rotation/translation; the 5th column holds the time lag.
    """

    def __init__(self, sweeps_num=10, use_dim=(0, 1, 2, 3, 4),
                 pad_empty_sweeps=True, remove_close=True, test_mode=False,
                 file_client_args=None):
        self.sweeps_num = sweeps_num
        self.use_dim = list(use_dim)
        self.pad_empty_sweeps = pad_empty_sweeps
        self.remove_close = remove_close

    @staticmethod
    def _remove_close(points, radius=1.0):
        keep = np.abs(points[:, 0]) >= radius
        keep |= np.abs(points[:, 1]) >= radius
        return points[keep]

    def __call__(self, results: Dict[str, Any]) -> Dict[str, Any]:
        points = results["points"]
        pts = np.concatenate(
            [points[:, :4], np.zeros((len(points), 1), np.float32)], axis=1)
        sweeps: List[Dict] = results.get("sweeps", []) or []
        out = [pts]
        key_ts = results.get("timestamp", 0.0)
        if not sweeps and self.pad_empty_sweeps:
            for _ in range(self.sweeps_num):
                out.append(self._remove_close(pts) if self.remove_close else pts)
        else:
            for sweep in sweeps[:self.sweeps_num]:
                sp = np.fromfile(sweep["data_path"], np.float32).reshape(-1, 5)
                if self.remove_close:
                    sp = self._remove_close(sp)
                r = np.asarray(sweep["sensor2lidar_rotation"], np.float32)
                t = np.asarray(sweep["sensor2lidar_translation"], np.float32)
                sp[:, :3] = sp[:, :3] @ r.T + t
                lag = key_ts - sweep.get("timestamp", key_ts)
                sweep_pts = np.concatenate(
                    [sp[:, :4], np.full((len(sp), 1), lag, np.float32)], axis=1)
                out.append(sweep_pts)
        points = np.concatenate(out, axis=0)[:, self.use_dim]
        results["points"] = points.astype(np.float32)
        return results


@PIPELINES.register_module()
class LoadAnnotations3D:
    def __init__(self, with_bbox_3d=True, with_label_3d=True, **kw):
        self.with_bbox_3d = with_bbox_3d
        self.with_label_3d = with_label_3d

    def __call__(self, results):
        ann = results.get("ann_info", {})
        if self.with_bbox_3d:
            results["gt_bboxes_3d"] = np.asarray(
                ann.get("gt_bboxes_3d", np.zeros((0, 9))), np.float32)
        if self.with_label_3d:
            results["gt_labels_3d"] = np.asarray(
                ann.get("gt_labels_3d", np.zeros((0,))), np.int64)
        return results


@PIPELINES.register_module()
class LoadMultiViewImageFromFiles:
    def __init__(self, to_float32=True, color_type="unchanged"):
        self.to_float32 = to_float32

    def __call__(self, results):
        filenames = results["img_filename"]
        imgs = []
        for f in filenames:
            img = _load_image_bgr(f)
            imgs.append(img.astype(np.float32) if self.to_float32 else img)
        results["img"] = imgs
        results["img_shape"] = imgs[0].shape
        results["ori_shape"] = imgs[0].shape
        return results


def _load_image_bgr(path: str) -> np.ndarray:
    """Minimal JPEG/PNG loader -> BGR uint8 (matches mmcv's cv2 convention)."""
    from PIL import Image
    img = np.asarray(Image.open(path).convert("RGB"))
    return img[..., ::-1].copy()


# ---------------------------------------------------------------- transforms

@PIPELINES.register_module()
class PointsRangeFilter:
    def __init__(self, point_cloud_range):
        self.pc_range = np.asarray(point_cloud_range, np.float32)

    def __call__(self, results):
        p = results["points"]
        m = ((p[:, 0] >= self.pc_range[0]) & (p[:, 0] <= self.pc_range[3])
             & (p[:, 1] >= self.pc_range[1]) & (p[:, 1] <= self.pc_range[4])
             & (p[:, 2] >= self.pc_range[2]) & (p[:, 2] <= self.pc_range[5]))
        results["points"] = p[m]
        return results


@PIPELINES.register_module()
class ObjectRangeFilter:
    """Keep boxes whose xy center is inside the BEV range."""

    def __init__(self, point_cloud_range):
        self.bev_range = np.asarray(point_cloud_range, np.float32)[[0, 1, 3, 4]]

    def __call__(self, results):
        boxes = results["gt_bboxes_3d"]
        labels = results["gt_labels_3d"]
        if len(boxes) == 0:
            return results
        m = ((boxes[:, 0] >= self.bev_range[0]) & (boxes[:, 0] <= self.bev_range[2])
             & (boxes[:, 1] >= self.bev_range[1]) & (boxes[:, 1] <= self.bev_range[3]))
        results["gt_bboxes_3d"] = boxes[m]
        results["gt_labels_3d"] = labels[m]
        return results


@PIPELINES.register_module()
class ObjectNameFilter:
    def __init__(self, classes):
        self.classes = list(classes)

    def __call__(self, results):
        labels = results["gt_labels_3d"]
        m = (labels >= 0) & (labels < len(self.classes))
        results["gt_bboxes_3d"] = results["gt_bboxes_3d"][m]
        results["gt_labels_3d"] = labels[m]
        return results


@PIPELINES.register_module()
class PointShuffle:
    def __call__(self, results):
        idx = _rng(results).permutation(len(results["points"]))
        results["points"] = results["points"][idx]
        return results


@PIPELINES.register_module()
class NormalizeMultiviewImage:
    """Per-view mmcv imnormalize (reference transform_3d.py:61-95)."""

    def __init__(self, mean, std, to_rgb=False):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.to_rgb = to_rgb

    def __call__(self, results):
        results["img"] = [_imnormalize(img, self.mean, self.std, self.to_rgb)
                          for img in results["img"]]
        results["img_norm_cfg"] = dict(mean=self.mean, std=self.std,
                                       to_rgb=self.to_rgb)
        return results


@PIPELINES.register_module()
class PadMultiViewImage:
    """Pad every view to a fixed size or the next multiple of ``size_divisor``
    (reference transform_3d.py:7-58)."""

    def __init__(self, size=None, size_divisor=None, pad_val=0):
        assert (size is None) != (size_divisor is None)
        self.size = size
        self.size_divisor = size_divisor
        self.pad_val = pad_val

    def __call__(self, results):
        padded = []
        for img in results["img"]:
            h, w = img.shape[:2]
            if self.size is not None:
                th, tw = self.size
            else:
                th = int(np.ceil(h / self.size_divisor)) * self.size_divisor
                tw = int(np.ceil(w / self.size_divisor)) * self.size_divisor
            out = np.full((th, tw) + img.shape[2:], self.pad_val, img.dtype)
            out[:h, :w] = img
            padded.append(out)
        results["ori_shape"] = [im.shape for im in results["img"]]
        results["img"] = padded
        results["img_shape"] = [im.shape for im in padded]
        results["pad_shape"] = [im.shape for im in padded]
        results["pad_fixed_size"] = self.size
        results["pad_size_divisor"] = self.size_divisor
        return results


@PIPELINES.register_module()
class PhotoMetricDistortionMultiViewImage:
    """Random brightness/contrast/saturation/hue/channel-swap, applied
    identically in structure to the reference (transform_3d.py:98-195):
    brightness delta 32, contrast/saturation [0.5, 1.5], hue +-18."""

    def __init__(self, brightness_delta=32, contrast_range=(0.5, 1.5),
                 saturation_range=(0.5, 1.5), hue_delta=18):
        self.brightness_delta = brightness_delta
        self.contrast_lower, self.contrast_upper = contrast_range
        self.saturation_lower, self.saturation_upper = saturation_range
        self.hue_delta = hue_delta

    @staticmethod
    def _bgr_to_hsv(img):
        # img float32 BGR, 0-255
        b, g, r = img[..., 0], img[..., 1], img[..., 2]
        maxc = np.maximum(np.maximum(r, g), b)
        minc = np.minimum(np.minimum(r, g), b)
        v = maxc
        delta = maxc - minc
        s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-6), 0)
        rc = np.where(delta > 0, (maxc - r) / np.maximum(delta, 1e-6), 0)
        gc = np.where(delta > 0, (maxc - g) / np.maximum(delta, 1e-6), 0)
        bc = np.where(delta > 0, (maxc - b) / np.maximum(delta, 1e-6), 0)
        h = np.where(maxc == r, bc - gc,
                     np.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
        h = (h * 60.0) % 360.0
        return np.stack([h, s, v], -1)

    @staticmethod
    def _hsv_to_bgr(hsv):
        h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
        h = (h % 360.0) / 60.0
        i = np.floor(h).astype(int) % 6
        f = h - np.floor(h)
        p = v * (1 - s)
        q = v * (1 - s * f)
        t = v * (1 - s * (1 - f))
        r = np.choose(i, [v, q, p, p, t, v])
        g = np.choose(i, [t, v, v, q, p, p])
        b = np.choose(i, [p, p, t, v, v, q])
        return np.stack([b, g, r], -1)

    def __call__(self, results):
        rng = _rng(results)
        imgs = []
        for img in results["img"]:
            img = img.astype(np.float32)
            if rng.integers(2):
                img = img + rng.uniform(-self.brightness_delta,
                                        self.brightness_delta)
            mode = rng.integers(2)
            if mode == 1 and rng.integers(2):
                img = img * rng.uniform(self.contrast_lower,
                                        self.contrast_upper)
            hsv = self._bgr_to_hsv(np.clip(img, 0, 255))
            if rng.integers(2):
                hsv[..., 1] = hsv[..., 1] * rng.uniform(
                    self.saturation_lower, self.saturation_upper)
            if rng.integers(2):
                hsv[..., 0] = hsv[..., 0] + rng.uniform(
                    -self.hue_delta, self.hue_delta)
            img = self._hsv_to_bgr(np.clip(hsv, 0, [360, 1, 255]))
            if mode == 0 and rng.integers(2):
                img = img * rng.uniform(self.contrast_lower,
                                        self.contrast_upper)
            if rng.integers(2):
                img = img[..., rng.permutation(3)]
            imgs.append(img)
        results["img"] = imgs
        return results


@PIPELINES.register_module()
class RandomScaleImageMultiViewImage:
    """Scale all views AND the lidar2img matrices (transform_3d.py:288-327)."""

    def __init__(self, scales=(0.5,)):
        self.scales = list(scales)

    def __call__(self, results):
        scale = self.scales[_rng(results).integers(len(self.scales))]
        imgs = []
        for img in results["img"]:
            h, w = img.shape[:2]
            nh, nw = int(h * scale), int(w * scale)
            yy = (np.arange(nh) / scale).astype(int).clip(0, h - 1)
            xx = (np.arange(nw) / scale).astype(int).clip(0, w - 1)
            imgs.append(img[yy][:, xx])
        results["img"] = imgs
        S = np.eye(4, dtype=np.float32)
        S[0, 0] = S[1, 1] = scale
        results["lidar2img"] = [S @ m for m in results["lidar2img"]]
        results["img_shape"] = [im.shape for im in imgs]
        return results


@PIPELINES.register_module()
class MultiScaleFlipAug3D:
    """Test-time-aug wrapper (mmdet3d semantics, reference test pipelines).

    The reference configs use it with ONE scale and flip=False (config
    :120-144).  Multi-aug TTA is NOT a real capability of the reference
    stack for this model: ``UniBEV.forward_test`` evaluates ``points[0]`` /
    ``img[0]`` and DISCARDS every other aug variant (reference
    unibev_detector.py:296-315 — the num_augs check is commented out and
    there is no aug_test/merge).  We reproduce that first-variant behavior
    (scale[0], no flip) with a warning instead of silently shipping the
    extra variants to a detector that would ignore them.
    """

    def __init__(self, transforms, img_scale=None, pts_scale_ratio=1,
                 flip=False, flip_direction="horizontal", **kwargs):
        import logging

        scales = img_scale if isinstance(img_scale, list) else [img_scale]
        ratios = (pts_scale_ratio if isinstance(pts_scale_ratio, list)
                  else [pts_scale_ratio])
        if flip or len(scales) > 1 or len(ratios) > 1:
            logging.getLogger("unibev_tpu_torch").warning(
                "MultiScaleFlipAug3D: %d scales x %d ratios, flip=%s "
                "requested, but the reference detector only ever consumes "
                "the first aug variant (unibev_detector.py:296-315); "
                "running scale %s, no flip — identical to the reference's "
                "effective behavior.", len(scales), len(ratios), flip,
                scales[0])
        self.transforms = [PIPELINES.build(dict(t)) for t in transforms]

    def __call__(self, results):
        for t in self.transforms:
            results = t(results)
        return results


# --------------------------------------------------------------- formatting

@PIPELINES.register_module(name="DefaultFormatBundle3D")
@PIPELINES.register_module(name="CustomDefaultFormatBundle3D")
class DefaultFormatBundle3D:
    """Stack multi-view images to (N, H, W, 3) float32 (NHWC, the batch
    layout the model takes)."""

    def __init__(self, class_names=None, with_label=True):
        self.class_names = class_names
        self.with_label = with_label

    def __call__(self, results):
        if "img" in results:
            results["img"] = np.stack(results["img"], axis=0).astype(np.float32)
        return results


@PIPELINES.register_module(name="Collect3D")
@PIPELINES.register_module(name="CustomCollect3D")
class Collect3D:
    """Select data keys + stash meta (reference transform_3d.py:199-284)."""

    META_KEYS = ("filename", "ori_shape", "img_shape", "lidar2img",
                 "pad_shape", "scale_factor", "box_type_3d", "img_norm_cfg",
                 "sample_idx", "timestamp", "scene_token", "can_bus")

    def __init__(self, keys, meta_keys=None):
        self.keys = list(keys)
        self.meta_keys = list(meta_keys or self.META_KEYS)

    def __call__(self, results):
        out = {"img_metas": {k: results[k] for k in self.meta_keys
                             if k in results}}
        if "lidar2img" in results:
            out["lidar2img"] = np.asarray(results["lidar2img"], np.float32)
        for k in self.keys:
            if k in results:
                out[k] = results[k]
        return out


@PIPELINES.register_module()
class PadShapes:
    """Pad points and ground truth to static shapes, with their masks."""

    def __init__(self, max_points=300000, max_gt=140):
        self.max_points = max_points
        self.max_gt = max_gt

    def __call__(self, results):
        if "points" in results:
            p = np.asarray(results["points"], np.float32)
            n = min(len(p), self.max_points)
            out = np.zeros((self.max_points, p.shape[1]), np.float32)
            out[:n] = p[:n]
            results["points"] = out
            mask = np.zeros((self.max_points,), bool)
            mask[:n] = True
            results["points_mask"] = mask
        if "gt_bboxes_3d" in results:
            g = np.asarray(results["gt_bboxes_3d"], np.float32)
            if g.shape[-1] == 7:  # no velocity annotations
                g = np.concatenate([g, np.zeros((len(g), 2), np.float32)], -1)
            n = min(len(g), self.max_gt)
            boxes = np.zeros((self.max_gt, 9), np.float32)
            boxes[:n] = g[:n]
            labels = np.zeros((self.max_gt,), np.int32)
            labels[:n] = np.asarray(results["gt_labels_3d"])[:n]
            valid = np.zeros((self.max_gt,), bool)
            valid[:n] = True
            results["gt_bboxes"] = boxes
            results["gt_labels"] = labels
            results["gt_valid"] = valid
        return results


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = []
        for t in transforms:
            if isinstance(t, dict):
                t = PIPELINES.build(t)
            self.transforms.append(t)

    def __call__(self, results):
        for t in self.transforms:
            results = t(results)
            if results is None:
                return None
        return results


# the radar loader registers itself in PIPELINES (it draws from _rng above)
from unibev_tpu_torch.data import radar as _radar  # noqa: E402,F401
