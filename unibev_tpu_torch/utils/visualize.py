"""BEV images for the test CLI's ``--show-dir``.

The port's copy of ``unibev_tpu/utils/visualize.py``: the point cloud seen
from above with the predicted (and optionally the ground-truth) boxes as
rotated rectangles, drawn with PIL, imported only when an image is drawn.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Optional, Sequence

import numpy as np

CLASS_COLORS = [
    (66, 135, 245), (245, 130, 66), (66, 245, 149), (245, 66, 133),
    (188, 66, 245), (245, 221, 66), (66, 239, 245), (150, 150, 150),
    (245, 66, 66), (109, 245, 66),
]


def _box_corners_bev(box: np.ndarray) -> np.ndarray:
    """(cx, cy, _, w, l, _, yaw, ...) -> (4, 2) corner polygon."""
    cx, cy, w, l, yaw = box[0], box[1], box[3], box[4], box[6]
    dx, dy = w / 2, l / 2
    local = np.array([[-dx, -dy], [dx, -dy], [dx, dy], [-dx, dy]])
    c, s = np.cos(yaw), np.sin(yaw)
    rot = np.array([[c, -s], [s, c]])
    return local @ rot.T + np.array([cx, cy])


def draw_bev(points: Optional[np.ndarray],
             boxes: Optional[np.ndarray] = None,
             labels: Optional[np.ndarray] = None,
             scores: Optional[np.ndarray] = None,
             gt_boxes: Optional[np.ndarray] = None,
             pc_range: Sequence[float] = (-54, -54, -5, 54, 54, 3),
             size: int = 800):
    """Returns a PIL Image of the BEV scene."""
    from PIL import Image, ImageDraw

    img = Image.new("RGB", (size, size), (20, 20, 26))
    draw = ImageDraw.Draw(img)
    x0, y0, x1, y1 = pc_range[0], pc_range[1], pc_range[3], pc_range[4]

    def to_px(xy):
        px = (xy[..., 0] - x0) / (x1 - x0) * (size - 1)
        py = (1 - (xy[..., 1] - y0) / (y1 - y0)) * (size - 1)
        return px, py

    if points is not None and len(points):
        m = ((points[:, 0] >= x0) & (points[:, 0] <= x1)
             & (points[:, 1] >= y0) & (points[:, 1] <= y1))
        px, py = to_px(points[m])
        for x, y in zip(px[::4].astype(int), py[::4].astype(int)):
            img.putpixel((int(x), int(y)), (90, 100, 110))

    if gt_boxes is not None:
        for box in np.asarray(gt_boxes):
            corners = _box_corners_bev(box)
            px, py = to_px(corners)
            draw.polygon(list(zip(px, py)), outline=(70, 200, 70))

    if boxes is not None:
        labels = labels if labels is not None else np.zeros(len(boxes), int)
        for i, box in enumerate(np.asarray(boxes)):
            color = CLASS_COLORS[int(labels[i]) % len(CLASS_COLORS)]
            corners = _box_corners_bev(box)
            px, py = to_px(corners)
            draw.polygon(list(zip(px, py)), outline=color)
    return img


def save_bev(path: str, **kwargs) -> None:
    os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
    draw_bev(**kwargs).save(path)
