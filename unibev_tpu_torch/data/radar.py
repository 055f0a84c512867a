"""Radar point loading (devkit-free).

Counterpart of ``unibev_tpu/data/radar.py``, the port's own copy (numpy on
the host, no JAX): nuScenes radar .pcd parsing, multi-sweep accumulation
with compensated velocities rotated into the LiDAR frame, pad-or-drop to a
fixed point budget (drawn from the per-sample generator, as every random
transform of ``pipelines.py``), and velocity-aware geometric ops.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from unibev_tpu_torch.data.pipelines import _rng
from unibev_tpu_torch.registry import PIPELINES

# nuScenes radar pcd field order (18 fields).
RADAR_FIELDS = ("x", "y", "z", "dyn_prop", "id", "rcs", "vx", "vy",
                "vx_comp", "vy_comp", "is_quality_valid", "ambig_state",
                "x_rms", "y_rms", "invalid_state", "pdh0", "vx_rms", "vy_rms")

_PCD_TYPES = {("F", 4): "f4", ("F", 8): "f8", ("I", 1): "i1", ("I", 2): "i2",
              ("I", 4): "i4", ("U", 1): "u1", ("U", 2): "u2", ("U", 4): "u4"}


def read_radar_pcd(path: str) -> np.ndarray:
    """Parse a nuScenes radar .pcd (binary or ascii) into an (N, 18) float32
    array in :data:`RADAR_FIELDS` order; a field the file lacks stays 0."""
    with open(path, "rb") as f:
        header: Dict[str, List[str]] = {}
        while True:
            line = f.readline().decode("ascii", "ignore").strip()
            key = line.split(" ")[0].upper()
            header[key] = line.split(" ")[1:]
            if key == "DATA":
                data_fmt = header["DATA"][0]
                break
        fields = header["FIELDS"]
        sizes = [int(s) for s in header["SIZE"]]
        types = header["TYPE"]
        counts = [int(c) for c in header.get("COUNT", ["1"] * len(fields))]
        n = int(header["POINTS"][0])
        dtype = np.dtype([(name, _PCD_TYPES[(t, s)], c) if c > 1 else
                          (name, _PCD_TYPES[(t, s)])
                          for name, t, s, c in zip(fields, types, sizes, counts)])
        if data_fmt == "binary":
            raw = np.frombuffer(f.read(dtype.itemsize * n), dtype=dtype, count=n)
        else:
            rows = [ln.split() for ln in f.read().decode().strip().splitlines()]
            raw = np.array([tuple(map(float, r)) for r in rows], dtype=dtype)
    out = np.zeros((n, len(RADAR_FIELDS)), np.float32)
    for i, name in enumerate(RADAR_FIELDS):
        if name in raw.dtype.names:
            out[:, i] = raw[name].astype(np.float32)
    return out


class RadarPoints:
    """(N, D) radar points with the xy velocity at columns ``vel_dims``; the
    geometric ops rotate, flip and scale the velocity with the position."""

    def __init__(self, tensor: np.ndarray, points_dim: int = None,
                 vel_dims=(3, 4)):
        self.tensor = np.asarray(tensor, np.float32)
        self.vel_dims = tuple(vel_dims)

    def rotate(self, angle: float) -> "RadarPoints":
        c, s = np.cos(angle), np.sin(angle)
        rot = np.array([[c, -s], [s, c]], np.float32)
        t = self.tensor.copy()
        t[:, :2] = t[:, :2] @ rot.T
        vd = list(self.vel_dims)
        t[:, vd] = t[:, vd] @ rot.T
        return RadarPoints(t, vel_dims=self.vel_dims)

    def flip(self, bev_direction: str = "horizontal") -> "RadarPoints":
        t = self.tensor.copy()
        axis = 1 if bev_direction == "horizontal" else 0
        t[:, axis] = -t[:, axis]
        t[:, self.vel_dims[axis]] = -t[:, self.vel_dims[axis]]
        return RadarPoints(t, vel_dims=self.vel_dims)

    def scale(self, factor: float) -> "RadarPoints":
        t = self.tensor.copy()
        t[:, :3] *= factor
        vd = list(self.vel_dims)
        t[:, vd] *= factor
        return RadarPoints(t, vel_dims=self.vel_dims)

    def __len__(self):
        return len(self.tensor)


@PIPELINES.register_module()
class LoadRadarPointsFromMultiSweeps:
    """Accumulate the sweeps of every radar in ``results["radar_info"]`` into
    the LiDAR frame: ``radar`` (max_num, 7) with columns (x, y, z, vx_comp,
    vy_comp, rcs, time lag), padded by drawing the cloud's own points again
    or cut by drawing ``max_num`` without replacement, and ``radar_mask``
    (max_num,), all False for an empty cloud."""

    def __init__(self, sweeps_num: int = 4,
                 use_dim=(0, 1, 2, 8, 9, 5),
                 max_num: int = 2048, compensate_velocity: bool = True,
                 file_client_args=None, test_mode: bool = False):
        self.sweeps_num = sweeps_num
        self.use_dim = list(use_dim)
        self.max_num = max_num
        self.compensate_velocity = compensate_velocity

    def _pad_or_drop(self, points: np.ndarray,
                     rng: np.random.Generator) -> np.ndarray:
        n = len(points)
        if n >= self.max_num:
            idx = rng.choice(n, self.max_num, replace=False)
            return points[idx]
        if n == 0:
            return np.zeros((self.max_num, points.shape[1]), np.float32)
        idx = rng.choice(n, self.max_num - n, replace=True)
        return np.concatenate([points, points[idx]], axis=0)

    def __call__(self, results):
        rng = _rng(results)
        radar_info = results.get("radar_info", {}) or {}
        all_points = []
        for sweeps in radar_info.values():
            for sweep in sweeps[:self.sweeps_num]:
                pts = read_radar_pcd(sweep["data_path"])
                if len(pts) == 0:
                    continue
                r = np.asarray(sweep["sensor2lidar_rotation"], np.float32)
                t = np.asarray(sweep["sensor2lidar_translation"], np.float32)
                pts[:, :3] = pts[:, :3] @ r.T + t
                # the velocities, rotated into the LiDAR frame
                vel = pts[:, 8:10] if self.compensate_velocity else pts[:, 6:8]
                vel3 = np.concatenate([vel, np.zeros((len(pts), 1))], axis=1)
                vel3 = vel3 @ r.T
                pts[:, 8:10] = vel3[:, :2]
                lag = results.get("timestamp", 0.0) - sweep.get("timestamp", 0.0)
                cols = pts[:, self.use_dim]
                cols = np.concatenate(
                    [cols, np.full((len(pts), 1), lag, np.float32)], axis=1)
                all_points.append(cols)
        if all_points:
            points = np.concatenate(all_points, axis=0).astype(np.float32)
        else:
            points = np.zeros((0, len(self.use_dim) + 1), np.float32)
        results["radar"] = self._pad_or_drop(points, rng)
        results["radar_mask"] = np.ones((self.max_num,), bool) if len(points) \
            else np.zeros((self.max_num,), bool)
        return results
