"""The one generator of the benchmark's inputs, driven by a traffic file.

A traffic file (``traffic/<name>.json``) gives the sizes: the batch, the
pool of distinct batches the window cycles through, the cameras and their
image size, the LiDAR cloud (points, ranges), the ground truth, and which
inputs a batch holds (``"inputs"``: ``img``, ``points``; a batch without
``img`` runs the model in L mode, one without ``points`` in C mode).  The
values are the nuScenes-scale synthetic batch of the port's ``flagship.
synthetic_batch`` (six pinhole cameras 60 degrees apart at f = 1266, 64
boxes of which 40 are valid), drawn here on the device from the seed.

The cloud (``"cloud"``) is ``uniform``, points drawn evenly over a box of
the range (the port's synthetic batch: it fills every LiDAR capacity), or
``rings``, the sweeps of a spinning LiDAR: ``beams`` beams at elevations
evenly over ``elevation_deg``, ``azimuths`` returns a beam and sweep at
random azimuths, each at the range where the beam meets the ground
``sensor_height`` below the sensor or, nearer, a wall at a range drawn a
sample for each of ``wall_sectors`` azimuth sectors from ``wall_range``,
times 1 + ``range_noise`` x N(0, 1); sweep s is taken ``s * ego_step``
metres behind the newest along x.  Returns outside the point cloud range
(``pc_range``) are masked out, so every sample has the same shape.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch


def lidar2img(cameras: int, img_hw, focal: float) -> torch.Tensor:
    """(cameras, 4, 4) projections: camera n looks along n * 60 degrees."""
    out = torch.zeros(cameras, 4, 4, dtype=torch.float64)
    K = torch.tensor([[focal, 0., img_hw[1] / 2, 0.], [0., focal, img_hw[0] / 2, 0.],
                      [0., 0., 1., 0.], [0., 0., 0., 1.]], dtype=torch.float64)
    for n in range(cameras):
        th = n * math.pi / 3
        rot = torch.eye(4, dtype=torch.float64)
        rot[:3, :3] = torch.tensor([[math.cos(th), -math.sin(th), 0.],
                                    [0., 0., -1.],
                                    [math.sin(th), math.cos(th), 0.]])
        out[n] = K @ rot
    return out.float()


def _uniform(shape, lo, hi, gen, device):
    return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo


def uniform_cloud(t: Dict, B: int, gen: torch.Generator, device):
    """(B, points, 5) points drawn evenly over ``xy_range`` and ``z_range``,
    every one kept."""
    P = t["points"]
    xy_lo, xy_hi = t["xy_range"]
    z_lo, z_hi = t["z_range"]
    points = torch.empty((B, P, 5), device=device)
    points[..., :2] = _uniform((B, P, 2), xy_lo, xy_hi, gen, device)
    points[..., 2] = _uniform((B, P), z_lo, z_hi, gen, device)
    points[..., 3:] = torch.rand((B, P, 2), generator=gen, device=device)
    return points, torch.ones((B, P), dtype=torch.bool, device=device)


def rings_cloud(t: Dict, B: int, gen: torch.Generator, device):
    """(B, sweeps x beams x azimuths, 5) returns of a spinning LiDAR (see
    the module's doc), with the mask of those inside ``pc_range``; the
    fifth feature is the sweep's age, 0.05 s a sweep."""
    S, E, A = t["sweeps"], t["beams"], t["azimuths"]
    lo, hi = t["elevation_deg"]
    elev = torch.deg2rad(torch.linspace(lo, hi, E, device=device))
    elev = elev[None, None, :, None]                      # (1, 1, E, 1)
    az = _uniform((B, S, E, A), -math.pi, math.pi, gen, device)
    K = t["wall_sectors"]
    walls = _uniform((B, K), *t["wall_range"], gen, device)
    sector = ((az + math.pi) * (K / (2 * math.pi))).long().clamp(max=K - 1)
    wall = torch.gather(walls, 1, sector.reshape(B, -1)).reshape(az.shape)
    down = (-elev).clamp(min=1e-3)
    ground = torch.where(elev < 0, t["sensor_height"] / torch.tan(down),
                         torch.full_like(elev, math.inf))
    rng = torch.minimum(ground, wall) * (
        1 + t["range_noise"] * torch.randn(az.shape, generator=gen,
                                           device=device))
    sweep = torch.arange(S, device=device, dtype=torch.float32)
    points = torch.empty((B, S, E, A, 5), device=device)
    points[..., 0] = rng * torch.cos(az) - (sweep * t["ego_step"])[:, None, None]
    points[..., 1] = rng * torch.sin(az)
    points[..., 2] = rng * torch.tan(elev)
    points[..., 3] = torch.rand(az.shape, generator=gen, device=device)
    points[..., 4] = (sweep * 0.05)[:, None, None]
    points = points.reshape(B, -1, 5)
    pcr = torch.tensor(t["pc_range"], device=device)
    mask = ((points[..., :3] >= pcr[:3]) & (points[..., :3] < pcr[3:])).all(-1)
    return points, mask


CLOUDS = {"uniform": uniform_cloud, "rings": rings_cloud}


def make_batch(t: Dict, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """One batch of ``t["batch"]`` samples drawn from ``gen`` on ``device``."""
    B, N = t["batch"], t["cameras"]
    batch: Dict[str, torch.Tensor] = {}
    if "img" in t["inputs"]:
        batch["img"] = torch.randn((B, N, t["height"], t["width"], 3),
                                   generator=gen, device=device)
    if "points" in t["inputs"]:
        cloud = t.get("cloud", "uniform")
        if cloud not in CLOUDS:
            raise ValueError(f"unknown cloud {cloud!r}: {sorted(CLOUDS)}")
        batch["points"], batch["points_mask"] = CLOUDS[cloud](t, B, gen,
                                                              device)
    batch["lidar2img"] = lidar2img(N, t["img_hw"], t["focal"]).to(
        device)[None].expand(B, N, 4, 4).contiguous()
    G, lim = t["gt"], t["gt_xy"]
    gt = torch.empty((B, G, 9), device=device)
    gt[..., 0:2] = _uniform((B, G, 2), -lim, lim, gen, device)
    gt[..., 2] = _uniform((B, G), -2.0, 0.0, gen, device)
    gt[..., 3:6] = _uniform((B, G, 3), 0.5, 4.0, gen, device)
    gt[..., 6] = _uniform((B, G), -math.pi, math.pi, gen, device)
    gt[..., 7:] = 0.0
    batch["gt_bboxes"] = gt
    batch["gt_labels"] = torch.randint(0, t["classes"], (B, G), generator=gen,
                                       device=device)
    batch["gt_valid"] = (torch.arange(G, device=device) < t["gt_valid"]
                         )[None].expand(B, G).contiguous()
    return batch


def make_pool(t: Dict, seed: int, device) -> List[Dict[str, torch.Tensor]]:
    """``t["pool"]`` distinct batches from ``seed``: the same seed gives the
    same batches."""
    gen = torch.Generator(device=device).manual_seed(traffic_seed(seed))
    return [make_batch(t, gen, device) for _ in range(t["pool"])]


def traffic_seed(seed: int) -> int:
    """The inputs' generator seed, apart from the weights' (``seed``)."""
    return (2 * seed + 1) % 2 ** 63
