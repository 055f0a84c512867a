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

A traffic file with ``"scene"`` drives a stateful detector through a
vehicle's drive: the pool is one scene's ``frames`` in order, sample b of
every batch vehicle b, each frame ``dt_s`` after the last at ``speed_mps``,
straight for the first ``straight_share`` of the scene's intervals and then
turning at ``yaw_rate_dps``, from a start pose drawn from the seed (x and y
evenly within ``start_range_m`` of the origin, the yaw evenly over a turn).
Each batch then also holds ``can_bus`` (B, 18), float64, nuScenes' and
BEVFormer's layout, all absolute: [0:3] the ego position, [3:7] its
quaternion (w, x, y, z), [7:10] the acceleration and [10:13] the rotation
rate and [13:16] the velocity in the ego frame, [16] the yaw in radians in
[0, 2 pi) and [17] the same in degrees; and ``scene_id`` (B,) int64.  The
pool holds the scene ``PASSES`` times, the same frames under other scene
ids, so that the window's call i is frame i mod ``frames`` and each pass
starts a new scene; the warm-up runs the last pass's first frames, so the
window's first call starts one too.  The model forms deltas from its own
state.  These values are drawn after all others, and only with
``"scene"``: other traffic draws what it drew before.
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


def ego_motion(s: Dict, B: int, gen: torch.Generator, device):
    """(frames, B, 3) poses x, y, yaw and (frames,) yaw rates of ``B``
    vehicles driving the scene ``s``, float64, the start pose drawn from
    ``gen``.  Between frames the yaw rate of the interval's first frame
    holds, and the pose is its exact integral at ``speed_mps``."""
    F, dt, v = s["frames"], s["dt_s"], s["speed_mps"]
    start = torch.rand((B, 3), generator=gen, device=device,
                       dtype=torch.float64)
    straight = round(s["straight_share"] * (F - 1))
    rates = [0.0 if k < straight else math.radians(s["yaw_rate_dps"])
             for k in range(F)]
    pose = torch.empty((F, B, 3), dtype=torch.float64, device=device)
    pose[0, :, :2] = (2 * start[:, :2] - 1) * s["start_range_m"]
    pose[0, :, 2] = 2 * math.pi * start[:, 2]
    for k, w in enumerate(rates[:-1]):
        yaw = pose[k, :, 2]
        nxt = yaw + w * dt
        if w == 0.0:
            step = torch.stack([torch.cos(yaw), torch.sin(yaw)], -1) * (v * dt)
        else:
            step = torch.stack([torch.sin(nxt) - torch.sin(yaw),
                                torch.cos(yaw) - torch.cos(nxt)], -1) * (v / w)
        pose[k + 1, :, :2] = pose[k, :, :2] + step
        pose[k + 1, :, 2] = nxt
    return pose, torch.tensor(rates, dtype=torch.float64, device=device)


def can_bus(pose: torch.Tensor, rates: torch.Tensor, speed: float
            ) -> torch.Tensor:
    """(frames, B, 18) CAN bus rows of the poses (see the module's doc):
    the velocity ``speed`` along x, the acceleration its centripetal part
    along y."""
    F, B, _ = pose.shape
    yaw = torch.remainder(pose[..., 2], 2 * math.pi)
    yaw = torch.where(yaw >= 2 * math.pi, yaw - 2 * math.pi, yaw)
    w = rates[:, None].expand(F, B)
    out = torch.zeros((F, B, 18), dtype=torch.float64, device=pose.device)
    out[..., 0:2] = pose[..., :2]
    out[..., 3] = torch.cos(pose[..., 2] / 2)
    out[..., 6] = torch.sin(pose[..., 2] / 2)
    out[..., 8] = speed * w
    out[..., 12] = w
    out[..., 13] = speed
    out[..., 16] = yaw
    out[..., 17] = torch.rad2deg(yaw)
    return out


PASSES = 2


def make_pool(t: Dict, seed: int, device) -> List[Dict[str, torch.Tensor]]:
    """``t["pool"]`` distinct batches from ``seed`` (with ``"scene"``, its
    frames, ``PASSES`` times): the same seed gives the same batches."""
    gen = torch.Generator(device=device).manual_seed(traffic_seed(seed))
    s = t.get("scene")
    if s is None:
        return [make_batch(t, gen, device) for _ in range(t["pool"])]
    if t.get("check_within", 0) > s["frames"]:
        raise ValueError("the sampled calls must lie in the first scene: "
                         f"check_within {t['check_within']} > frames "
                         f"{s['frames']}")
    B = t["batch"]
    frames = [make_batch(t, gen, device) for _ in range(s["frames"])]
    bus = can_bus(*ego_motion(s, B, gen, device), s["speed_mps"])
    pool = []
    for p in range(PASSES):
        ids = torch.arange(p * B, (p + 1) * B, dtype=torch.int64,
                           device=device)
        pool += [dict(b, can_bus=bus[k], scene_id=ids)
                 for k, b in enumerate(frames)]
    return pool


def distinct(t: Dict) -> int:
    """The distinct batches a window cycles through: a scene's frames."""
    return t["scene"]["frames"] if "scene" in t else t["pool"]


def warmup(t: Dict, pool: List) -> List[Dict[str, torch.Tensor]]:
    """The warm-up's ``t["warmup"]`` batches: the pool's first (with a
    scene, the last pass's first frames, another scene than the window's
    first call's)."""
    first = len(pool) - distinct(t) if "scene" in t else 0
    return [pool[first + i % distinct(t)] for i in range(t["warmup"])]


def replay(t: Dict, calls: List[int]) -> List[int]:
    """The calls the reference runs, in order, to judge the sampled
    ``calls``: those calls; with a scene, every frame of the first scene
    from its first to the last sampled call, so that the reference builds
    its own state."""
    if "scene" not in t:
        return sorted(calls)
    last = max(calls, default=-1)
    if last >= t["scene"]["frames"]:
        raise ValueError(f"call {last} lies past the first scene")
    return list(range(last + 1))


def traffic_seed(seed: int) -> int:
    """The inputs' generator seed, apart from the weights' (``seed``)."""
    return (2 * seed + 1) % 2 ** 63
