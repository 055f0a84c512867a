"""The generator makes the same inputs from the same seed, and other ones
from another, at the traffic file's sizes."""

from __future__ import annotations

import pytest
import torch

from benchmark import traffic
from benchmark.tests.tiny import TRAFFIC


def test_same_seed_same_inputs_other_seed_other_inputs():
    seed = 2 ** 31 + 7
    a = traffic.make_pool(TRAFFIC, seed, "cpu")
    b = traffic.make_pool(TRAFFIC, seed, "cpu")
    c = traffic.make_pool(TRAFFIC, seed + 1, "cpu")
    assert len(a) == TRAFFIC["pool"]
    for x, y, z in zip(a, b, c):
        assert x.keys() == y.keys() == z.keys()
        for k in x:
            assert torch.equal(x[k], y[k]), k
        assert not torch.equal(x["img"], z["img"])
        assert not torch.equal(x["points"], z["points"])
    # the pool's batches differ from each other
    assert not torch.equal(a[0]["img"], a[1]["img"])


def test_sizes_follow_the_traffic_file():
    t = dict(TRAFFIC, batch=3, inputs=["points"])
    batch = traffic.make_pool(t, 1, "cpu")[0]
    assert "img" not in batch
    assert batch["points"].shape == (3, t["points"], 5)
    assert batch["lidar2img"].shape == (3, t["cameras"], 4, 4)
    pts = batch["points"]
    assert pts[..., :2].abs().max() <= t["xy_range"][1]
    assert t["z_range"][0] <= pts[..., 2].min() <= pts[..., 2].max() <= t["z_range"][1]
    assert int(batch["gt_valid"].sum()) == 3 * t["gt_valid"]


RINGS = dict(TRAFFIC, inputs=["points"], cloud="rings", sweeps=2, beams=4,
             elevation_deg=[-20.0, 5.0], azimuths=64, sensor_height=1.84,
             wall_sectors=8, wall_range=[4.0, 12.0], range_noise=0.002,
             ego_step=0.5, pc_range=[-9.0, -9.0, -3.0, 9.0, 9.0, 1.0])


def test_rings_follow_the_traffic_file():
    seed = 2 ** 31 + 11
    a = traffic.make_pool(RINGS, seed, "cpu")[0]
    b = traffic.make_pool(RINGS, seed, "cpu")[0]
    c = traffic.make_pool(RINGS, seed + 1, "cpu")[0]
    assert torch.equal(a["points"], b["points"])
    assert not torch.equal(a["points"], c["points"])
    B, S, E, A = RINGS["batch"], 2, 4, 64
    assert a["points"].shape == (B, S * E * A, 5)
    pts, mask = a["points"], a["points_mask"]
    assert 0 < int(mask.sum()) < mask.numel()
    kept = pts[mask]
    lo, hi = torch.tensor(RINGS["pc_range"]).split(3)
    assert bool(((kept[:, :3] >= lo) & (kept[:, :3] < hi)).all())
    # the downward beams meet the ground sensor_height below, or a wall
    # nearer: nothing lies under the ground
    assert float(kept[:, 2].min()) > -1.84 * 1.02
    assert bool(((kept[:, 2] + 1.84).abs() < 0.02).any())
    ages = sorted(set(pts[..., 4].flatten().tolist()))
    assert ages == pytest.approx([0.0, 0.05])
