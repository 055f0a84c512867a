"""Scene traffic: one scene's frames in order, with the ego motion a
vehicle's CAN bus reports, each pass under new scene ids; its other values
are the draws of the same traffic without a scene."""

from __future__ import annotations

import math

import pytest
import torch

from benchmark import traffic
from benchmark.faults import half_batch
from benchmark.tests.tiny import SCENE, TRAFFIC

SEED = 2 ** 31 + 77
T = dict(TRAFFIC, batch=3, inputs=["img"], check_within=4,
         scene=dict(SCENE, frames=6, yaw_rate_dps=-25.0, straight_share=0.4))


def _integrate(s, x, y, yaw, steps=4000):
    """The pose after each frame, by small steps of the yaw-rate profile."""
    F, dt, v = s["frames"], s["dt_s"], s["speed_mps"]
    straight = round(s["straight_share"] * (F - 1))
    out = [(x, y, yaw)]
    for k in range(F - 1):
        w = 0.0 if k < straight else math.radians(s["yaw_rate_dps"])
        h = dt / steps
        for _ in range(steps):
            # the midpoint of each small step
            mid = yaw + w * h / 2
            x, y, yaw = x + v * h * math.cos(mid), y + v * h * math.sin(mid), \
                yaw + w * h
        out.append((x, y, yaw))
    return out


def test_each_frames_pose_integrates_the_speed_and_yaw_profile():
    pool = traffic.make_pool(T, SEED, "cpu")
    s, B = T["scene"], T["batch"]
    bus = torch.stack([pool[k]["can_bus"] for k in range(s["frames"])])
    assert bus.shape == (s["frames"], B, 18) and bus.dtype == torch.float64
    for b in range(B):
        x0, y0, yaw0 = (float(bus[0, b, 0]), float(bus[0, b, 1]),
                        float(bus[0, b, 16]))
        assert max(abs(x0), abs(y0)) <= s["start_range_m"]
        for k, (x, y, yaw) in enumerate(_integrate(s, x0, y0, yaw0)):
            assert float(bus[k, b, 0]) == pytest.approx(x, abs=1e-6)
            assert float(bus[k, b, 1]) == pytest.approx(y, abs=1e-6)
            assert float(bus[k, b, 16]) == pytest.approx(
                yaw % (2 * math.pi), abs=1e-9)
    # straight, then turning: the yaw holds for round(0.4 * 5) = 2 intervals
    yaw = bus[..., 16]
    assert torch.equal(yaw[0], yaw[1]) and torch.equal(yaw[1], yaw[2])
    assert not torch.equal(yaw[2], yaw[3])
    # a frame's rotation rate is that of the interval it begins
    assert torch.all(bus[:2, :, 12] == 0)
    assert torch.allclose(bus[2:, :, 12], torch.tensor(math.radians(-25.0),
                                                       dtype=torch.float64))
    assert torch.all(bus[..., 13] == s["speed_mps"])


def test_the_yaw_agrees_with_the_quaternion():
    pool = traffic.make_pool(T, SEED, "cpu")
    bus = torch.cat([b["can_bus"] for b in pool])
    w, qx, qy, qz = bus[:, 3], bus[:, 4], bus[:, 5], bus[:, 6]
    assert torch.allclose(w ** 2 + qx ** 2 + qy ** 2 + qz ** 2,
                          torch.ones_like(w))
    yaw = torch.atan2(2 * (w * qz + qx * qy), 1 - 2 * (qy ** 2 + qz ** 2))
    gap = torch.remainder(yaw - bus[:, 16] + math.pi, 2 * math.pi) - math.pi
    assert float(gap.abs().max()) < 1e-9
    assert bool(((bus[:, 16] >= 0) & (bus[:, 16] < 2 * math.pi)).all())
    assert torch.allclose(bus[:, 17], torch.rad2deg(bus[:, 16]))


def test_scene_ids_change_every_frames_calls():
    pool = traffic.make_pool(T, SEED, "cpu")
    F, B = T["scene"]["frames"], T["batch"]
    assert len(pool) == traffic.PASSES * F
    ids = [pool[i % len(pool)]["scene_id"] for i in range(3 * F)]
    for i in range(1, 3 * F):
        assert ids[i].shape == (B,) and ids[i].dtype == torch.int64
        changed = not torch.equal(ids[i], ids[i - 1])
        assert changed == (i % F == 0), i
        # sample b of every batch is vehicle b
        assert len(set(ids[i].tolist())) == B
    # the window's call i is frame i mod frames
    for i in range(3 * F):
        assert pool[i % len(pool)]["img"] is pool[i % F]["img"]
    # the warm-up is another scene than the window's first call
    warm = traffic.warmup(T, pool)
    assert len(warm) == T["warmup"]
    assert not torch.equal(warm[-1]["scene_id"], pool[0]["scene_id"])
    assert [b["img"] is pool[k]["img"] for k, b in enumerate(warm)] \
        == [True] * len(warm)


def test_the_other_values_are_the_draws_without_a_scene():
    """The scene's values are drawn after everything else."""
    plain = dict(T, pool=T["scene"]["frames"])
    plain.pop("scene")
    a = traffic.make_pool(plain, SEED, "cpu")
    b = traffic.make_pool(T, SEED, "cpu")
    for x, y in zip(a, b):
        assert set(y) == set(x) | {"can_bus", "scene_id"}
        for k in x:
            assert torch.equal(x[k], y[k]), k


def test_replay_runs_the_first_scene_up_to_the_last_sampled_call():
    assert traffic.replay(T, [1, 3]) == [0, 1, 2, 3]
    assert traffic.replay(TRAFFIC, [2, 0]) == [0, 2]
    with pytest.raises(ValueError):
        traffic.replay(T, [T["scene"]["frames"]])
    with pytest.raises(ValueError):
        traffic.make_pool(dict(T, check_within=T["scene"]["frames"] + 1),
                          SEED, "cpu")


def test_half_batch_slices_the_scene_keys_by_their_leading_batch():
    batch = traffic.make_pool(dict(T, batch=4), SEED, "cpu")[1]
    seen = []
    model = torch.nn.Module().eval()
    half_batch(lambda b: seen.append(b), model)(batch)
    got = seen[0]
    for k in ("can_bus", "scene_id"):
        assert got[k].shape == batch[k].shape
        assert torch.equal(got[k][:2], batch[k][:2])
        assert torch.equal(got[k][2:], batch[k][:2])
    model.train()
    half_batch(lambda b: seen.append(b), model)(batch)
    assert seen[1]["can_bus"].shape == (2, 18)
    assert torch.equal(seen[1]["scene_id"], batch["scene_id"][:2])
