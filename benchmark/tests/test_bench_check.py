"""The correctness check, driven through a whole run of a tiny cell on the
CPU (the port's plain versions): an unbroken run is correct, and a run
with its timed path broken, or the control in the port's place, is not."""

from __future__ import annotations

import pytest
import torch

from benchmark import check, run, traffic, weights
from benchmark.faults import answer_altered, decode_altered, half_batch
from benchmark.reference import build as ref_build, precision
from benchmark.tests.tiny import tiny_cell

# limits of the tiny cell: the port's CPU path is the reference's code, so
# an unbroken run reads 0; any fault reads far above
LIMITS = {"img_feat": 1e-4, "pts_feat": 1e-4, "img_bev": 1e-4,
          "pts_bev": 1e-4, "fused": 1e-4, "decoder": 1e-4, "refs": 1e-4,
          "cls": 1e-4, "box": 1e-4, "decode": 0, "voxels": 0, "overflow": 0}
SEED = 2 ** 31 + 12345


@pytest.mark.parametrize("lidar", [True, False], ids=["LC", "C"])
def test_unbroken_run_is_correct(tmp_path, lidar):
    lidar_only = {"pts_feat", "pts_bev", "voxels", "overflow"}
    limits = {k: v for k, v in LIMITS.items() if lidar or k not in lidar_only}
    cell = tiny_cell(tmp_path, limits, lidar=lidar)
    r = run.run_cell(cell, SEED, 0.1, False, device="cpu")
    assert r["correct"], r["compared"]
    assert r["attempted"] > 0 and r["failed"] == 0
    # every layer the cell runs was compared, and no other
    assert set(r["numbers"]) == set(limits)


@pytest.mark.parametrize("fault", [half_batch, answer_altered,
                                   decode_altered])
def test_broken_run_is_not_correct(tmp_path, fault):
    cell = tiny_cell(tmp_path, LIMITS)
    r = run.run_cell(cell, SEED, 0.1, False, device="cpu", fault=fault)
    assert not r["correct"]
    assert r["failed"] == r["attempted"] > 0


def test_control_fails_the_limits(tmp_path):
    """The reference in fp8 (the control) in the port's place."""
    cell = tiny_cell(tmp_path, LIMITS)
    path = cell.config["config_file"]
    state = weights.make_state(ref_build.build_meta(path), SEED, "cpu",
                               torch.float32)
    ref = ref_build.build(path, state, "cpu")
    ctl = ref_build.build(path, state, "cpu")
    batch = traffic.make_pool(cell.traffic, SEED, "cpu")[0]
    want, got = check.Capture(ref), check.Capture(ctl, forced=True)
    with torch.no_grad(), precision.fp8(ctl):
        want.arm(0)
        ref(batch)
        got.arm(0)
        ctl(batch)
    numbers = dict(check.compare(got.records[0], want.records[0], 2),
                   **check.forced(ref, got.records[0], "cpu"))
    correct, rows = check.judge(numbers, LIMITS)
    assert not correct
    assert numbers["cls"] > 100 * LIMITS["cls"]


def test_judge_needs_every_limited_number():
    assert check.judge({"cls": 0.0}, {"cls": 0.1})[0]
    assert not check.judge({}, {"cls": 0.1})[0]
    assert not check.judge({"cls": float("nan")}, {"cls": 0.1})[0]
    assert not check.judge({"voxels": 1.0}, {"voxels": 0})[0]


def test_decode_gap_counts_rows_and_leaves_out_the_lowest_tie():
    def decoded(scores, xs):
        n = len(scores)
        return {"scores": torch.tensor([scores]),
                "labels": torch.zeros(1, n, dtype=torch.int32),
                "valid": torch.ones(1, n, dtype=torch.bool),
                "bboxes": torch.tensor([[[x] + [0.0] * 8 for x in xs]])}
    want = decoded([0.9, 0.8, 0.5, 0.5], [1.0, 2.0, 3.0, 4.0])
    # the same rows in another order, and the other row of the lowest tie
    same = decoded([0.8, 0.9, 0.5, 0.5], [2.0, 1.0, 3.0, 5.0])
    assert check.decode_gap(same, want) == 0
    moved = decoded([0.9, 0.8, 0.5, 0.5], [1.5, 2.0, 3.0, 4.0])
    assert check.decode_gap(moved, want) == 1
    assert check.decode_gap({"scores": want["scores"]}, want) == float("inf")
