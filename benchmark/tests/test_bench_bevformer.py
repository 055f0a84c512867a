"""BEVFormer's detector file on the port's tiny BEVFormer
(``flagship.tiny_bevformer_cfg``) through a whole CPU run on a turning
scene: it reads correct, and incorrect under each fault of the scene's
state and under a reversed rotation of the previous map."""

from __future__ import annotations

import os

import pytest
import torch

from benchmark import check, run, spec, traffic
from benchmark.faults import FAULTS
from benchmark.spec import Cell
from benchmark.tests.tiny import TRAFFIC

# a scene that turns from its second interval on: 10 degrees a frame
SCENE = {"frames": 6, "dt_s": 0.5, "speed_mps": 8.0, "yaw_rate_dps": 20.0,
         "straight_share": 0.2, "start_range_m": 1000.0}
# the port's CPU path computes what the reference computes, in float32
LIMITS = {"img_feat": 1e-4, "prev_bev": 1e-4, "img_bev": 1e-4,
          "fused": 1e-4, "decoder": 1e-4, "refs": 1e-4, "cls": 1e-4,
          "box": 1e-4, "tsa": 1e-4, "align": 1e-4, "decode": 0,
          "history": 0, "scene_frame": 0, "sca_overflow": 0}
# its sampled calls: 0, 2 and 4 (a scene's first frame and two turning)
SEED = 2 ** 31 + 5


def bevformer_cell(tmp_path) -> Cell:
    from unibev_tpu_torch.flagship import tiny_bevformer_cfg
    path = os.path.join(str(tmp_path), "tiny_bevformer.py")
    with open(path, "w") as f:
        f.write(f"model = dict(type='BEVFormer', dtype='float32', "
                f"**{tiny_bevformer_cfg()!r})\n")
    det = spec.load_detector(path)
    expect = det.of_model(det.build_port(path, "meta", False))
    t = dict(TRAFFIC, batch=1, inputs=["img"], check_calls=3,
             check_within=5, scene=SCENE)
    workload = {"name": "tiny", "config": "tiny", "traffic": "tiny",
                "chips": 1}
    config = {"name": "tiny", "config_file": path, "expect": expect}
    return Cell(workload, config, t, dict(LIMITS), [], [])


def test_the_seed_samples_a_scene_start_and_turning_frames(tmp_path):
    t = bevformer_cell(tmp_path).traffic
    assert check.sample_calls(torch.Generator().manual_seed(SEED),
                              t["check_within"], traffic.distinct(t),
                              t["check_calls"]) == [0, 2, 4]


def test_tiny_bevformer_reads_correct(tmp_path):
    cell = bevformer_cell(tmp_path)
    assert cell.detector().__name__.endswith("BEVFormer")
    r = run.run_cell(cell, SEED, 0.1, False, device="cpu")
    assert r["correct"], r["compared"]
    assert set(r["numbers"]) == set(LIMITS)


@pytest.mark.parametrize("fault", ["scene_never_starts", "scene_always_starts",
                                   "rotation_reversed"])
def test_a_broken_state_or_alignment_is_not_correct(tmp_path, fault):
    cell = bevformer_cell(tmp_path)
    faults = dict(FAULTS, **cell.detector().FAULTS)
    r = run.run_cell(cell, SEED, 0.1, False, device="cpu",
                     fault=faults[fault])
    assert not r["correct"]
    assert r["failed"] == r["attempted"] > 0
    n = r["numbers"]
    if fault == "rotation_reversed":
        # the rotation alone is wrong: the step from the port's own state
        # says so, and the state before it was sound
        assert n["align"] > 100 * LIMITS["align"]
        assert n["history"] == 0
    else:
        # the state's count of the scene's frames is wrong at every
        # sampled call past the first
        assert n["scene_frame"] >= 1


def test_the_control_fails_the_limits(tmp_path):
    """The reference in fp8 in the port's place, read through the same
    captures: the port's and the reference's modules give the alignment's
    and the temporal self-attention's inputs alike."""
    from benchmark.calibrate import control_readings
    numbers = control_readings(bevformer_cell(tmp_path), SEED, device="cpu")
    # the control runs forwards: predict's decoding is a fault's to read
    assert set(numbers) == set(LIMITS) - {"decode"}
    # the control's own alignment is the reference's op: it reads 0
    assert numbers["align"] == 0
    for k in ("img_feat", "prev_bev", "img_bev", "tsa", "cls"):
        assert numbers[k] > 10 * LIMITS[k], (k, numbers[k])
