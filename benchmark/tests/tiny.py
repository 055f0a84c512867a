"""A tiny cell for the harness's CPU tests: the port's tiny LC or C model
(``flagship.tiny_model_cfg``: 2 cameras at 64 x 96, a depth-50 backbone
with DCN in stage 4, 8 x 8 BEV, dims 32, a [25, 32, 32] voxel grid) written
as a config file, and traffic of its sizes.  The harness runs it on the
CPU, where the port takes its plain versions.  ``stateful_cell`` is the
tiny stateful detector of ``stateful.py`` (its detector file under
``tests/detectors/``) on a scene of ``SCENE``'s frames."""

from __future__ import annotations

import os

from benchmark.spec import Cell

HERE = os.path.dirname(os.path.abspath(__file__))

TRAFFIC = {
    "kind": "predict", "loop": "closed", "batch": 2, "pool": 2,
    "inputs": ["img", "points"], "cameras": 2, "height": 64, "width": 96,
    "img_hw": [64, 96], "focal": 60.0, "points": 1024,
    "xy_range": [-9.0, 9.0], "z_range": [-1.8, 1.8], "gt": 6, "gt_valid": 4,
    "gt_xy": 5.0, "classes": 10, "warmup": 1, "check_calls": 2,
    "check_within": 3, "trace_calls": 1,
}


SCENE = {"frames": 4, "dt_s": 0.5, "speed_mps": 10.0, "yaw_rate_dps": 20.0,
         "straight_share": 0.5, "start_range_m": 100.0}


def write_config(tmp_path, lidar: bool = True, detector: str = "UniBEV"
                 ) -> str:
    """A config file of the tiny model (float32) under ``tmp_path``, of the
    detector type ``detector``."""
    from unibev_tpu_torch.flagship import tiny_model_cfg
    cfg = tiny_model_cfg(use_lidar=lidar)
    cfg.pop("dtype", None)
    path = os.path.join(str(tmp_path),
                        f"tiny_{'lc' if lidar else 'c'}_{detector}.py")
    with open(path, "w") as f:
        f.write(f"model = dict(type={detector!r}, dtype='float32', "
                f"**{cfg!r})\n")
    return path


def tiny_cell(tmp_path, limits, lidar: bool = True, detector: str = "UniBEV",
              here: str = None, **traffic) -> Cell:
    from benchmark import spec
    here = here or spec.HERE
    path = write_config(tmp_path, lidar, detector)
    det = spec.load_detector(path, here)
    expect = det.of_model(det.build_port(path, "meta", False))
    t = dict(TRAFFIC, **traffic)
    if not lidar:
        t["inputs"] = ["img"]
    workload = {"name": "tiny", "config": "tiny", "traffic": "tiny",
                "chips": 1}
    config = {"name": "tiny", "config_file": path, "expect": expect}
    return Cell(workload, config, t, dict(limits), [], [], here)


def stateful_cell(tmp_path, limits, **traffic) -> Cell:
    """The tiny stateful detector (C) on a scene: check_within 3 of its 4
    frames."""
    return tiny_cell(tmp_path, limits, lidar=False,
                     detector="TinyStatefulBEV", here=HERE, scene=SCENE,
                     **traffic)


def tiny_train_cell(tmp_path, limits) -> Cell:
    """The tiny LC model's training cell: batches of 2, three steps
    compared."""
    return tiny_cell(tmp_path, limits, kind="train", compare_steps=3,
                     pool=3, warmup=0)
