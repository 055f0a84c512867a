"""A tiny cell for the harness's CPU tests: the port's tiny LC or C model
(``flagship.tiny_model_cfg``: 2 cameras at 64 x 96, a depth-50 backbone
with DCN in stage 4, 8 x 8 BEV, dims 32, a [25, 32, 32] voxel grid) written
as a config file, and traffic of its sizes.  The harness runs it on the
CPU, where the port takes its plain versions."""

from __future__ import annotations

import os

from benchmark.spec import Cell

TRAFFIC = {
    "kind": "predict", "loop": "closed", "batch": 2, "pool": 2,
    "inputs": ["img", "points"], "cameras": 2, "height": 64, "width": 96,
    "img_hw": [64, 96], "focal": 60.0, "points": 1024,
    "xy_range": [-9.0, 9.0], "z_range": [-1.8, 1.8], "gt": 6, "gt_valid": 4,
    "gt_xy": 5.0, "classes": 10, "warmup": 1, "check_calls": 2,
    "check_within": 3, "trace_calls": 1,
}


def write_config(tmp_path, lidar: bool = True) -> str:
    """A config file of the tiny model (float32) under ``tmp_path``."""
    from unibev_tpu_torch.flagship import tiny_model_cfg
    cfg = tiny_model_cfg(use_lidar=lidar)
    cfg.pop("dtype", None)
    path = os.path.join(str(tmp_path), f"tiny_{'lc' if lidar else 'c'}.py")
    with open(path, "w") as f:
        f.write(f"model = dict(type='UniBEV', dtype='float32', **{cfg!r})\n")
    return path


def tiny_cell(tmp_path, limits, lidar: bool = True, **traffic) -> Cell:
    from unibev_tpu_torch.flagship import build_model_from_config
    from benchmark import shapes
    path = write_config(tmp_path, lidar)
    expect = shapes.of_model(build_model_from_config(path, device="meta"))
    t = dict(TRAFFIC, **traffic)
    if not lidar:
        t["inputs"] = ["img"]
    workload = {"name": "tiny", "config": "tiny", "traffic": "tiny",
                "chips": 1}
    config = {"name": "tiny", "config_file": path, "expect": expect}
    return Cell(workload, config, t, dict(limits), [], [])


def tiny_train_cell(tmp_path, limits) -> Cell:
    """The tiny LC model's training cell: batches of 2, three steps
    compared."""
    return tiny_cell(tmp_path, limits, kind="train", compare_steps=3,
                     pool=3, warmup=0)
