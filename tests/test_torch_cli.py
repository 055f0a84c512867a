"""The port's train and test CLIs on the on-disk fake nuScenes tree, on the
CPU, as a user runs them (``python -m unibev_tpu_torch.tools...``), and
the port's import boundary: no module of the port and neither CLI loads
jax, flax or anything of the JAX package.
"""

import json
import math
import os
import os.path as osp
import subprocess
import sys

import pytest
import torch

from torch_port_utils import fake_nuscenes_tree
from unibev_tpu_torch.tools import test_UniBEV, train_UniBEV

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
RESULT_KEYS = ["sample_idx", "boxes_3d", "scores_3d", "labels_3d", "valid"]


def _env():
    """No JAX settings, and one intra-op thread: the tiny model beside the
    other test workers' processes runs several times faster on one."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    return dict(env, OMP_NUM_THREADS="1")


def _run(module, *args):
    return subprocess.run([sys.executable, "-m", module, *args], cwd=REPO,
                          env=_env(), capture_output=True, text=True,
                          timeout=600)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The tree, and the train CLI's run of 2 steps on it (the tiny LC
    config of configs/smoke/tiny_lc.py, NuScenesDataset from the info
    files)."""
    root = str(tmp_path_factory.mktemp("nusc"))
    cfg = fake_nuscenes_tree(root)
    work_dir = osp.join(root, "wd")
    r = _run("unibev_tpu_torch.tools.train_UniBEV", cfg, "--device", "cpu",
             "--max-steps", "2", "--work-dir", work_dir)
    return cfg, work_dir, r


def test_train_cli_on_files(trained):
    _, work_dir, r = trained
    assert r.returncode == 0, (r.stdout[-1500:], r.stderr[-3000:])
    files = os.listdir(work_dir)
    assert any(f.endswith(".log") for f in files)
    assert "cfg_files.py" in files                  # the dumped config
    with open(osp.join(work_dir, "metrics.jsonl")) as f:
        steps = [json.loads(line) for line in f]
    assert [s["step"] for s in steps] == [1, 2]
    for s in steps:
        assert math.isfinite(s["loss"]) and s["data_time"] >= 0
        assert s["sca_overflow"] == 0
    assert os.listdir(osp.join(work_dir, "checkpoints")) == ["2.pth"]
    state = torch.load(osp.join(work_dir, "checkpoints", "2.pth"),
                       weights_only=True)
    assert state["step"] == 2 and state["epoch"] == 1
    assert set(state) == {"model", "optimizer", "scheduler", "step", "epoch",
                          "generator"}


def test_test_cli_on_the_checkpoint(trained, tmp_path):
    cfg, work_dir, r = trained
    assert r.returncode == 0
    out = str(tmp_path / "results.json")
    r = _run("unibev_tpu_torch.tools.test_UniBEV", cfg,
             osp.join(work_dir, "checkpoints", "2.pth"), "--device", "cpu",
             "--out", out, "--show-dir", str(tmp_path / "show"))
    assert r.returncode == 0, (r.stdout[-1500:], r.stderr[-3000:])
    with open(out) as f:
        results = json.load(f)
    assert len(results) == 1                          # the one val sample
    res = results[0]
    assert list(res) == RESULT_KEYS
    assert isinstance(res["sample_idx"], str) and res["sample_idx"]
    n = len(res["boxes_3d"])                          # the coder's max_num
    assert n == 16 and all(len(b) == 9 for b in res["boxes_3d"])
    assert len(res["scores_3d"]) == len(res["labels_3d"]) == len(res["valid"])
    assert all(isinstance(v, bool) for v in res["valid"])
    metrics = json.loads(r.stdout.strip().splitlines()[-1])
    assert '"mAP"' in r.stdout and math.isfinite(metrics["mAP"])
    assert metrics["sca_overflow"] == 0
    assert os.listdir(tmp_path / "show") == ["sample_0000.png"]


def test_clis_run_one_process_on_one_card(trained, monkeypatch):
    cfg = trained[0]
    for main in (train_UniBEV.main, test_UniBEV.main):
        with pytest.raises(NotImplementedError, match="ROADMAP A7"):
            main([cfg, "--launcher", "pytorch", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        train_UniBEV.main([cfg, "--gpus", "2", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (train_UniBEV.main, test_UniBEV.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([cfg])                               # --device cuda


IMPORT_EVERY_MODULE = """
import importlib, pkgutil, sys
import unibev_tpu_torch
names = [m.name for m in pkgutil.walk_packages(unibev_tpu_torch.__path__,
                                               "unibev_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import unibev_tpu_torch.tools.train_UniBEV, unibev_tpu_torch.tools.test_UniBEV
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "unibev_tpu"))
print(len(names), loaded)
"""


def test_no_port_module_loads_jax():
    r = subprocess.run([sys.executable, "-c", IMPORT_EVERY_MODULE], cwd=REPO,
                       env=_env(), capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    count, loaded = r.stdout.split(" ", 1)
    assert loaded.strip() == "[]", loaded
    assert int(count) >= 40
