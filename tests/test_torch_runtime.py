"""The runtime, JAX package against the port: the Runner's reading of a
config and its val-loss pass, the checkpoint cadence, the optimizer's
schedule from a config, resume, and ``load_params`` across modalities.
(``val_step`` and the val-loss pass on the tiny LC model against JAX are in
tests/test_torch_lidar_train.py, on its JAX model.)  No JAX compile.

Tolerances: learning rates 1e-5 relative (the JAX schedule computes in
float32, the port's in float64, and near the end of the cosine 1 + cos
cancels: 1.1e-6 seen); resume is bit-identical (the same CPU ops in the
same order).
"""

import copy
import json
import logging
import os.path as osp

import numpy as np
import pytest
import torch

import jax
from unibev_tpu.runtime.checkpoints import CheckpointManager as JaxCheckpoints
from unibev_tpu.runtime.lr_schedule import cosine_with_linear_warmup
from unibev_tpu.runtime.train_loop import Runner as JaxRunner

from unibev_tpu_torch.config.config import Config
from unibev_tpu_torch.data.loader import DataLoader
from unibev_tpu_torch.flagship import build_model, tiny_batch, tiny_model_cfg
from unibev_tpu_torch.parallel.train_state import PARAMWISE, make_optimizer
from unibev_tpu_torch.runtime.checkpoints import (CheckpointManager,
                                                  load_params,
                                                  restore_state_from,
                                                  save_params)
from unibev_tpu_torch.runtime.train_loop import Runner

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny models on one intra-op thread: beside the other test workers'
    processes, torch's thread pool waits on descheduled threads at every
    small op, and the resume test runs several times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
FLAGSHIP = osp.join(REPO, "configs/unibev/unibev_nus_LC_cnw_256_modality_dropout.py")
LOGGER = logging.getLogger("test_torch_runtime")


class _Samples:
    """A dataset of the tiny batches of ``tiny_batch`` (B=1), one seed a
    sample, as numpy per sample."""

    def __init__(self, seeds):
        self.items = [{k: v[0].numpy() for k, v in
                       tiny_batch(np.random.RandomState(s)).items()}
                      for s in seeds]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


CONFIGS = {
    "defaults": dict(),
    "test_runtime": dict(evaluation=dict(interval=3),
                         workflow=[("train", 1), ("val", 1)], max_epochs=1),
    "custom": dict(samples_per_gpu=2, total_epochs=5,
                   optimizer=dict(type="AdamW", lr=1e-3, weight_decay=0.05),
                   optimizer_config=dict(grad_clip=dict(max_norm=10)),
                   lr_config=dict(warmup_iters=7, warmup_ratio=0.25,
                                  min_lr_ratio=1e-2),
                   checkpoint_config=dict(interval=2),
                   custom_hooks=[dict(type="CheckpointLateStageHook",
                                      start=4)],
                   log_config=dict(interval=3), val_loss_max_batches=2),
    "flagship": FLAGSHIP,
}


class _Length:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


# The JAX Runner's batch is samples_per_gpu on every device of its mesh
# (tests/conftest.py gives JAX 8 CPU devices); the port runs on one.
DEVICES = jax.device_count()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_runner_reads_the_config_as_jax(tmp_path, name):
    """The same settings from the same config; the JAX Runner gets a dataset
    DEVICES times as long, so that both take the same steps an epoch."""
    cfg = CONFIGS[name]
    cfg = Config.fromfile(cfg) if isinstance(cfg, str) else cfg
    want = JaxRunner(model=None, dataset=_Length(8 * DEVICES), cfg=cfg,
                     work_dir=str(tmp_path / "jax"), logger=LOGGER)
    got = Runner(cfg, _Length(8), str(tmp_path / "port"), LOGGER,
                 device="cpu")
    assert got.samples_per_step * DEVICES == want.samples_per_step
    for attr in ("max_epochs", "steps_per_epoch", "eval_interval",
                 "val_loss_epochs", "val_loss_max_batches"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert got.metrics.interval == want.metrics.interval
    assert got.ckpt.interval == want.ckpt.interval
    assert got.ckpt.late_stage_start == want.ckpt.late_stage_start
    steps = range(0, got.steps_per_epoch * got.max_epochs + 3)
    np.testing.assert_allclose([got.lr_schedule(s) for s in steps],
                               [float(want.lr_schedule(s)) for s in steps],
                               rtol=1e-5)
    clip = dict(cfg.get("optimizer_config") or {}).get("grad_clip", {})
    assert got.optim["grad_clip"] == clip.get("max_norm", 35.0)


def test_val_loss_pass_averages_whole_batches(tmp_path):
    """tests/test_runtime.py's fake step through both Runners, at the same
    batch (the JAX Runner's samples_per_gpu 1 on its DEVICES devices)."""
    ds = _Samples(range(2 * DEVICES + 1))
    cfg = dict(samples_per_gpu=1, workflow=[("train", 1), ("val", 1)])
    want = JaxRunner(model=None, dataset=ds, cfg=cfg,
                     work_dir=str(tmp_path / "jax"), logger=LOGGER,
                     val_dataset=ds)
    got = Runner(dict(cfg, samples_per_gpu=DEVICES), ds,
                 str(tmp_path / "port"), LOGGER, val_dataset=ds, device="cpu")
    shapes = []

    def fake(state, batch):
        shapes.append({k: tuple(v.shape) for k, v in batch.items()})
        return {"loss": 2.0 + len(shapes), "d5.loss_cls": 1.0}

    w = want._val_loss_pass(fake, state=None)
    n = len(shapes)
    g = got._val_loss_pass(lambda model, batch: fake(model, batch))
    assert g == {"loss": w["loss"] + n, "d5.loss_cls": 1.0}
    assert shapes[n:] == shapes[:n] and n == 2
    assert shapes[0]["img"][0] == DEVICES


def test_checkpoint_cadence_matches(tmp_path):
    port = CheckpointManager(str(tmp_path / "port"), interval=6,
                             late_stage_start=21)
    jax_m = JaxCheckpoints(str(tmp_path / "jax"), interval=6,
                           late_stage_start=21)
    saves = [e for e in range(36) if port.should_save(e)]
    assert saves == [e for e in range(36) if jax_m.should_save(e)]
    assert saves == [5, 11, 17] + list(range(20, 36))


def test_checkpoint_manager_keeps_the_newest(tmp_path):
    m = CheckpointManager(str(tmp_path), max_to_keep=2)
    assert m.latest_step() is None and m.restore() is None
    for step in (3, 10, 7):
        m.save(step, {"step": step})
    assert m.steps() == [7, 10] and m.restore()["step"] == 10
    assert restore_state_from(str(tmp_path))["step"] == 10
    assert restore_state_from(m.path(7))["step"] == 7


def test_restore_state_from_a_missing_path_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore_state_from(str(tmp_path / "nowhere"))
    with pytest.raises(FileNotFoundError):
        restore_state_from(str(tmp_path / "nowhere.pth"))
    with pytest.raises(FileNotFoundError):          # a directory of no steps
        restore_state_from(str(tmp_path))


class _Named(torch.nn.Module):
    """Parameters under the names the paramwise rules match."""

    def __init__(self):
        super().__init__()
        names = ("img_backbone.conv1", "img_backbone.layer1.0",
                 "img_backbone.layer3.0", "pts_backbone.blocks.0",
                 "pts_bbox_head.cls")
        self.mods = {n: torch.nn.Linear(2, 2) for n in names}
        for n, m in self.mods.items():
            parent = self
            for part in n.split(".")[:-1]:
                if not hasattr(parent, part):
                    parent.add_module(part, torch.nn.Module())
                parent = getattr(parent, part)
            parent.add_module(n.split(".")[-1], m)


def test_optimizer_from_a_config_follows_the_jax_schedule():
    kw = dict(base_lr=1e-3, weight_decay=0.05, total_steps=40,
              warmup_iters=7, warmup_ratio=0.25, min_lr_ratio=1e-2,
              grad_clip=10.0)
    model = _Named()
    opt, sched = make_optimizer(model, **kw)
    schedule = cosine_with_linear_warmup(1e-3, 40, 7, 0.25, 1e-2)
    mults = {n: m for n, m in (("img_backbone.conv1", 0.0),
                               ("img_backbone.layer1.0", 0.0),
                               ("img_backbone.layer3.0", 0.1),
                               ("pts_backbone.blocks.0", 0.1),
                               ("pts_bbox_head.cls", 1.0))}
    group_of = {id(p): g for g in opt.param_groups for p in g["params"]}
    for step in range(45):
        want = float(schedule(step))
        for name, mult in mults.items():
            g = group_of[id(model.mods[name].weight)]
            assert g["lr_mult"] == mult, name
            np.testing.assert_allclose(g["lr"], want * mult, rtol=1e-5,
                                       atol=1e-12, err_msg=f"{name} {step}")
        opt.step()
        sched.step()
    assert all(g["weight_decay"] == 0.05 and g["grad_clip"] == 10.0
               for g in opt.param_groups)


def test_optimizer_defaults_are_the_reference_configs():
    """At its defaults make_optimizer is what it was before it read configs:
    the flagship config's settings and the paramwise rules."""
    cfg = Config.fromfile(FLAGSHIP)
    model = _Named()
    a, _ = make_optimizer(model)
    b, _ = make_optimizer(model, base_lr=cfg.optimizer["lr"],
                          weight_decay=cfg.optimizer["weight_decay"],
                          total_steps=100000,
                          warmup_iters=cfg.lr_config["warmup_iters"],
                          warmup_ratio=cfg.lr_config["warmup_ratio"],
                          min_lr_ratio=cfg.lr_config["min_lr_ratio"],
                          grad_clip=cfg.optimizer_config["grad_clip"]["max_norm"],
                          paramwise=PARAMWISE)
    strip = [{k: v for k, v in g.items() if k != "params"}
             for g in a.param_groups]
    assert strip == [{k: v for k, v in g.items() if k != "params"}
                     for g in b.param_groups]


def _train(work_dir, cfg, ds, max_steps=None):
    runner = Runner(cfg, ds, work_dir, LOGGER, device="cpu")
    runner.init_state()
    runner.run(DataLoader(ds, batch_size=1, num_workers=0, seed=0),
               max_steps=max_steps)
    with open(osp.join(work_dir, "metrics.jsonl")) as f:
        losses = [{k: v for k, v in json.loads(line).items()
                   if "loss" in k or k in ("step", "l_flag", "c_flag")}
                  for line in f]
    return runner, losses


def test_resume_is_bit_identical(tmp_path):
    """2 + 2 steps from a checkpoint give the parameters, buffers and losses
    of 4 uninterrupted steps (train mode: GridMask, dropout and modality
    dropout draw from the restored generator)."""
    cfg = dict(model=tiny_model_cfg(use_lidar=True), max_epochs=2,
               checkpoint_config=dict(interval=1), log_config=dict(interval=1),
               lr_config=dict(warmup_iters=2))
    ds = _Samples([0, 1])
    whole, want = _train(str(tmp_path / "whole"), cfg, ds)
    first, got = _train(str(tmp_path / "resumed"), cfg, ds, max_steps=2)
    assert first.step == 2 and first.ckpt.steps() == [2]
    second, more = _train(str(tmp_path / "resumed"), cfg, ds)
    assert second.step == whole.step == 4
    assert got + more[len(got):] == want
    flags = {(l["l_flag"], l["c_flag"]) for l in want}
    assert len(flags) > 1, flags              # the draws differ by step
    a, b = whole.model.state_dict(), second.model.state_dict()
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert torch.equal(whole.generator.get_state(),
                       second.generator.get_state())


def test_load_params_across_modalities(tmp_path, caplog):
    """An LC checkpoint into the L and C inference models: every key of
    theirs loaded, the other branch's subtrees dropped, logged and counted;
    a missing key and a wrong shape keep their initialization."""
    lc = build_model(tiny_model_cfg(use_lidar=True), "cpu", seed=3)
    path = str(tmp_path / "lc.pth")
    save_params(path, lc)
    sd = lc.state_dict()
    for name, modal in (("L", dict(use_camera=False)), ("C", {})):
        cfg = dict(tiny_model_cfg(use_lidar=name == "L"), **modal)
        model = build_model(cfg, "cpu", seed=4)
        own = model.state_dict()
        with caplog.at_level(logging.INFO, logger="unibev_tpu_torch"):
            caplog.clear()
            report = load_params(path, model)
        assert sorted(report.copied) == sorted(own) and not report.kept
        assert sorted(report.dropped) == sorted(set(sd) - set(own))
        gone = "img_backbone" if name == "L" else "pts_middle_encoder"
        assert any(k.startswith(gone) for k in report.dropped)
        assert f"checkpoint subtree '{gone}" in caplog.text
        assert f"{len(report.dropped)} checkpoint keys ignored" in caplog.text
        for k, v in model.state_dict().items():
            assert torch.equal(v, sd[k]), k

    # a training checkpoint, one key missing and one of another shape
    model = build_model(tiny_model_cfg(), "cpu", seed=4)
    init = copy.deepcopy(model.state_dict())
    bad = {k: v for k, v in lc.state_dict().items()
           if k != "pts_bbox_head.cls_branches.0.0.weight"}
    bad["img_neck.fpn_convs.0.conv.weight"] = torch.zeros(3, 3)
    torch.save({"model": bad, "step": 1}, str(tmp_path / "train.pth"))
    with caplog.at_level(logging.INFO, logger="unibev_tpu_torch"):
        caplog.clear()
        report = load_params(str(tmp_path / "train.pth"), model)
    assert sorted(report.kept) == ["img_neck.fpn_convs.0.conv.weight",
                                   "pts_bbox_head.cls_branches.0.0.weight"]
    assert "keeping initialization" in caplog.text
    for k in report.kept:
        assert torch.equal(model.state_dict()[k], init[k]), k
