#!/usr/bin/env python3
"""Train UniBEV with the PyTorch port, on one CUDA card (or the CPU).

    python -m unibev_tpu_torch.tools.train_UniBEV CONFIG [--work-dir DIR]
        [--resume-from CKPT] [--load-from CKPT] [--seed N]
        [--cfg-options key=value ...] [--synthetic-data] [--max-steps N]
        [--device cuda|cpu]

The counterpart of ``tools/train_UniBEV.py`` (the JAX package's train CLI)
with its flags: the work dir is ``--work-dir``, else the config's
``work_dir``, else ``./work_dirs/<config name>``; it holds the dumped
config, a timestamped ``.log``, ``metrics.jsonl`` and ``checkpoints/`` (the
final one at the last step).  ``--synthetic-data`` trains on
``SyntheticNuScenes``; ``--max-steps`` caps the steps of one epoch.  The
model is ``build_model_from_config`` of the config.  ``--launcher`` other
than ``none`` and more than one GPU raise: the port runs one process on one
card (ROADMAP A7).  ``main(argv)`` runs it in process and returns the exit
code.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import sys
import time

import torch

from unibev_tpu_torch.data.loader import DataLoader
from unibev_tpu_torch.data.nuscenes_dataset import SyntheticNuScenes
from unibev_tpu_torch.registry import DATASETS
from unibev_tpu_torch.runtime.eval_hook import make_eval_fn
from unibev_tpu_torch.runtime.logging_utils import collect_env, get_root_logger
from unibev_tpu_torch.runtime.train_loop import Runner
from unibev_tpu_torch.tools.cli_common import (cli_device, load_config,
                                               single_process)

SYNTHETIC_KEYS = ("length", "num_cams", "img_hw", "max_points", "max_gt",
                  "seed")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train UniBEV (PyTorch port)")
    p.add_argument("config", help="train config file path")
    p.add_argument("--work-dir", help="dir to save logs and checkpoints")
    p.add_argument("--resume-from", help="checkpoint to resume from")
    p.add_argument("--load-from", help="checkpoint to warm start from")
    p.add_argument("--no-validate", action="store_true")
    group_gpus = p.add_mutually_exclusive_group()
    group_gpus.add_argument("--gpus", type=int,
                            help="number of GPUs (the port runs on one)")
    group_gpus.add_argument("--gpu-ids", type=int, nargs="+",
                            help="GPU ids (the port runs on one)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--deterministic", action="store_true",
                   help="deterministic cuDNN algorithms")
    p.add_argument("--cfg-options", nargs="+", default=[],
                   help="key=value dotted config overrides")
    p.add_argument("--autoscale-lr", action="store_true",
                   help="scale lr linearly with the device count "
                        "(8-device base)")
    p.add_argument("--launcher", default="none",
                   choices=["none", "pytorch", "slurm", "mpi", "tpu"])
    p.add_argument("--max-steps", type=int, default=None,
                   help="cap the train steps (smoke runs)")
    p.add_argument("--synthetic-data", action="store_true",
                   help="use the synthetic dataset (no nuScenes on disk)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    single_process(args.launcher, args.gpus or len(args.gpu_ids or [0]))
    device = cli_device(args.device)
    if args.deterministic:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False

    cfg = load_config(args.config, args.cfg_options)
    # work dir: CLI > config > config file name (the reference's :136-143)
    if args.work_dir:
        work_dir = args.work_dir
    elif cfg.get("work_dir"):
        work_dir = cfg.work_dir
    else:
        work_dir = osp.join("./work_dirs",
                            osp.splitext(osp.basename(args.config))[0])
    os.makedirs(work_dir, exist_ok=True)
    if args.autoscale_lr:            # one device against the 8-device base
        cfg.optimizer["lr"] = cfg.optimizer["lr"] / 8

    timestamp = time.strftime("%Y%m%d_%H%M%S", time.localtime())
    logger = get_root_logger(osp.join(work_dir, f"{timestamp}.log"),
                             cfg.get("log_level", "INFO"))
    cfg.dump(osp.join(work_dir, osp.basename(args.config)))
    logger.info(f"Environment: {collect_env()}")
    logger.info(f"Config:\n{cfg.pretty_text}")
    logger.info(f"Set random seed to {args.seed}, device {device}")

    train_cfg = dict(cfg.data["train"]) if cfg.get("data") else {}
    val_ds = None
    if args.synthetic_data or train_cfg.get("type") == "SyntheticNuScenes":
        train_ds = SyntheticNuScenes(
            **{k: v for k, v in train_cfg.items() if k in SYNTHETIC_KEYS})
    else:
        train_ds = DATASETS.build(train_cfg)
        if not args.no_validate and cfg.data.get("val"):
            val_ds = DATASETS.build(dict(cfg.data["val"]))

    runner = Runner(cfg, train_ds, work_dir, logger, val_dataset=val_ds,
                    eval_fn=make_eval_fn() if val_ds is not None else None,
                    seed=args.seed, device=device)
    workers = dict(cfg.get("data") or {}).get(
        "workers_per_gpu", cfg.get("workers_per_gpu", 2))
    loader = DataLoader(train_ds, batch_size=runner.samples_per_step,
                        shuffle=True, num_workers=int(workers),
                        seed=args.seed, pin_memory=device.type == "cuda")
    runner.init_state(load_from=args.load_from or cfg.get("load_from"),
                      resume_from=args.resume_from or cfg.get("resume_from"))
    logger.info("train state initialized; starting loop")
    if args.max_steps:
        runner.max_epochs = 1
    runner.run(loader, max_steps=args.max_steps)
    path = runner.save()
    runner.metrics.close()
    logger.info(f"training finished at step {runner.step}: {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
