"""Logging and metrics: a timestamped text log, JSON lines, TensorBoard.

Counterpart of ``unibev_tpu/runtime/logging_utils.py``: the reference's
TextLoggerHook / TensorboardLoggerHook (its config's ``log_config``) and
``get_root_logger`` with the environment dump of its train CLI.  Loss keys
keep the reference's ``d{i}.loss_cls`` names.
"""

from __future__ import annotations

import json
import logging
import os
import os.path as osp
import time
from typing import Any, Dict, Optional

LOGGER_NAME = "unibev_tpu_torch"
_FORMAT = "%(asctime)s - %(name)s - %(levelname)s - %(message)s"


def get_root_logger(log_file: Optional[str] = None,
                    log_level: str = "INFO") -> logging.Logger:
    """The port's logger: to stderr, and to ``log_file`` when given (a
    later call with another file moves the file output there, so two CLI
    runs in one process each get their own log)."""
    logger = logging.getLogger(LOGGER_NAME)
    logger.setLevel(getattr(logging, log_level))
    fmt = logging.Formatter(_FORMAT)
    if not any(type(h) is logging.StreamHandler for h in logger.handlers):
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    if log_file:
        for h in [h for h in logger.handlers
                  if isinstance(h, logging.FileHandler)]:
            logger.removeHandler(h)
            h.close()
        os.makedirs(osp.dirname(osp.abspath(log_file)), exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


def collect_env() -> Dict[str, Any]:
    import platform

    import torch
    env = dict(python=platform.python_version(),
               platform=platform.platform(),
               torch=torch.__version__,
               cuda=torch.version.cuda)
    if torch.cuda.is_available():
        env["devices"] = [torch.cuda.get_device_name(i)
                          for i in range(torch.cuda.device_count())]
    return env


class MetricsLogger:
    """Per-step scalars: JSONL and optional TensorBoard at each call, text
    every ``interval`` steps."""

    def __init__(self, work_dir: str, logger: logging.Logger,
                 interval: int = 10, use_tensorboard: bool = True):
        self.logger = logger
        self.interval = interval
        self.work_dir = work_dir
        os.makedirs(work_dir, exist_ok=True)
        self.jsonl_path = osp.join(work_dir, "metrics.jsonl")
        self.tb = None
        if use_tensorboard:
            try:
                from tensorboardX import SummaryWriter
                self.tb = SummaryWriter(osp.join(work_dir, "tf_logs"))
            except ImportError:
                pass
        self._t_last = time.time()

    def log_step(self, step: int, epoch: int, metrics: Dict[str, Any],
                 lr: float = None):
        scalars = {k: float(v) for k, v in metrics.items()}
        if lr is not None:
            scalars["lr"] = float(lr)
        now = time.time()
        scalars["time"] = now - self._t_last
        self._t_last = now
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(dict(step=step, epoch=epoch, **scalars)) + "\n")
        if self.tb is not None:
            for k, v in scalars.items():
                self.tb.add_scalar(k, v, step)
        if step % self.interval == 0:
            parts = ", ".join(f"{k}: {v:.4f}" for k, v in scalars.items())
            self.logger.info(f"Epoch [{epoch}] Iter [{step}] {parts}")

    def log_eval(self, step: int, metrics: Dict[str, Any]):
        """Epoch-end scalars (val losses, eval metrics) to JSONL and TB."""
        scalars = {k: float(v) for k, v in metrics.items()}
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(dict(step=step, **scalars)) + "\n")
        if self.tb is not None:
            for k, v in scalars.items():
                self.tb.add_scalar(k, v, step)

    def close(self):
        if self.tb is not None:
            self.tb.close()
