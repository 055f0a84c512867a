"""The epoch-based training loop (mmcv's EpochBasedRunner).

Counterpart of ``unibev_tpu/runtime/train_loop.py::Runner``, on one card or
data parallel over the ranks of a process group (``parallel/dist.py``: one
process per card, the model in ``DistributedDataParallel``).  It reads the
config as the JAX Runner does at that many devices: the global batch
(``samples_per_gpu`` on each rank), ``max_epochs``, the optimizer,
``lr_config`` and ``optimizer_config.grad_clip``, the checkpoint cadence
(every ``interval`` epochs and every epoch from CheckpointLateStageHook's
``start``), the log interval, ``evaluation.interval``, the ``workflow`` (a
val-loss pass each epoch where it holds ``('val', 1)``) and
``val_loss_max_batches``.  Under a
process group rank 0 alone logs and writes checkpoints (the reference's
keys, no ``module.`` prefix, with every rank's training generator), every
rank loads them, and the modality flags come from a generator seeded alike
on every rank, so all drop the same modality.

Metrics are read back to the host only every ``log_config.interval`` steps,
as the JAX loop reads them: a ``float()`` per step would add a host sync
per step.  The logged scalars add the loader's wait per step (``data_time``,
seconds) and, on the card, the host-to-device copy time per step
(``copy_ms``, CUDA events) and each hand kernel's launches per step
(``launches/<kernel>``, from ``ops/_build.launches``), each averaged since
the last log.
"""

from __future__ import annotations

import os.path as osp
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from unibev_tpu_torch.data.loader import to_tensors
from unibev_tpu_torch.data.nuscenes_dataset import collate
from unibev_tpu_torch.flagship import build_model_from_config
from unibev_tpu_torch.ops import _build
from unibev_tpu_torch.parallel.dist import (get_rank, get_world_size,
                                            process_allgather, sum_over_ranks)
from unibev_tpu_torch.parallel.train_state import (data_parallel,
                                                   make_optimizer, train_step,
                                                   val_step)
from unibev_tpu_torch.runtime.checkpoints import (CheckpointManager,
                                                  load_params,
                                                  restore_state_from)
from unibev_tpu_torch.runtime.logging_utils import MetricsLogger
from unibev_tpu_torch.runtime.lr_schedule import cosine_with_linear_warmup
from unibev_tpu_torch.runtime.predict import to_device


class Runner:
    def __init__(self, cfg, dataset, work_dir: str, logger, val_dataset=None,
                 eval_fn: Optional[Callable] = None, seed: int = 0,
                 device="cuda"):
        self.cfg = cfg
        self.dataset = dataset
        self.val_dataset = val_dataset
        self.eval_fn = eval_fn
        self.work_dir = work_dir
        self.logger = logger
        self.seed = seed
        self.device = torch.device(device)
        self.rank, self.world = get_rank(), get_world_size()

        # the global batch, as the JAX Runner's samples_per_gpu x devices
        self.samples_per_gpu = int(cfg.get("samples_per_gpu", 1))
        self.samples_per_step = self.samples_per_gpu * self.world
        self.max_epochs = int(cfg.get("max_epochs",
                                      cfg.get("total_epochs", 36)))
        self.steps_per_epoch = max(1, len(dataset) // self.samples_per_step)
        total_steps = self.steps_per_epoch * self.max_epochs

        opt_cfg = dict(cfg.get("optimizer", {}))
        lr_cfg = dict(cfg.get("lr_config", {}))
        grad_clip = dict(cfg.get("optimizer_config", {}) or {}).get(
            "grad_clip", {}).get("max_norm", 35.0)
        self.optim = dict(
            base_lr=opt_cfg.get("lr", 2e-4),
            weight_decay=opt_cfg.get("weight_decay", 0.01),
            total_steps=total_steps,
            warmup_iters=lr_cfg.get("warmup_iters", 500),
            warmup_ratio=lr_cfg.get("warmup_ratio", 1.0 / 3),
            min_lr_ratio=lr_cfg.get("min_lr_ratio", 1e-3),
            grad_clip=grad_clip)
        self.lr_schedule = cosine_with_linear_warmup(
            *(self.optim[k] for k in ("base_lr", "total_steps", "warmup_iters",
                                      "warmup_ratio", "min_lr_ratio")))

        late = None
        for hook in cfg.get("custom_hooks", []) or []:
            if hook.get("type") == "CheckpointLateStageHook":
                late = hook.get("start")
        self.ckpt = CheckpointManager(
            osp.join(work_dir, "checkpoints"),
            interval=dict(cfg.get("checkpoint_config", {}) or {}).get("interval", 6),
            late_stage_start=late)

        self.metrics = MetricsLogger(
            work_dir, logger,
            interval=dict(cfg.get("log_config", {}) or {}).get("interval", 10),
            use_tensorboard=self.rank == 0)

        # the reference's ``evaluation = dict(interval=1)`` and its
        # ``workflow = [('train', 1), ('val', 1)]``: mmcv runs a loss pass
        # over the val split each epoch besides the metric's EvalHook
        self.eval_interval = int(dict(
            cfg.get("evaluation", {}) or {}).get("interval", 1))
        workflow = cfg.get("workflow", [("train", 1)]) or [("train", 1)]
        self.val_loss_epochs = any(
            str(mode) == "val" for mode, _ in workflow)
        # the val loss is a smoothed signal, not a metric: 50 batches bound
        # its cost at full scale
        self.val_loss_max_batches = int(cfg.get("val_loss_max_batches", 50))

        self.model = self.net = self.opt = self.sched = None
        self.generator = self.flag_generator = None
        self.step = self.epoch = 0      # steps taken, epochs finished

    # ------------------------------------------------------------------ state

    def init_state(self, load_from: Optional[str] = None,
                   resume_from: Optional[str] = None) -> None:
        """Build the training model from the config and ``seed`` (``net``,
        its data-parallel form under a process group), its optimizer and
        the training generators (GridMask and dropout per rank; the flags
        from one seed on every rank); then warm-start from ``load_from`` and
        resume from ``resume_from`` or else from the work dir's newest
        checkpoint."""
        self.model = build_model_from_config(self.cfg, self.device,
                                             seed=self.seed, train=True)
        if load_from:
            load_params(load_from, self.model)
            self.logger.info(f"warm-started from {load_from}")
        self.net = data_parallel(self.model, self.device)
        self.opt, self.sched = make_optimizer(self.model, **self.optim)
        self.generator = torch.Generator(device=self.device).manual_seed(
            self.seed + 7 + self.rank)
        self.flag_generator = torch.Generator(device=self.device).manual_seed(
            self.seed + 6)
        self.step = self.epoch = 0
        if resume_from:
            # an explicit path wins (the reference's --resume-from)
            self.load_state(restore_state_from(resume_from))
            self.logger.info(f"resumed from {resume_from} at step {self.step}")
        elif self.ckpt.latest_step() is not None:
            self.load_state(self.ckpt.restore())
            self.logger.info(f"resumed at step {self.step}")

    def state(self) -> Dict:
        """The training state, with the flags' generator; under a process
        group also every rank's generator (every rank must call it)."""
        state = dict(model=self.model.state_dict(),
                     optimizer=self.opt.state_dict(),
                     scheduler=self.sched.state_dict(), step=self.step,
                     epoch=self.epoch, generator=self.generator.get_state(),
                     flag_generator=self.flag_generator.get_state())
        if self.world > 1:
            ranks = process_allgather(state["generator"].numpy())
            state["rank_generators"] = [torch.from_numpy(g) for g in ranks]
        return state

    def load_state(self, state: Dict) -> None:
        """Restore :meth:`state` (on every rank).  A checkpoint written at
        another world size keeps this run's per-rank generators; the flags'
        generator, one for every rank, is restored at any world size."""
        self.model.load_state_dict(state["model"])
        self.opt.load_state_dict(state["optimizer"])
        self.sched.load_state_dict(state["scheduler"])
        ranks = state.get("rank_generators")
        if self.world == 1:
            self.generator.set_state(state["generator"])
        elif ranks is not None and len(ranks) == self.world:
            self.generator.set_state(ranks[self.rank])
        if "flag_generator" in state:
            self.flag_generator.set_state(state["flag_generator"])
        self.step, self.epoch = int(state["step"]), int(state["epoch"])

    def save(self) -> Optional[str]:
        """Write the state (rank 0) and return its path; None on the other
        ranks (every rank must call it)."""
        state = self.state()
        return self.ckpt.save(self.step, state) if self.rank == 0 else None

    # -------------------------------------------------------------------- run

    def run(self, loader, max_steps: Optional[int] = None) -> None:
        """Train from the epoch the step count implies (a resumed job goes on
        where it stopped) to ``max_epochs``, at most ``max_steps`` steps in
        this call; checkpoints, val-loss passes and evaluations at their
        epochs."""
        start_epoch = self.step // self.steps_per_epoch
        if start_epoch:
            self.logger.info(f"continuing at epoch {start_epoch} (step "
                             f"{self.step}, {self.steps_per_epoch} "
                             f"steps/epoch)")
        cuda = self.device.type == "cuda"
        done = 0
        waits, copies = [], []
        logged = (self.step, dict(_build.launches))
        for epoch in range(start_epoch, self.max_epochs):
            loader.epoch = epoch
            batches = iter(loader)
            while max_steps is None or done < max_steps:
                t0 = time.perf_counter()
                batch = next(batches, None)
                if batch is None:
                    break
                waits.append(time.perf_counter() - t0)
                if cuda:
                    events = [torch.cuda.Event(enable_timing=True)
                              for _ in range(2)]
                    events[0].record()
                batch = to_device(batch, self.device)
                if cuda:
                    events[1].record()
                    copies.append(events)
                metrics = train_step(self.net, self.opt, self.sched, batch,
                                     self.generator,
                                     flag_generator=self.flag_generator)
                self.step += 1
                done += 1
                if self.rank == 0 and self.step % self.metrics.interval == 0:
                    host = {k: float(v) for k, v in metrics.items()}
                    host["data_time"] = float(np.mean(waits))
                    if copies:
                        host["copy_ms"] = float(np.mean(
                            [a.elapsed_time(b) for a, b in copies]))
                    waits, copies = [], []
                    # the hand kernels' launches per step since the last log
                    (then, prev), now = logged, dict(_build.launches)
                    for k, v in now.items():
                        if v != prev.get(k, 0):
                            host[f"launches/{k}"] = (v - prev.get(k, 0)) / (
                                self.step - then)
                    logged = (self.step, now)
                    self.metrics.log_step(self.step, epoch, host,
                                          lr=self.lr_schedule(self.step))
            del batches          # ends the epoch's worker processes
            self.epoch = epoch + 1
            if self.ckpt.should_save(epoch):
                self.save()
                self.logger.info(f"saved checkpoint at epoch {epoch + 1}")
            if self.val_loss_epochs and self.val_dataset is not None:
                losses = self._val_loss_pass()
                self.logger.info(f"epoch {epoch + 1} val loss: "
                                 + ", ".join(f"{k}={v:.4f}"
                                             for k, v in losses.items()))
                if self.rank == 0:
                    self.metrics.log_eval(self.step, {
                        f"val/{k}": v for k, v in losses.items()})
            if (self.eval_fn is not None and self.val_dataset is not None
                    and (epoch + 1) % self.eval_interval == 0):
                results = self.eval_fn(self.model, self.val_dataset)
                self.logger.info(f"epoch {epoch + 1} eval: {results}")
            if max_steps is not None and done >= max_steps:
                break

    def _val_loss_pass(self, step_fn: Callable = val_step) -> Dict[str, float]:
        """Mean losses over (a bounded number of) whole global val batches;
        each rank runs its share of a batch and the ranks' losses are summed
        (every rank must call it)."""
        G, B = self.samples_per_step, self.samples_per_gpu
        n = min(len(self.val_dataset), G * self.val_loss_max_batches)
        sums: Dict[str, float] = {}
        count = 0
        for b0 in range(0, n - G + 1, G):
            first = b0 + self.rank * B
            batch = collate([self.val_dataset[i]
                             for i in range(first, first + B)])
            losses = step_fn(self.model,
                             to_device(to_tensors(batch), self.device))
            for k, v in losses.items():
                sums[k] = sums.get(k, 0.0) + float(sum_over_ranks(v))
            count += 1
        return {k: v / max(count, 1) for k, v in sums.items()}
