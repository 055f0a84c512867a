"""Optimizer, one training step and one validation step, data parallel.

Counterpart of ``unibev_tpu/parallel/train_state.py::make_optimizer``,
``make_train_step``, ``make_val_step`` and ``make_sharded_train_step``.
The JAX step shards the global batch over a ``data`` mesh axis with the
parameters replicated; the port runs one process per card, each on its
share of the global batch, with the model in ``DistributedDataParallel``
(:func:`data_parallel`), which averages the gradients over the ranks.  What
the mesh reduces over the global batch is reduced over the ranks here too:
the LiDAR branch's batch statistics (``layers.BatchNorm2d``,
``middle_encoder.MaskedBatchNorm``) and the losses' average factors (the
head), so N ranks at batch B step as one process at batch N * B (up to
the order of float sums).  The defaults are the reference config's: AdamW lr
2e-4, weight decay 0.01, gradient clipping at a global norm of 35, the
cosine schedule with linear warm-up, and per-path learning-rate multipliers
(lr 0 on the frozen stem and stage 1 of the image backbone, x0.1 on both
backbones); ``make_optimizer`` takes each from a config as the JAX one does.

optax applies the weight decay before the learning rate and the multiplier
(``add_decayed_weights`` then ``scale_by_learning_rate`` then the path
scaling); ``torch.optim.AdamW`` with the multiplied rate per parameter group
gives the same update, ``p - lr * mult * (adam + wd * p)``.  optax also
decays a parameter whose gradient is zero, so the step gives every trainable
parameter that received no gradient a zero one (in C mode the LiDAR-side CNW
weights) instead of letting AdamW skip it.
"""

from __future__ import annotations

import contextlib
import re
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.parallel import DistributedDataParallel

from benchmark.reference.parallel.dist import get_world_size, is_distributed
from benchmark.reference.runtime.lr_schedule import cosine_with_linear_warmup

PARAMWISE = (
    (r"img_backbone\.(conv1|bn1|layer1\.)", 0.0),
    (r"img_backbone", 0.1),
    (r"pts_backbone", 0.1),
)
BASE_LR = 2e-4
WEIGHT_DECAY = 0.01
TOTAL_STEPS = 100000
WARMUP_ITERS = 500
WARMUP_RATIO = 1.0 / 3
MIN_LR_RATIO = 1e-3
GRAD_CLIP = 35.0


def lr_mult(name: str,
            rules: Sequence[Tuple[str, float]] = PARAMWISE) -> float:
    """The multiplier of the first rule whose pattern is found in ``name``."""
    for pattern, mult in rules:
        if re.search(pattern, name):
            return mult
    return 1.0


def make_optimizer(model: nn.Module, base_lr: float = BASE_LR,
                   weight_decay: float = WEIGHT_DECAY,
                   total_steps: int = TOTAL_STEPS,
                   warmup_iters: int = WARMUP_ITERS,
                   warmup_ratio: float = WARMUP_RATIO,
                   min_lr_ratio: float = MIN_LR_RATIO,
                   grad_clip: float = GRAD_CLIP,
                   paramwise: Sequence[Tuple[str, float]] = PARAMWISE):
    """(AdamW with one parameter group per multiplier, its LambdaLR).

    ``scheduler.step()`` after each optimizer step.  ``grad_clip`` is kept
    in every parameter group (so the optimizer's state_dict carries it);
    :func:`train_step` clips at it unless told otherwise.
    """
    groups: Dict[float, list] = {}
    for name, p in model.named_parameters():
        groups.setdefault(lr_mult(name, paramwise), []).append(p)
    opt = torch.optim.AdamW(
        [dict(params=ps, lr=base_lr * m, lr_mult=m, grad_clip=grad_clip)
         for m, ps in sorted(groups.items())],
        lr=base_lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
    schedule = cosine_with_linear_warmup(base_lr, total_steps, warmup_iters,
                                         warmup_ratio, min_lr_ratio)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: schedule(step) / base_lr)
    return opt, sched


def data_parallel(model: nn.Module, device) -> nn.Module:
    """``model`` in ``DistributedDataParallel`` under a process group (on
    ``device``, the rank's card or the CPU), else ``model`` itself.  Buffers
    are not broadcast at each forward: the synchronized batch statistics
    keep them equal on every rank.  No parameter goes unused: a branch that
    modality dropout drops still runs and gets zero gradients."""
    if not is_distributed():
        return model
    device = torch.device(device)
    return DistributedDataParallel(
        model, device_ids=[device] if device.type == "cuda" else None,
        broadcast_buffers=False)


def unwrap(model: nn.Module) -> nn.Module:
    """The module inside a ``DistributedDataParallel`` (or ``model``)."""
    return model.module if isinstance(model, DistributedDataParallel) else model


def compute_autocast(model: nn.Module):
    """``torch.autocast`` to the model's compute dtype where its parameters
    are float32 and that dtype is not (a training build of a bf16 model);
    a no-op otherwise (an inference build already holds bf16 parameters)."""
    dtype = model.compute_dtype
    p = next(model.parameters())
    return torch.autocast(p.device.type, dtype=dtype,
                          enabled=dtype != torch.float32
                          and p.dtype == torch.float32)


@contextlib.contextmanager
def eval_mode(model: nn.Module):
    """``model.eval()`` inside, each submodule's own mode restored after."""
    modes = [(m, m.training) for m in model.modules()]
    model.eval()
    try:
        yield model
    finally:
        for m, training in modes:
            m.training = training


def train_step(model: nn.Module, opt: torch.optim.Optimizer, sched,
               batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None,
               grad_clip: Optional[float] = None,
               flag_generator: Optional[torch.Generator] = None
               ) -> Dict[str, torch.Tensor]:
    """One step: forward (train mode draws GridMask and dropout from
    ``generator``, the modality flags from ``flag_generator`` where given),
    the head loss, backward, clipping the global norm at ``grad_clip`` (by
    default the optimizer's, :func:`make_optimizer`), AdamW and the
    schedule.

    ``model`` may be a :func:`data_parallel` one: each rank then runs its
    share of the global batch, its losses are its part of the global
    batch's (the average factors are global), and it back-propagates
    world size x its loss, so that DDP's mean of the ranks' gradients is the
    gradient of the global batch's loss; the metrics are summed (the
    losses) or maxed (``sca_overflow``) over the ranks.

    A model whose compute dtype is not float32 (the flagship's bf16) runs
    the forward and the loss under ``torch.autocast`` in that dtype, on the
    parameters' device, while its parameters stay float32, as flax keeps
    them.  In train mode the LiDAR branch's BatchNorms update their running
    statistics once per step.  Returns the losses, ``loss`` (their sum) and
    ``grad_norm`` (before clipping), as the JAX step's metrics, and the
    forward's ``sca_overflow`` and modality flags ``l_flag`` / ``c_flag``,
    detached, on the model's device.
    """
    net = unwrap(model)
    world = get_world_size()
    opt.zero_grad(set_to_none=True)
    with compute_autocast(net):
        preds = model(batch, generator, flag_generator)
        losses = net.loss(batch, preds)
    total = sum(losses.values())
    (total * world).backward()
    params = [p for p in net.parameters() if p.requires_grad]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if grad_clip is None:
        grad_clip = opt.param_groups[0]["grad_clip"]
    grad_norm = torch.nn.utils.clip_grad_norm_(params, grad_clip)
    opt.step()
    sched.step()
    metrics = {k: v.detach() for k, v in losses.items()}
    metrics["loss"] = total.detach()
    overflow = preds["sca_overflow"]
    if is_distributed():
        # the ranks' losses summed (each is its part of the global batch's),
        # the overflow maxed; on the device, no host sync
        summed = torch.stack([v.float() for v in metrics.values()])
        dist.all_reduce(summed)
        metrics = dict(zip(metrics, summed.unbind()))
        overflow = overflow.clone()
        dist.all_reduce(overflow, op=dist.ReduceOp.MAX)
    metrics["grad_norm"] = grad_norm.detach()
    metrics["sca_overflow"] = overflow
    for k in ("l_flag", "c_flag"):
        metrics[k] = preds[k]
    return metrics


def val_step(model: nn.Module,
             batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The losses of an eval-mode forward, and ``loss``, their sum: the val
    workflow's step (no optimizer step, no gradients), in the model's compute
    dtype.  The model is left in the mode it was found in.  Under a process
    group each rank's losses are its part of the global batch's (every rank
    must call it)."""
    with eval_mode(model), torch.no_grad(), compute_autocast(model):
        losses = model.loss(batch, model(batch))
    losses = dict(losses)
    losses["loss"] = sum(losses.values())
    return losses
