"""Optimizer and one training step.

Counterpart of ``unibev_tpu/parallel/train_state.py::make_optimizer`` and
``make_train_step`` on one device (the data-parallel mesh is not ported).
Optimizer parity with the reference config: AdamW lr 2e-4, weight decay
0.01, gradient clipping at a global norm of 35, the cosine schedule with
linear warm-up, and per-path learning-rate multipliers (lr 0 on the frozen
stem and stage 1 of the image backbone, x0.1 on both backbones).

optax applies the weight decay before the learning rate and the multiplier
(``add_decayed_weights`` then ``scale_by_learning_rate`` then the path
scaling); ``torch.optim.AdamW`` with the multiplied rate per parameter group
gives the same update, ``p - lr * mult * (adam + wd * p)``.  optax also
decays a parameter whose gradient is zero, so the step gives every trainable
parameter that received no gradient a zero one (in C mode the LiDAR-side CNW
weights) instead of letting AdamW skip it.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import torch
from torch import nn

from unibev_tpu_torch.runtime.lr_schedule import cosine_with_linear_warmup

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


def lr_mult(name: str) -> float:
    """The multiplier of the first :data:`PARAMWISE` rule whose pattern is
    found in ``name``."""
    for pattern, mult in PARAMWISE:
        if re.search(pattern, name):
            return mult
    return 1.0


def make_optimizer(model: nn.Module):
    """(AdamW with one parameter group per multiplier, its LambdaLR).

    Clipping is the train step's (:data:`GRAD_CLIP`).  Returns the optimizer
    and the scheduler; ``scheduler.step()`` after each optimizer step.
    """
    groups: Dict[float, list] = {}
    for name, p in model.named_parameters():
        groups.setdefault(lr_mult(name), []).append(p)
    opt = torch.optim.AdamW(
        [dict(params=ps, lr=BASE_LR * m, lr_mult=m)
         for m, ps in sorted(groups.items())],
        lr=BASE_LR, betas=(0.9, 0.999), eps=1e-8, weight_decay=WEIGHT_DECAY)
    schedule = cosine_with_linear_warmup(BASE_LR, TOTAL_STEPS, WARMUP_ITERS,
                                         WARMUP_RATIO, MIN_LR_RATIO)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: schedule(step) / BASE_LR)
    return opt, sched


def train_step(model: nn.Module, opt: torch.optim.Optimizer, sched,
               batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """One step: forward (train mode draws GridMask and dropout from
    ``generator``), the head loss, backward, clipping at :data:`GRAD_CLIP`,
    AdamW and the schedule.

    A model whose compute dtype is not float32 (the flagship's bf16) runs
    the forward and the loss under ``torch.autocast`` in that dtype, on the
    parameters' device, while its parameters stay float32, as flax keeps
    them.  In train mode the LiDAR branch's BatchNorms update their running
    statistics once per step.  Returns the losses, ``loss`` (their sum) and
    ``grad_norm`` (before clipping), as the JAX step's metrics, and the
    forward's ``sca_overflow`` and modality flags ``l_flag`` / ``c_flag``,
    detached, on the model's device.
    """
    dtype = model.compute_dtype
    device = next(model.parameters()).device
    opt.zero_grad(set_to_none=True)
    with torch.autocast(device.type, dtype=dtype,
                        enabled=dtype != torch.float32):
        preds = model(batch, generator)
        losses = model.loss(batch, preds)
    total = sum(losses.values())
    total.backward()
    params = [p for p in model.parameters() if p.requires_grad]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grad_norm = torch.nn.utils.clip_grad_norm_(params, GRAD_CLIP)
    opt.step()
    sched.step()
    metrics = {k: v.detach() for k, v in losses.items()}
    metrics["loss"] = total.detach()
    metrics["grad_norm"] = grad_norm.detach()
    for k in ("sca_overflow", "l_flag", "c_flag"):
        metrics[k] = preds[k]
    return metrics
