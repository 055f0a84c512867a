"""Rank bodies of the data-parallel tests (tests/test_torch_dist.py,
tests/test_torch_lidar_train.py), spawned by
``unibev_tpu_torch.tools.ddp_check.spawn_ranks``: each rank runs on the CPU
in a gloo group, reads its inputs from ``path`` and writes what it computed
there.  Imports torch and the port only (the ranks import no JAX)."""

from __future__ import annotations

import os.path as osp

import torch
import torch.distributed as dist

from unibev_tpu_torch.flagship import build_model, tiny_model_cfg
from unibev_tpu_torch.models.backbones.second import SECOND
from unibev_tpu_torch.models.layers import BatchNorm2d
from unibev_tpu_torch.models.middle_encoder import MaskedBatchNorm
from unibev_tpu_torch.parallel.train_state import data_parallel
from unibev_tpu_torch.tools.ddp_check import LIDAR_MODULES


MODULES = {"SECOND": SECOND, "BatchNorm2d": BatchNorm2d,
           "MaskedBatchNorm": MaskedBatchNorm}


def bn_rank(rank: int, world: int, path: str) -> None:
    """Each case of ``bn_cases.pt`` in train mode on this rank's share of
    the batch (its rows: ``x[rank]``, ``cot[rank]``, ``mask[rank]``): the
    output, the parameter gradients summed over the ranks (the gradient of
    the sum of every rank's loss), the input gradient and the module's
    buffers after the step."""
    out = {}
    for name, case in torch.load(osp.join(path, "bn_cases.pt")).items():
        m = MODULES[case["kind"]](**case["cfg"])
        m.load_state_dict(case["state"], strict=True)
        m.train()
        x = case["x"][rank].clone().requires_grad_()
        args = (x,) if "mask" not in case else (x, case["mask"][rank])
        y = m(*args)
        y = y if isinstance(y, tuple) else (y,)
        sum((o * c).sum() for o, c in zip(y, case["cot"][rank])).backward()
        grads = {}
        for n, p in m.named_parameters():
            g = p.grad.clone()
            dist.all_reduce(g)
            grads[n] = g
        out[name] = dict(out=[o.detach() for o in y], dx=x.grad,
                         grads=grads, buffers=dict(m.named_buffers()))
    torch.save(out, osp.join(path, f"bn_rank{rank}.pt"))


def lc_loss_rank(rank: int, world: int, path: str,
                 lidar_train: bool = False) -> None:
    """The tiny LC model of ``lc_state.pt`` in eval mode with gradients on,
    in ``DistributedDataParallel``, on batch ``rank`` of ``lc_batches.pt``:
    its losses (this rank's part of the global batch's) and, after the
    backward of world x their sum, DDP's mean gradients, as
    ``parallel/train_state.py::train_step`` computes them; with
    ``lidar_train`` the LiDAR modules run in train mode (batch statistics
    synchronized over the ranks), and their running statistics are saved
    too."""
    model = build_model(tiny_model_cfg(use_lidar=True), "cpu", seed=1,
                        train=True)
    model.load_state_dict(torch.load(osp.join(path, "lc_state.pt")),
                          strict=True)
    model.eval()
    if lidar_train:
        for name in LIDAR_MODULES:
            getattr(model, name).train()
    net = data_parallel(model, "cpu")
    batch = torch.load(osp.join(path, "lc_batches.pt"))[rank]
    losses = model.loss(batch, net(batch))
    (sum(losses.values()) * world).backward()
    torch.save(dict(losses={k: v.detach() for k, v in losses.items()},
                    grads={n: None if p.grad is None else p.grad.clone()
                           for n, p in model.named_parameters()},
                    stats={n: b.clone() for n, b in model.named_buffers()
                           if n.startswith(LIDAR_MODULES)
                           and n.endswith(("running_mean", "running_var"))}),
               osp.join(path, f"lc_rank{rank}.pt"))
