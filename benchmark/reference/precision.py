"""The control of the correctness check: the reference one precision below
the configuration's bfloat16, in fp8.

Every weight of the reference is rounded to float8 e4m3 with a per-tensor
scale (its largest magnitude at 448, e4m3's largest value), and so is the
input of every module that holds a weight (the linears, the convolutions,
the deformable and sparse convolutions): what a change that ran the
model's products in fp8 would compute.  The sums stay float32.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

E4M3_MAX = 448.0


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3 under a per-tensor scale, back in x's dtype;
    the gradient passes straight through the rounding."""
    if not x.is_floating_point() or x.numel() == 0:
        return x
    d = x.detach()
    scale = d.abs().amax().float().clamp(min=1e-30) / E4M3_MAX
    q = ((d.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)
    return q if not x.requires_grad else x + (q - d)


def _weighted(model: nn.Module):
    return [m for m in model.modules()
            if isinstance(getattr(m, "weight", None), nn.Parameter)
            or isinstance(getattr(m, "in_proj_weight", None), nn.Parameter)]


@contextlib.contextmanager
def fp8(model: nn.Module):
    """``model`` computing as in fp8 inside: its weights rounded in place
    (they stay rounded) and the first tensor input of each weighted module
    rounded at every call."""

    def pre(module, args):
        if args and isinstance(args[0], torch.Tensor):
            return (round_fp8(args[0]),) + tuple(args[1:])
        return None

    with torch.no_grad():
        for p in model.parameters():
            p.copy_(round_fp8(p))
    handles = [m.register_forward_pre_hook(pre) for m in _weighted(model)]
    try:
        yield model
    finally:
        for h in handles:
            h.remove()
