"""GridMask image augmentation (train time).

Counterpart of ``unibev_tpu/models/gridmask.py::grid_mask`` with the
reference's wiring (use_h, use_w, rotate=1, offset=False, ratio=0.5, mode=1,
prob=0.7): with probability 0.7 per call, a period d in [2, H), a band width
l = clip(int(d * 0.5 + 0.5), 1, d - 1) and random phases; the periodic
squares where neither the row nor the column band covers are zeroed.  One
draw is shared by every image of the batch.

Split in two so that a test can feed the JAX package's draws:
:func:`sample_grid_mask` draws (apply, d, st_h, st_w) from an explicit
``torch.Generator``, and :func:`grid_mask_from_draws` applies them.  The
draws stay tensors on the generator's device, so a step on the card does not
wait for the host.
"""

from __future__ import annotations

import torch


def sample_grid_mask(H: int, W: int, generator: torch.Generator,
                     prob: float = 0.7):
    """(apply, d, st_h, st_w) as 0-dim tensors on the generator's device."""
    dev = generator.device
    apply = torch.rand((), generator=generator, device=dev) < prob
    d = torch.randint(2, H, (), generator=generator, device=dev)
    st_h = torch.randint(0, H, (), generator=generator, device=dev)
    st_w = torch.randint(0, W, (), generator=generator, device=dev)
    return apply, d, st_h, st_w


def grid_mask_from_draws(x: torch.Tensor, apply, d, st_h, st_w,
                         ratio: float = 0.5) -> torch.Tensor:
    """x (..., H, W) images (NCHW); the draws as ints or 0-dim tensors."""
    H, W = x.shape[-2:]
    dev = x.device
    d, st_h, st_w, apply = (torch.as_tensor(v, device=dev)
                            for v in (d, st_h, st_w, apply))
    l = torch.minimum((d.float() * ratio + 0.5).long().clamp(min=1), d - 1)
    st_h, st_w = st_h % d, st_w % d
    rows = (torch.arange(H, device=dev) + d - st_h) % d < l
    cols = (torch.arange(W, device=dev) + d - st_w) % d < l
    keep = rows[:, None] | cols[None, :] | ~apply           # 0 on the squares
    return x * keep.to(x.dtype)


def grid_mask(x: torch.Tensor, generator: torch.Generator,
              prob: float = 0.7, ratio: float = 0.5) -> torch.Tensor:
    """x (B, C, H, W): one mask drawn from ``generator`` for the batch."""
    draws = sample_grid_mask(x.shape[-2], x.shape[-1], generator, prob)
    return grid_mask_from_draws(x, *draws, ratio=ratio)
