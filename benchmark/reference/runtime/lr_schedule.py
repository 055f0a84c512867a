"""The learning-rate schedule of the reference optimizer config.

Counterpart of ``unibev_tpu/runtime/lr_schedule.py``: cosine annealing with a
linear warm-up over 500 iterations from warmup_ratio 1/3, down to
min_lr_ratio 1e-3 of the base rate.
"""

from __future__ import annotations

import math
from typing import Callable


def cosine_with_linear_warmup(base_lr: float, total_steps: int,
                              warmup_iters: int = 500,
                              warmup_ratio: float = 1.0 / 3,
                              min_lr_ratio: float = 1e-3) -> Callable[[int], float]:
    """The learning rate at each (0-based) optimizer step."""

    def schedule(step: int) -> float:
        if step < warmup_iters:
            frac = min(max(step / max(warmup_iters, 1), 0.0), 1.0)
            return base_lr * (warmup_ratio + (1 - warmup_ratio) * frac)
        t = min(max((step - warmup_iters) / max(total_steps - warmup_iters, 1),
                    0.0), 1.0)
        min_lr = base_lr * min_lr_ratio
        return min_lr + (base_lr - min_lr) * 0.5 * (1 + math.cos(math.pi * t))

    return schedule
