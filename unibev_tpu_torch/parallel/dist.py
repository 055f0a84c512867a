"""Per-process dataset sharding.

Counterpart of ``unibev_tpu/parallel/dist.py::shard_indices`` at world size
1: the port runs one process on one card, which holds every index.
``init_dist`` and ``process_allgather`` come with the data-parallel step
(ROADMAP A7).
"""

from __future__ import annotations

import numpy as np


def shard_indices(n: int, shuffle: bool = True, seed: int = 0,
                  drop_last: bool = True) -> np.ndarray:
    """This process's sample indices: all ``n``, in the order of
    ``RandomState(seed).permutation`` when ``shuffle``.  ``drop_last`` (the
    JAX signature's) trims nothing at world size 1."""
    return (np.random.RandomState(seed).permutation(n) if shuffle
            else np.arange(n))
