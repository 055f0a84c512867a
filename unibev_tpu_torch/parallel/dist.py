"""Multi-process utilities: the process group, host gathers, data shards.

Counterpart of ``unibev_tpu/parallel/dist.py``.  The JAX package runs one
process per host over a device mesh; the port runs one process per card
(``python -m torch.distributed.run``, which sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK`` and the rendezvous address), joined in one
``torch.distributed`` process group: NCCL between cards, gloo on the CPU.
Under a launcher the group is made at any world size, one rank included,
and the data-parallel path (``DistributedDataParallel``, the reductions
below) runs; without one every helper here is the single-process identity
and no group is made.

``process_allgather`` gathers fixed-shape numpy arrays on the host (over a
gloo group beside an NCCL one), as the JAX package's does for the eval
results; ``sum_over_ranks`` is the differentiable all-reduce that the
synchronized batch statistics and the losses' global average factors use;
``shard_indices`` is this rank's share of a dataset with the JAX package's
semantics (``DistributedSampler``'s: equal shares, padded by wrapping
around, or trimmed with ``drop_last``).
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

_HOST_GROUP: Any = None


def is_distributed() -> bool:
    """A process group is up (the data-parallel path runs)."""
    return dist.is_available() and dist.is_initialized()


def get_rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def get_world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def init_dist(device: str = "cuda") -> torch.device:
    """Join the process group the launcher describes and return this rank's
    device: ``cuda:LOCAL_RANK`` for ``device`` "cuda" (the card the rank
    owns, made current), else ``device``.  The backend is NCCL on the card
    and gloo on the CPU.  Without a
    launcher (no ``WORLD_SIZE`` in the environment) it does nothing, as the
    JAX ``init_dist`` does on one host."""
    device = torch.device(device)
    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return device
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    return device


def _host_group():
    """A gloo group for host tensors: the default group when it is gloo,
    else one made on the first call (every rank makes it at the same
    collective call)."""
    global _HOST_GROUP
    if dist.get_backend() == "gloo":
        return None
    if _HOST_GROUP is None:
        _HOST_GROUP = dist.new_group(backend="gloo")
    return _HOST_GROUP


def process_allgather(tree: Any) -> Any:
    """Gather a numpy array, or a dict of them, from every rank: each comes
    back with a leading rank axis, as the JAX ``process_allgather`` stacks
    its processes.  Every rank must pass the same shapes and dtypes.
    Without a process group the input comes back as it is."""
    if not is_distributed():
        return tree
    if isinstance(tree, dict):
        return {k: process_allgather(v) for k, v in tree.items()}
    local = torch.from_numpy(np.ascontiguousarray(tree))
    parts = [torch.empty_like(local) for _ in range(get_world_size())]
    dist.all_gather(parts, local, group=_host_group())
    return torch.stack(parts).numpy()


def sum_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks, differentiable (the backward sums the
    gradients over the ranks, which is the gradient of the sum of every
    rank's loss); ``x`` itself without a process group."""
    if not is_distributed():
        return x
    from torch.distributed.nn.functional import all_reduce
    return all_reduce(x)


def shard_indices(n: int, shuffle: bool = True, seed: int = 0,
                  drop_last: bool = True) -> np.ndarray:
    """This rank's sample indices: the ``RandomState(seed).permutation(n)``
    order (``arange(n)`` without ``shuffle``) cut into equal contiguous
    shares, one per rank; ``drop_last`` trims the tail that does not divide,
    else the order is padded by wrapping around to its start."""
    order = (np.random.RandomState(seed).permutation(n)
             if shuffle else np.arange(n))
    world, rank = get_world_size(), get_rank()
    per = n // world if drop_last else -(-n // world)
    if not drop_last:
        pad = per * world - n
        order = np.concatenate([order, order[:pad]])
    return order[rank * per:(rank + 1) * per]
