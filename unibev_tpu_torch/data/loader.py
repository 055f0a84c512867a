"""The training data loader: ``torch.utils.data.DataLoader`` in the JAX
loader's order.

Counterpart of ``unibev_tpu/data/loader.py``.  The batches hold the indices
of ``shard_indices(n, shuffle, seed + epoch, drop_last)`` in turn, as the
JAX loader cuts them.  Worker processes (``num_workers``, the config's
``workers_per_gpu``) run the numpy pipeline; a batch comes back as CPU
tensors through shared memory, pinned when ``pin_memory``.

The epoch reaches the workers with every index: the sampler yields
``(epoch, index)`` pairs and the dataset's ``epoch`` is set from them in the
process that loads the sample, so each epoch draws fresh augmentations
whichever process runs it.  ``__iter__`` runs epoch ``self.epoch`` and then
advances it; set ``epoch`` to resume at another.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Tuple

import numpy as np
import torch

from unibev_tpu_torch.data.nuscenes_dataset import collate
from unibev_tpu_torch.parallel.dist import shard_indices


class _EpochBatches(torch.utils.data.Sampler):
    """Batches of (epoch, index) pairs in the JAX loader's order."""

    def __init__(self, n: int, batch_size: int, shuffle: bool, seed: int,
                 drop_last: bool):
        self.n, self.batch_size = n, batch_size
        self.shuffle, self.seed, self.drop_last = shuffle, seed, drop_last
        self.epoch = 0

    def __len__(self):
        n = self.n // self.batch_size
        return n if self.drop_last else -(-self.n // self.batch_size)

    def __iter__(self) -> Iterator[List[Tuple[int, int]]]:
        idxs = shard_indices(self.n, shuffle=self.shuffle,
                             seed=self.seed + self.epoch,
                             drop_last=self.drop_last)
        bs = self.batch_size
        batches = [idxs[i:i + bs] for i in range(0, len(idxs) - bs + 1, bs)]
        if not self.drop_last and len(idxs) % bs:
            batches.append(idxs[-(len(idxs) % bs):])
        for b in batches:
            yield [(self.epoch, int(i)) for i in b]


class _AtEpoch(torch.utils.data.Dataset):
    """``dataset[i]`` with ``dataset.epoch`` set from the key (epoch, i)."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, key: Tuple[int, int]):
        epoch, index = key
        if hasattr(self.dataset, "epoch"):
            self.dataset.epoch = epoch
        return self.dataset[index]


def to_tensors(batch: Dict[str, Any], pin: bool = False) -> Dict[str, Any]:
    """A collated batch's arrays as CPU tensors (pinned with ``pin``);
    ``img_metas`` stays as it is."""
    out = {}
    for k, v in batch.items():
        if k != "img_metas":
            v = v if isinstance(v, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(v))
            v = v.pin_memory() if pin else v
        out[k] = v
    return out


def collate_tensors(samples: List[Dict[str, Any]]) -> Dict[str, Any]:
    """:func:`collate`, with the arrays as CPU tensors (a worker hands those
    to the main process through shared memory)."""
    return to_tensors(collate(samples))


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 2, seed: int = 0, drop_last: bool = True,
                 pin_memory: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = _EpochBatches(len(dataset), batch_size, shuffle, seed,
                                     drop_last)
        self.loader = torch.utils.data.DataLoader(
            _AtEpoch(dataset), batch_sampler=self.sampler,
            num_workers=max(0, num_workers), collate_fn=collate_tensors,
            pin_memory=pin_memory)
        self.epoch = 0

    def __len__(self):
        return len(self.sampler)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        self.sampler.epoch = self.epoch
        self.epoch += 1
        return iter(self.loader)
