"""Data loading (counterpart of `btcdet_tpu/datasets/loader.py`): a
`torch.utils.data.DataLoader` over a dataset whose items and collated
batches are numpy. Worker processes fork from the main process when an
epoch's iterator is made (they are not persistent, so they see the
dataset's `_epoch` of that epoch); they run only the numpy / g++ host
pipeline, never CUDA.
"""

from __future__ import annotations

import numpy as np
import torch.utils.data as tud


class EpochShuffle(tud.Sampler):
    """A permutation of range(n) drawn from (seed + epoch), the JAX
    package's shuffle (`PyLoader` / `ShardSampler` on one shard): the same
    epoch gives the same order in any process, so a resumed run reads
    what an unbroken run reads. `set_epoch` before each epoch."""

    def __init__(self, n: int, seed: int = 0):
        self.n, self.seed, self.epoch = int(n), int(seed), 0

    def set_epoch(self, epoch: int):
        self.epoch = int(epoch)

    def __iter__(self):
        return iter(np.random.RandomState(self.seed + self.epoch).permutation(self.n).tolist())

    def __len__(self):
        return self.n


def make_loader(dataset, batch_size: int, shuffle: bool = False, num_workers: int = 0,
                collate_fn=None, drop_last: bool = False, sampler=None, seed: int = 0):
    """A DataLoader with the JAX package's iteration semantics (drop_last,
    collate_fn, len()); `shuffle` without a sampler orders each epoch by
    an `EpochShuffle` of `seed` (`loader.sampler.set_epoch(epoch)`)."""
    if shuffle and sampler is None:
        sampler = EpochShuffle(len(dataset), seed)
    return tud.DataLoader(dataset, batch_size=batch_size, shuffle=False,
                          num_workers=num_workers, collate_fn=collate_fn, drop_last=drop_last,
                          sampler=sampler, pin_memory=False)


class CachedDataset:
    """Memoize `dataset[i]` (a per-item cache). Sound only when __getitem__
    is deterministic, i.e. without stochastic augmentation."""

    def __init__(self, dataset):
        self._ds = dataset
        self._cache = {}

    def __getitem__(self, i):
        if i not in self._cache:
            self._cache[i] = self._ds[i]
        return self._cache[i]

    def __len__(self):
        return len(self._ds)

    def __getattr__(self, name):
        return getattr(self._ds, name)
