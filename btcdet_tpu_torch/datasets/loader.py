"""Data loading (counterpart of `btcdet_tpu/datasets/loader.py`): a
`torch.utils.data.DataLoader` over a dataset whose items and collated
batches are numpy. Worker processes fork from the main process; they run
only the numpy / g++ host pipeline, never CUDA.
"""

from __future__ import annotations

import torch.utils.data as tud


def make_loader(dataset, batch_size: int, shuffle: bool = False, num_workers: int = 0,
                collate_fn=None, drop_last: bool = False, sampler=None, seed: int = 0):
    """A DataLoader with the JAX package's iteration semantics (shuffle
    unless a sampler is given, drop_last, collate_fn, len()); a shuffled
    order is drawn from `seed`."""
    gen = None
    if shuffle and sampler is None:
        import torch

        gen = torch.Generator().manual_seed(seed)
    return tud.DataLoader(dataset, batch_size=batch_size, shuffle=(shuffle and sampler is None),
                          num_workers=num_workers, collate_fn=collate_fn, drop_last=drop_last,
                          sampler=sampler, pin_memory=False, generator=gen)


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
