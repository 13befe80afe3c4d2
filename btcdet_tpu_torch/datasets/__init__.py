"""Datasets and data loading (counterpart of `btcdet_tpu/datasets/`).

Distributed loading follows the JAX package: each rank takes a
contiguous shard of the (shuffled) index set (`ShardSampler`), and the
last shard is padded so that every rank runs the same number of steps.
"""

import numpy as np

from .synthetic import make_synthetic_batch, make_synthetic_batch_np  # noqa: F401

__all_datasets__ = {}


def _registry():
    if not __all_datasets__:
        from .kitti.kitti_dataset import KittiDataset

        __all_datasets__["KittiDataset"] = KittiDataset
    return __all_datasets__


class ShardSampler:
    """Rank `shard_id`'s contiguous shard of range(n), or of its
    permutation by (seed + epoch) when `shuffle`: ceil(n / num_shards)
    indices, the last shard padded from the front of the index set (the
    JAX package's `ShardSampler`, `btcdet_tpu/datasets/__init__.py:26-55`).
    `set_epoch` before each epoch."""

    def __init__(self, n: int, num_shards: int, shard_id: int, shuffle: bool, seed: int = 0):
        self.n, self.num_shards, self.shard_id = int(n), int(num_shards), int(shard_id)
        self.shuffle, self.seed, self.epoch = bool(shuffle), int(seed), 0

    def set_epoch(self, epoch: int):
        self.epoch = int(epoch)

    def __iter__(self):
        idx = np.arange(self.n)
        if self.shuffle:
            idx = np.random.RandomState(self.seed + self.epoch).permutation(self.n)
        per = len(self)
        shard = list(idx[self.shard_id * per:(self.shard_id + 1) * per])
        if len(shard) < per and len(idx):
            shard += list(idx[:per - len(shard)])
        return iter([int(i) for i in shard])

    def __len__(self):
        return -(-self.n // self.num_shards)

    @property
    def num_real(self) -> int:
        """How many of the shard's indices come before its padding."""
        return max(0, min(len(self), self.n - self.shard_id * len(self)))


def build_dataloader(dataset_cfg, class_names, batch_size, dist=False, root_path=None,
                     workers=4, logger=None, training=True, seed=0, cache_items=False):
    """(dataset, dataloader, sampler) (reference `btcdet/datasets/__init__.py:39`);
    `batch_size` frames a process. A training loader drops the last
    partial batch and shuffles each epoch from (`seed`, epoch): before an
    epoch call `set_epoch`, then make its iterator. `dist=True` gives this
    rank its `ShardSampler` shard of the data-parallel group
    (`parallel.get_dist_info`; one process's shard is the whole, in the
    same order as without it); the sampler is None otherwise.
    `cache_items` memoizes the items (`loader.CachedDataset`: sound only
    without stochastic augmentation; the items take epoch 0's draws)."""
    from ..parallel import get_dist_info
    from .loader import CachedDataset, make_loader

    cls = _registry()[dataset_cfg.DATASET]
    dataset = cls(dataset_cfg, class_names, training=training,
                  root_path=root_path or dataset_cfg.DATA_PATH, logger=logger)
    sampler = None
    if dist:
        rank, world = get_dist_info()
        sampler = ShardSampler(len(dataset), world, rank, shuffle=training, seed=seed)
    dataloader = make_loader(CachedDataset(dataset) if cache_items else dataset, batch_size,
                             shuffle=training and sampler is None, num_workers=workers,
                             collate_fn=dataset.collate_batch, drop_last=training,
                             sampler=sampler, seed=seed)
    return dataset, dataloader, sampler


def set_epoch(dataset, dataloader, epoch: int):
    """Point the dataset's per-frame draws and the loader's shuffle (its
    `EpochShuffle` or `ShardSampler`) at `epoch`; call before making the
    epoch's iterator."""
    dataset._epoch = int(epoch)
    if hasattr(dataloader.sampler, "set_epoch"):
        dataloader.sampler.set_epoch(epoch)
