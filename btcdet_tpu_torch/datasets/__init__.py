"""Datasets and data loading (counterpart of `btcdet_tpu/datasets/`)."""

from .synthetic import make_synthetic_batch, make_synthetic_batch_np  # noqa: F401

__all_datasets__ = {}


def _registry():
    if not __all_datasets__:
        from .kitti.kitti_dataset import KittiDataset

        __all_datasets__["KittiDataset"] = KittiDataset
    return __all_datasets__


def build_dataloader(dataset_cfg, class_names, batch_size, root_path=None, workers=4,
                     logger=None, training=True, seed=0):
    """(dataset, dataloader, sampler) on one process (reference
    `btcdet/datasets/__init__.py:39`). A training loader drops the last
    partial batch and shuffles each epoch from (`seed`, epoch): before an
    epoch, set `dataset._epoch` and call `dataloader.sampler.set_epoch`
    (`set_epoch` below), then make its iterator. The distributed sampler
    (None here) comes with the multi-GPU path."""
    from .loader import make_loader

    cls = _registry()[dataset_cfg.DATASET]
    dataset = cls(dataset_cfg, class_names, training=training,
                  root_path=root_path or dataset_cfg.DATA_PATH, logger=logger)
    dataloader = make_loader(dataset, batch_size, shuffle=training, num_workers=workers,
                             collate_fn=dataset.collate_batch, drop_last=training, seed=seed)
    return dataset, dataloader, None


def set_epoch(dataset, dataloader, epoch: int):
    """Point the dataset's per-frame draws and the loader's shuffle at
    `epoch`; call before making the epoch's iterator."""
    dataset._epoch = int(epoch)
    if hasattr(dataloader.sampler, "set_epoch"):
        dataloader.sampler.set_epoch(epoch)
