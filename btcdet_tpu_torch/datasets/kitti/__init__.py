"""KITTI readers, infos and dataset (counterpart of `btcdet_tpu/datasets/kitti/`)."""
