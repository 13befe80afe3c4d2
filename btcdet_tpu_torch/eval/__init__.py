"""Evaluation metrics (counterpart of `btcdet_tpu/eval/`)."""
