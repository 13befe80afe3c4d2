"""Chamfer distance (counterpart of `btcdet_tpu/ops/chamfer.py`; reference
`chamfer_distance` CUDA extension, used by the offline best-match
pipeline), in plain PyTorch on the device of its inputs."""

from __future__ import annotations

import torch


def chamfer_distance(xyz1, xyz2, mask1=None, mask2=None):
    """xyz1 (B, N, 3), xyz2 (B, M, 3) -> (dist1 (B, N), dist2 (B, M)): the
    squared distance from each point to the nearest point of the other
    cloud, from |a|^2 + |b|^2 - 2 a.b clamped at 0 (the JAX package's
    formula, not `torch.cdist`). Masked points give inf and are never
    nearest."""
    if mask1 is None:
        mask1 = torch.ones(xyz1.shape[:2], dtype=torch.bool, device=xyz1.device)
    if mask2 is None:
        mask2 = torch.ones(xyz2.shape[:2], dtype=torch.bool, device=xyz2.device)
    sq1 = (xyz1 * xyz1).sum(-1)
    sq2 = (xyz2 * xyz2).sum(-1)
    cross = torch.einsum("bnc,bmc->bnm", xyz1, xyz2)
    d = (sq1[:, :, None] + sq2[:, None, :] - 2 * cross).clamp(min=0.0)
    big = torch.full((), float("inf"), dtype=d.dtype, device=d.device)
    d1 = torch.where(mask2[:, None, :], d, big).amin(dim=2)
    d2 = torch.where(mask1[:, :, None], d, big).amin(dim=1)
    return torch.where(mask1, d1, big), torch.where(mask2, d2, big)
