"""Voxel feature encoders (counterpart of `btcdet_tpu/models/vfe.py`):
parameter-free reductions over a voxel table's point slots, voxels (N, P,
C) with voxel_num_points (N,)."""

from __future__ import annotations

import torch


def _slot_mask(voxels, voxel_num_points):
    slots = torch.arange(voxels.shape[1], device=voxels.device)
    return slots[None, :] < voxel_num_points[:, None]


class MeanVFE:
    """Reference `mean_vfe.py`, plain mode: per-voxel mean of the point
    features over the filled slots. No parameters."""

    def __call__(self, voxels: torch.Tensor, voxel_num_points: torch.Tensor) -> torch.Tensor:
        mask = _slot_mask(voxels, voxel_num_points)
        normalizer = voxel_num_points[:, None].to(voxels.dtype).clamp(min=1.0)
        vm = torch.where(mask[..., None], voxels, torch.zeros_like(voxels))
        return vm.sum(dim=1) / normalizer


class OccVFE:
    """Reference `occ_vfe.py` over the merged det table: a point whose last
    channel (the occupancy probability) is >= 0.05 is an occ point, the
    others raw points. A voxel's first `num_raw_features` channels are the
    mean of its raw points, or of its occ points where it holds no raw
    point; the trailing occ-code channels are their max over the voxel's
    points (0 for an empty voxel)."""

    def __init__(self, num_raw_features: int = 4):
        self.num_raw_features = num_raw_features

    def __call__(self, voxels, voxel_num_points):
        """-> (voxel features (N, num_raw + n_code), occ code (N, n_code))."""
        mask = _slot_mask(voxels, voxel_num_points)
        raw_mask = (voxels[:, :, -1] < 0.05) & mask
        occ_mask = (voxels[:, :, -1] >= 0.05) & mask
        raw_n = raw_mask.sum(1, keepdim=True)
        occ_n = occ_mask.sum(1, keepdim=True)
        occ_only = (occ_n > 0) & (raw_n < 1)
        nrf = self.num_raw_features
        zero = torch.zeros((), dtype=voxels.dtype, device=voxels.device)
        head = voxels[:, :, :nrf]
        f_raw = torch.where(raw_mask[..., None], head, zero).sum(1) / raw_n.to(
            voxels.dtype).clamp(min=1.0)
        f_occ = torch.where(occ_mask[..., None], head, zero).sum(1) / occ_n.to(
            voxels.dtype).clamp(min=1.0)
        feat = f_raw + occ_only.to(voxels.dtype) * f_occ
        occ_max = torch.where(mask[..., None], voxels[:, :, nrf:],
                              torch.full((), float("-inf"), device=voxels.device)).amax(dim=1)
        occ_max = torch.where(torch.isfinite(occ_max), occ_max, zero)
        return torch.cat([feat, occ_max], dim=-1), occ_max
