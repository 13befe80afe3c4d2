"""Trilinear pool of the reference: the plain PyTorch version of the
port's sampler kernel K4, frozen with the benchmark. Every entry point runs the plain version on any device."""

from __future__ import annotations

import torch

from ..utils.common import trilinear_interpolate_dense

def trilinear_pool_plain(volume, zyx, roi_b, valid):
    """8-corner gathers (`common.trilinear_interpolate_dense`) frame by
    frame, f32 accumulate, rounded once to the volume's dtype; rois of no
    frame in [0, B) come out 0."""
    B, C = volume.shape[0], volume.shape[-1]
    R, S, _ = zyx.shape
    out = torch.zeros((R, S, C), dtype=torch.float32, device=volume.device)
    for b in range(B):
        sel = roi_b == b
        pts = zyx[sel].reshape(-1, 3)
        out[sel] = trilinear_interpolate_dense(volume[b], pts).reshape(-1, S, C)
    out = torch.where(valid[..., None], out, torch.zeros((), device=out.device))
    return out.to(volume.dtype)





def trilinear_pool(volume, zyx, roi_b, valid):
    """(R, S, C) trilinear samples in the volume's dtype: `trilinear_pool_plain`."""
    return trilinear_pool_plain(volume, zyx, roi_b, valid)
