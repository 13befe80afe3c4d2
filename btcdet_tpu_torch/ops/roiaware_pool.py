"""Roi-aware voxel pooling and roi point sampling (counterpart of
`btcdet_tpu/ops/roiaware_pool.py`; reference `roiaware_pool3d` and
`roipoint_pool3d`; no config names them).

  roiaware_pool3d   pool point features into each roi's local voxel grid
                    (max or avg), the PartA2 op
  roipoint_pool3d   sample a fixed number of points in each (enlarged) roi

Both run all rois at once in plain PyTorch, on the device of their inputs.
"""

from __future__ import annotations

import torch

from ..utils import box_utils, common


def _local_points(rois, points):
    """points (P, 3) in each roi's canonical frame: (N, P, 3)."""
    local = points[None, :, :3] - rois[:, None, 0:3]
    return common.rotate_points_along_z(local, -rois[:, 6])


def roiaware_pool3d(rois, points, point_features, points_mask, out_size=(6, 6, 6),
                    pool_method: str = "max"):
    """rois (N, 7), points (P, 3), point_features (P, C), points_mask (P,)
    -> (N, oz, oy, ox, C): each in-box point binned into its roi's local
    grid, the cell floor((local + dims / 2) / (dims / (ox, oy, oz))) clamped
    into the grid. "max": the channel max, 0 for an empty cell; "avg": the
    mean, 0 for an empty cell."""
    if pool_method not in ("max", "avg"):
        raise NotImplementedError(f"pool_method {pool_method!r}")
    oz, oy, ox = (int(v) for v in out_size)
    N, C = rois.shape[0], point_features.shape[-1]
    cells = oz * oy * ox
    local = _local_points(rois, points)                                     # (N, P, 3)
    dims = rois[:, None, 3:6]
    inb = (local.abs() <= dims / 2).all(-1) & points_mask.bool()[None, :]
    size = torch.tensor([ox, oy, oz], dtype=torch.float32, device=rois.device)
    cell = torch.floor((local + dims / 2) / (dims / size)).long()
    cell = torch.minimum(cell.clamp(min=0), torch.tensor([ox - 1, oy - 1, oz - 1],
                                                         device=rois.device))
    lin = (cell[..., 2] * oy + cell[..., 1]) * ox + cell[..., 0]
    lin = torch.where(inb, lin, torch.full_like(lin, cells))
    # one row of cells + 1 (the sink) per roi
    flat = (lin + torch.arange(N, device=rois.device)[:, None] * (cells + 1)).reshape(-1)
    feats = point_features[None].expand(N, -1, -1).reshape(-1, C)
    keep = inb.reshape(-1)
    if pool_method == "max":
        grid = torch.full((N * (cells + 1), C), float("-inf"), dtype=point_features.dtype,
                          device=rois.device)
        src = torch.where(keep[:, None], feats, torch.full_like(feats, float("-inf")))
        grid.scatter_reduce_(0, flat[:, None].expand(-1, C), src, reduce="amax")
        grid = torch.where(torch.isfinite(grid), grid, torch.zeros_like(grid))
    else:
        acc = torch.zeros((N * (cells + 1), C), dtype=point_features.dtype, device=rois.device)
        acc.index_add_(0, flat, torch.where(keep[:, None], feats, torch.zeros_like(feats)))
        cnt = torch.zeros((N * (cells + 1),), dtype=point_features.dtype, device=rois.device)
        cnt.index_add_(0, flat, keep.to(point_features.dtype))
        grid = acc / cnt.clamp(min=1.0)[:, None]
    return grid.reshape(N, cells + 1, C)[:, :-1].reshape(N, oz, oy, ox, C)


def roipoint_pool3d(rois, points, point_features, points_mask, num_sampled_points: int = 512,
                    extra_width=(0.0, 0.0, 0.0)):
    """rois (N, 7) enlarged by `extra_width`; -> (pooled (N, S, 3 + C),
    empty (N,)): the first S in-box points of each roi in point order (a
    stable sort), repeated from the first when fewer (the reference
    sampler's fill); an roi holding no point gives zeros and empty True."""
    enlarged = box_utils.enlarge_box3d(rois, extra_width)
    local = _local_points(enlarged, points)
    inb = (local.abs() <= enlarged[:, None, 3:6] / 2).all(-1) & points_mask.bool()[None, :]
    order = torch.argsort((~inb).to(torch.uint8), dim=1, stable=True)         # in-box first
    cnt = inb.sum(dim=1)
    slot = torch.arange(num_sampled_points, device=rois.device)[None, :] % cnt.clamp(min=1)[:, None]
    take = torch.gather(order, 1, slot)
    pooled = torch.cat([points, point_features], dim=-1)[take]
    pooled = torch.where((cnt > 0)[:, None, None], pooled, torch.zeros_like(pooled))
    return pooled, cnt == 0
