"""3D box utilities (lidar frame; box = x, y, z, dx, dy, dz, heading).
Counterpart of the parts of `btcdet_tpu/utils/box_utils.py` the eval path
uses."""

from __future__ import annotations

import torch


def boxes_to_corners_bev(boxes: torch.Tensor) -> torch.Tensor:
    """(N, 7) -> (N, 4, 2) BEV corners, counter-clockwise in the lidar
    frame: local (+,+), (+,-), (-,-), (-,+)."""
    half_dx = boxes[:, 3] / 2.0
    half_dy = boxes[:, 4] / 2.0
    lx = torch.stack([half_dx, half_dx, -half_dx, -half_dx], dim=1)
    ly = torch.stack([half_dy, -half_dy, -half_dy, half_dy], dim=1)
    c, s = torch.cos(boxes[:, 6])[:, None], torch.sin(boxes[:, 6])[:, None]
    gx = lx * c - ly * s + boxes[:, 0:1]
    gy = lx * s + ly * c + boxes[:, 1:2]
    return torch.stack([gx, gy], dim=-1)


def points_in_boxes_mask(points: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """points (..., N, 3), boxes (..., M, 7) -> bool (..., N, M): inside when
    the box-frame coordinates lie within the half dims (z from the box
    center, like the reference's `points_in_boxes` kernel)."""
    shift = points[..., :, None, :3] - boxes[..., None, :, 0:3]        # (..., N, M, 3)
    c, s = torch.cos(-boxes[..., 6]), torch.sin(-boxes[..., 6])
    c, s = c[..., None, :], s[..., None, :]
    local_x = shift[..., 0] * c - shift[..., 1] * s
    local_y = shift[..., 0] * s + shift[..., 1] * c
    half = boxes[..., None, :, 3:6] / 2
    return ((local_x.abs() <= half[..., 0]) & (local_y.abs() <= half[..., 1])
            & (shift[..., 2].abs() <= half[..., 2]))
