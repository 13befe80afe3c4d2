"""3D box utilities (lidar frame; box = x, y, z, dx, dy, dz, heading).
Counterpart of the parts of `btcdet_tpu/utils/box_utils.py` the eval and
train paths use."""

from __future__ import annotations

import numpy as np
import torch

from . import common

# unit-box corners: 4 bottom then 4 top (reference corner order)
_CORNER_TEMPLATE = np.array([
    [1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1],
    [1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1],
], dtype=np.float32) / 2.0


def boxes_to_corners_3d(boxes: torch.Tensor) -> torch.Tensor:
    """(N, 7) -> (N, 8, 3) corners."""
    template = torch.from_numpy(_CORNER_TEMPLATE).to(boxes.device, boxes.dtype)
    corners = boxes[:, None, 3:6] * template[None]
    return common.rotate_points_along_z(corners, boxes[:, 6]) + boxes[:, None, 0:3]


def boxes3d_lidar_to_aligned_bev_boxes(boxes: torch.Tensor) -> torch.Tensor:
    """Rotated boxes snapped to axis-aligned BEV rectangles (x1, y1, x2, y2)
    by rotation quadrant (reference `box_utils.py:299-310`)."""
    rot = common.limit_period(boxes[:, 6], offset=0.5, period=np.pi).abs()
    swap = rot[:, None] >= (np.pi / 4)
    dims = torch.where(swap, boxes[:, [4, 3]], boxes[:, [3, 4]])
    return torch.cat([boxes[:, 0:2] - dims / 2, boxes[:, 0:2] + dims / 2], dim=1)


def boxes_iou_normal(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Axis-aligned IoU of (N, 4) x (M, 4) rectangles -> (N, M)."""
    x_len = (torch.minimum(a[:, None, 2], b[None, :, 2])
             - torch.maximum(a[:, None, 0], b[None, :, 0])).clamp(min=0)
    y_len = (torch.minimum(a[:, None, 3], b[None, :, 3])
             - torch.maximum(a[:, None, 1], b[None, :, 1])).clamp(min=0)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    inter = x_len * y_len
    return inter / (area_a[:, None] + area_b[None, :] - inter).clamp(min=1e-6)


def boxes3d_nearest_bev_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """RPN matching IoU with MATCH_HEIGHT False (reference `box_utils.py:313-325`)."""
    return boxes_iou_normal(boxes3d_lidar_to_aligned_bev_boxes(boxes_a),
                            boxes3d_lidar_to_aligned_bev_boxes(boxes_b))


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
