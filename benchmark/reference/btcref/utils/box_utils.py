"""3D box utilities (lidar frame; box = x, y, z, dx, dy, dz, heading).
Counterpart of the parts of `btcdet_tpu/utils/box_utils.py` the eval path
uses."""

from __future__ import annotations

import numpy as np
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


# ------------------------------------------------------ numpy host helpers
# The host data pipeline's twins of the functions above, and the KITTI
# camera <-> lidar conversions; numpy in the input's dtype, the JAX
# package's host arithmetic.


def boxes_to_corners_bev_np(boxes: np.ndarray) -> np.ndarray:
    """`boxes_to_corners_bev` in numpy, in the input's dtype."""
    half_dx = boxes[:, 3] / 2.0
    half_dy = boxes[:, 4] / 2.0
    lx = np.stack([half_dx, half_dx, -half_dx, -half_dx], axis=1)
    ly = np.stack([half_dy, -half_dy, -half_dy, half_dy], axis=1)
    c, s = np.cos(boxes[:, 6])[:, None], np.sin(boxes[:, 6])[:, None]
    gx = lx * c - ly * s + boxes[:, 0:1]
    gy = lx * s + ly * c + boxes[:, 1:2]
    return np.stack([gx, gy], axis=-1)


def boxes3d_lidar_to_kitti_camera(boxes3d_lidar, calib) -> np.ndarray:
    """(N, 7) lidar [x, y, z, dx, dy, dz, heading] -> camera [x, y, z, l, h,
    w, ry]: the camera box's origin is its bottom center, ry = -heading -
    pi / 2 (reference `box_utils.boxes3d_lidar_to_kitti_camera`)."""
    boxes3d_lidar = np.asarray(boxes3d_lidar).copy()
    xyz_lidar = boxes3d_lidar[:, 0:3].copy()
    dx, dy, dz = boxes3d_lidar[:, 3:4], boxes3d_lidar[:, 4:5], boxes3d_lidar[:, 5:6]
    heading = boxes3d_lidar[:, 6:7]
    xyz_lidar[:, 2] -= dz.reshape(-1) / 2
    xyz_cam = calib.lidar_to_rect(xyz_lidar)
    ry = -heading - np.pi / 2
    return np.concatenate([xyz_cam, dx, dz, dy, ry], axis=1)


def boxes3d_kitti_camera_to_imageboxes(boxes3d, calib, image_shape=None) -> np.ndarray:
    """Camera boxes -> 2D image boxes [x1, y1, x2, y2] spanning the 8
    projected corners, clipped to `image_shape` (H, W) when given
    (reference `box_utils.boxes3d_kitti_camera_to_imageboxes`)."""
    boxes3d = np.asarray(boxes3d)
    pts_img, _ = calib.rect_to_img(_camera_box_corners(boxes3d).reshape(-1, 3))
    corners_img = pts_img.reshape(-1, 8, 2)
    boxes2d = np.concatenate([corners_img.min(axis=1), corners_img.max(axis=1)], axis=1)
    if image_shape is not None:
        boxes2d[:, 0] = np.clip(boxes2d[:, 0], 0, image_shape[1] - 1)
        boxes2d[:, 1] = np.clip(boxes2d[:, 1], 0, image_shape[0] - 1)
        boxes2d[:, 2] = np.clip(boxes2d[:, 2], 0, image_shape[1] - 1)
        boxes2d[:, 3] = np.clip(boxes2d[:, 3], 0, image_shape[0] - 1)
    return boxes2d


def _camera_box_corners(boxes3d: np.ndarray) -> np.ndarray:
    """KITTI camera-frame boxes (x, y, z, l, h, w, ry), origin at the bottom
    center -> (N, 8, 3) corners."""
    l, h, w = boxes3d[:, 3], boxes3d[:, 4], boxes3d[:, 5]
    x_c = np.array([1, 1, -1, -1, 1, 1, -1, -1], dtype=np.float32)
    y_c = np.array([0, 0, 0, 0, -1, -1, -1, -1], dtype=np.float32)
    z_c = np.array([1, -1, -1, 1, 1, -1, -1, 1], dtype=np.float32)
    corners = np.stack([l[:, None] / 2 * x_c[None], h[:, None] * y_c[None],
                        w[:, None] / 2 * z_c[None]], axis=-1)
    ry = boxes3d[:, 6]
    c, s = np.cos(ry), np.sin(ry)
    zero, one = np.zeros_like(c), np.ones_like(c)
    rot = np.stack([c, zero, s, zero, one, zero, -s, zero, c], axis=-1).reshape(-1, 3, 3)
    return np.matmul(corners, rot.transpose(0, 2, 1)) + boxes3d[:, None, 0:3]
