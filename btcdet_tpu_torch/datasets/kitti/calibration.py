"""KITTI calibration (counterpart of `btcdet_tpu/datasets/kitti/calibration.py`,
reference `btcdet/utils/calibration_kitti.py`).

A KITTI calib file holds P2 (3x4 camera projection), R0_rect (3x3) and
Tr_velo_to_cam (3x4); `Calibration` maps lidar <-> rectified camera <->
image coordinates, in float32 like the files' values.
"""

from __future__ import annotations

import numpy as np


def get_calib_from_file(calib_file):
    with open(calib_file) as f:
        lines = f.readlines()
    obj = {}
    for line in lines:
        line = line.strip()
        if not line:
            continue
        key, val = line.split(":", 1)
        obj[key.strip()] = np.array([float(x) for x in val.split()], dtype=np.float32)
    return {
        "P2": obj["P2"].reshape(3, 4),
        "P3": obj.get("P3", obj["P2"]).reshape(3, 4),
        "R0": obj["R0_rect"].reshape(3, 3),
        "Tr_velo2cam": obj["Tr_velo_to_cam"].reshape(3, 4),
    }


class Calibration:
    """From a calib file path, or a dict with P2, R0 and Tr_velo2cam."""

    def __init__(self, calib_file):
        calib = get_calib_from_file(calib_file) if isinstance(calib_file, str) else calib_file
        self.P2 = calib["P2"]
        self.R0 = calib["R0"]
        self.V2C = calib["Tr_velo2cam"]
        self.cu = self.P2[0, 2]
        self.cv = self.P2[1, 2]
        self.fu = self.P2[0, 0]
        self.fv = self.P2[1, 1]
        self.tx = self.P2[0, 3] / (-self.fu)
        self.ty = self.P2[1, 3] / (-self.fv)

    @staticmethod
    def _hom(pts):
        return np.hstack((pts, np.ones((pts.shape[0], 1), dtype=np.float32)))

    def lidar_to_rect(self, pts_lidar):
        return (self._hom(pts_lidar) @ self.V2C.T) @ self.R0.T

    def rect_to_lidar(self, pts_rect):
        R0_ext = np.eye(4, dtype=np.float32)
        R0_ext[:3, :3] = self.R0
        V2C_ext = np.eye(4, dtype=np.float32)
        V2C_ext[:3, :] = self.V2C
        inv = np.linalg.inv(R0_ext @ V2C_ext)
        return (self._hom(pts_rect) @ inv.T)[:, :3]

    def rect_to_img(self, pts_rect):
        """-> (image points (N, 2), depth in the rectified camera (N,))."""
        pts_hom = self._hom(pts_rect) @ self.P2.T
        depth = pts_hom[:, 2]
        pts_img = pts_hom[:, :2] / np.clip(depth[:, None], 1e-6, None)
        return pts_img, depth - self.P2.T[3, 2]

    def lidar_to_img(self, pts_lidar):
        return self.rect_to_img(self.lidar_to_rect(pts_lidar))

    def img_to_rect(self, u, v, depth_rect):
        x = ((u - self.cu) * depth_rect) / self.fu + self.tx
        y = ((v - self.cv) * depth_rect) / self.fv + self.ty
        return np.stack([x, y, depth_rect], axis=1)

    def corners3d_to_img_boxes(self, corners3d):
        """(N, 8, 3) rectified corners -> (image boxes (N, 4), corners (N, 8, 2))."""
        n = corners3d.shape[0]
        pts = self._hom(corners3d.reshape(-1, 3)).reshape(n, 8, 4)
        img_pts = pts @ self.P2.T
        xy = img_pts[:, :, :2] / img_pts[:, :, 2:3]
        x1, y1 = xy[:, :, 0].min(1), xy[:, :, 1].min(1)
        x2, y2 = xy[:, :, 0].max(1), xy[:, :, 1].max(1)
        return np.stack([x1, y1, x2, y2], axis=1), xy
