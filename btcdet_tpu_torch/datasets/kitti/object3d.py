"""KITTI label-file parsing (counterpart of
`btcdet_tpu/datasets/kitti/object3d.py`, reference `btcdet/utils/object3d_kitti.py`)."""

from __future__ import annotations

import numpy as np


def cls_type_to_id(cls_type: str) -> int:
    return {"Car": 1, "Pedestrian": 2, "Cyclist": 3, "Van": 4}.get(cls_type, -1)


class Object3d:
    """One label line: class, truncation, occlusion, alpha, 2D box, h w l,
    location (camera frame, bottom center), ry[, score]."""

    def __init__(self, line: str):
        label = line.strip().split(" ")
        self.src = line
        self.cls_type = label[0]
        self.cls_id = cls_type_to_id(self.cls_type)
        self.truncation = float(label[1])
        self.occlusion = float(label[2])  # 0..3 visibility buckets
        self.alpha = float(label[3])
        self.box2d = np.array([float(label[4]), float(label[5]), float(label[6]),
                               float(label[7])], dtype=np.float32)
        self.h = float(label[8])
        self.w = float(label[9])
        self.l = float(label[10])
        self.loc = np.array([float(label[11]), float(label[12]), float(label[13])],
                            dtype=np.float32)
        self.dis_to_cam = np.linalg.norm(self.loc)
        self.ry = float(label[14])
        self.score = float(label[15]) if len(label) == 16 else -1.0
        self.level_str = None
        self.level = self.get_kitti_obj_level()

    def get_kitti_obj_level(self) -> int:
        """0 / 1 / 2 for easy / moderate / hard, -1 for none of them."""
        height = self.box2d[3] - self.box2d[1]
        if height >= 40 and self.truncation <= 0.15 and self.occlusion <= 0:
            self.level_str = "Easy"
            return 0
        if height >= 25 and self.truncation <= 0.3 and self.occlusion <= 1:
            self.level_str = "Moderate"
            return 1
        if height >= 25 and self.truncation <= 0.5 and self.occlusion <= 2:
            self.level_str = "Hard"
            return 2
        self.level_str = "UnKnown"
        return -1

    def generate_corners3d(self):
        """(8, 3) corners in the camera frame."""
        l, h, w = self.l, self.h, self.w
        x_c = [l / 2, l / 2, -l / 2, -l / 2, l / 2, l / 2, -l / 2, -l / 2]
        y_c = [0, 0, 0, 0, -h, -h, -h, -h]
        z_c = [w / 2, -w / 2, -w / 2, w / 2, w / 2, -w / 2, -w / 2, w / 2]
        R = np.array([[np.cos(self.ry), 0, np.sin(self.ry)], [0, 1, 0],
                      [-np.sin(self.ry), 0, np.cos(self.ry)]])
        return (R @ np.vstack([x_c, y_c, z_c])).T + self.loc

    def to_str(self):
        return (f"{self.cls_type} {self.truncation:.2f} {int(self.occlusion)} "
                f"{self.alpha:.2f} box2d: {self.box2d} hwl: [{self.h} {self.w} {self.l}] "
                f"pos: {self.loc} ry: {self.ry:.2f}")


def get_objects_from_label(label_file):
    with open(label_file) as f:
        lines = f.readlines()
    return [Object3d(line) for line in lines if line.strip()]
