"""Synthetic on-disk KITTI tree (own copy of
`btcdet_tpu/datasets/synthetic_kitti.py`): velodyne .bin + calib + labels +
planes + ImageSets, with planted objects whose interiors carry dense
points. Drives the evaluation entry point (`tools/test_torch.py`) without
real KITTI data; the same seed writes the same tree as the JAX package's.
"""

from __future__ import annotations

import numpy as np

IMAGE_SHAPE = (375, 1242)  # kitti_infos.py:44 default when image_2/ absent

CALIB_TXT = """P0: 700 0 600 0 0 700 180 0 0 0 1 0
P1: 700 0 600 0 0 700 180 0 0 0 1 0
P2: 700 0 600 44 0 700 180 0.1 0 0 1 0.003
P3: 700 0 600 -330 0 700 180 0.02 0 0 1 0.003
R0_rect: 1 0 0 0 1 0 0 0 1
Tr_velo_to_cam: 0 -1 0 0 0 0 -1 -0.08 1 0 0 -0.27
Tr_imu_to_velo: 1 0 0 0 0 1 0 0 0 0 1 -0.3
"""


_P2 = np.array([[700, 0, 600, 44], [0, 700, 180, 0.1], [0, 0, 1, 0.003]],
               dtype=np.float64)  # must match CALIB_TXT's P2 row


def _project_cam_box(loc_cam, lhw, ry):
    """Project a KITTI camera-frame box (bottom-center origin) to an
    image bbox [x1,y1,x2,y2] with P2, clipped to IMAGE_SHAPE.

    Independent of utils.box_utils on purpose: the fixture's gt bboxes
    must not share code with the prediction projection path
    (kitti_dataset.generate_prediction_dicts), or a projection bug would
    cancel out of the bbox/AOS metric instead of zeroing it."""
    l_, h_, w_ = lhw
    x_c = np.array([1, 1, -1, -1, 1, 1, -1, -1]) * l_ / 2
    y_c = np.array([0, 0, 0, 0, -1, -1, -1, -1]) * h_
    z_c = np.array([1, -1, -1, 1, 1, -1, -1, 1]) * w_ / 2
    c, s = np.cos(ry), np.sin(ry)
    corners = np.stack([c * x_c + s * z_c, y_c, -s * x_c + c * z_c], axis=1)
    corners = corners + np.asarray(loc_cam)[None]
    uvw = corners @ _P2[:, :3].T + _P2[:, 3]
    uv = uvw[:, :2] / uvw[:, 2:3]
    h_img, w_img = IMAGE_SHAPE
    x1, y1 = uv.min(axis=0)
    x2, y2 = uv.max(axis=0)
    return (np.clip(x1, 0, w_img - 1), np.clip(y1, 0, h_img - 1),
            np.clip(x2, 0, w_img - 1), np.clip(y2, 0, h_img - 1))


# per-class planted-object spec: (l, w, h, ground z, base point count)
_CLASS_SPECS = {
    "Car": (3.9, 1.6, 1.56, -1.0, 400),
    "Pedestrian": (0.8, 0.6, 1.73, -1.0, 220),
    "Cyclist": (1.76, 0.6, 1.73, -1.0, 260),
}
# placement clearance radius: half the BEV diagonal + margin, so planted
# boxes never overlap (overlapping gt would be NMS-merged -> recall
# ceiling); Car keeps the historical 2.5 (center distance >= 5 m)
_CLASS_RADIUS = {"Car": 2.5, "Pedestrian": 0.9, "Cyclist": 1.4}


def make_raw_kitti(root, n_frames=4, seed=0, n_train=None, cars_per_frame=2,
                   n_background=4000, x_range=(8, 30), y_range=(-5, 5),
                   hard=False, objects_per_frame=None):
    """Write a raw synthetic KITTI tree under `root`; the last
    `n_frames - n_train` frames form the val split (default: 1).

    hard=True makes frames that a detector must generalize to rather
    than memorize (a saturated metric cannot tell approximations apart): car
    dimensions jitter +-15%, per-car point count falls off with range
    (far cars are sparse), and unlabeled box-shaped clutter blobs add
    false-positive pressure.

    objects_per_frame: optional {class_name: count} mapping for
    multi-class trees (the 3-class overfit proof); default
    {"Car": cars_per_frame}."""
    rng = np.random.RandomState(seed)
    (root / "training" / "velodyne").mkdir(parents=True, exist_ok=True)
    (root / "training" / "calib").mkdir(parents=True, exist_ok=True)
    (root / "training" / "label_2").mkdir(parents=True, exist_ok=True)
    (root / "training" / "planes").mkdir(parents=True, exist_ok=True)
    (root / "ImageSets").mkdir(parents=True, exist_ok=True)
    if n_train is None:
        n_train = n_frames - 1
    if objects_per_frame is None:
        objects_per_frame = {"Car": cars_per_frame}
    frame_objects = [c for c, k in objects_per_frame.items() for _ in range(k)]

    frame_ids = [f"{i:06d}" for i in range(n_frames)]
    for fid in frame_ids:
        # forward-cone points so FOV filtering keeps them
        n = n_background
        pts = np.concatenate([
            rng.uniform([3, -8, -2.5], [40, 8, 0.5], size=(n, 3)),
            rng.rand(n, 1),
        ], axis=1).astype(np.float32)
        labels = []
        placed = []
        for obj_cls in frame_objects:
            # rejection-sample centers with per-class clearance so planted
            # boxes never overlap
            r_new = _CLASS_RADIUS[obj_cls]
            for _try in range(200):
                cx = rng.uniform(*x_range)
                cy = rng.uniform(*y_range)
                if all((cx - px) ** 2 + (cy - py) ** 2 >= (r_new + pr) ** 2
                       for px, py, pr in placed):
                    break
            placed.append((cx, cy, r_new))
            l_, w_, h_, cz, n_base = _CLASS_SPECS[obj_cls]
            if hard:
                l_ *= rng.uniform(0.85, 1.15)
                w_ *= rng.uniform(0.85, 1.15)
                h_ *= rng.uniform(0.85, 1.15)
            yaw = rng.uniform(-np.pi, np.pi)
            # Front/back-ASYMMETRIC interior (dense low "hood" in the
            # front half, sparse full-height "cabin" in the rear): a
            # uniform box fill is 180-degree symmetric, so under random
            # world rotation the heading sign is geometrically
            # unlearnable and the RPN direction classifier plateaus
            # (AOS stalls on a fully memorized overfit set). Real
            # cars are asymmetric; the
            # fixture must be too for AOS to be a meaningful metric.
            n_car = n_base
            if hard:
                # quadratic range falloff like a real scanner
                n_car = int(np.clip(n_base * (14.0 / cx) ** 2, 60, n_base))
            n_front = int(n_car * 0.7)
            front = rng.uniform([0.0, -0.5, -0.5], [0.5, 0.5, 0.0],
                                (n_front, 3))
            rear = rng.uniform([-0.5, -0.5, -0.5], [0.0, 0.5, 0.5],
                               (n_car - n_front, 3))
            local = np.concatenate([front, rear]) * [l_, w_, h_]
            c, s = np.cos(yaw), np.sin(yaw)
            world = np.stack([
                local[:, 0] * c - local[:, 1] * s + cx,
                local[:, 0] * s + local[:, 1] * c + cy,
                local[:, 2] + cz,
            ], axis=1)
            pts = np.concatenate(
                [pts, np.concatenate([world, rng.rand(n_car, 1)], 1).astype(np.float32)]
            )
            # camera-frame label: cam = R*velo + t with rows
            # (0,-1,0),(0,0,-1),(1,0,0) per the calib above
            loc_cam = np.array([-cy, -(cz - h_ / 2) - 0.08, cx - 0.27])
            ry = -yaw - np.pi / 2
            x1, y1, x2, y2 = _project_cam_box(loc_cam, (l_, h_, w_), ry)
            labels.append(
                f"{obj_cls} 0.0 0 {-np.arctan2(-cy, cx) + ry:.2f} "
                f"{x1:.2f} {y1:.2f} {x2:.2f} {y2:.2f} "
                f"{h_} {w_} {l_} {loc_cam[0]:.2f} {loc_cam[1]:.2f} {loc_cam[2]:.2f} {ry:.2f}"
            )
        if hard:
            # unlabeled dense clutter blobs: false-positive pressure so
            # precision (not just recall) discriminates between configs
            for _ in range(3):
                for _try in range(100):
                    qx = rng.uniform(*x_range)
                    qy = rng.uniform(*y_range)
                    if all((qx - px) ** 2 + (qy - py) ** 2 >= (pr + 1.5) ** 2
                           for px, py, pr in placed):
                        break
                dims = rng.uniform([0.8, 0.8, 0.6], [2.5, 1.4, 1.4])
                blob = rng.uniform(-0.5, 0.5, (120, 3)) * dims + [qx, qy, -1.2]
                pts = np.concatenate(
                    [pts, np.concatenate(
                        [blob, rng.rand(120, 1)], 1).astype(np.float32)]
                )
        pts.astype(np.float32).tofile(str(root / "training" / "velodyne" / f"{fid}.bin"))
        (root / "training" / "calib" / f"{fid}.txt").write_text(CALIB_TXT)
        (root / "training" / "label_2" / f"{fid}.txt").write_text("\n".join(labels) + "\n")
        (root / "training" / "planes" / f"{fid}.txt").write_text(
            "# Plane\nWidth 4\nHeight 1\n0 -1 0 1.73\n"
        )
    (root / "ImageSets" / "train.txt").write_text("\n".join(frame_ids[:n_train]) + "\n")
    (root / "ImageSets" / "val.txt").write_text("\n".join(frame_ids[n_train:]) + "\n")
    return frame_ids
