"""Offline KITTI info and gt-database generation (counterpart of
`btcdet_tpu/datasets/kitti/kitti_infos.py`, reference
`btcdet/datasets/kitti/kitti_dataset.py:129-317,463-533`).

  create_kitti_infos      kitti_infos_{train,val,test,trainval}.pkl with
                          calib matrices, annotations, gt_boxes_lidar and
                          num_points_in_gt, then the train gt database
  create_groundtruth_database
                          per-object point .bin files + the dbinfos pkl
                          the gt-sampling augmentor reads

Run:  python -m btcdet_tpu_torch.datasets.kitti.kitti_infos <data_path>
"""

from __future__ import annotations

import pickle
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from ...utils import box_utils
from . import calibration, object3d


def _pad_mat(m):
    out = np.eye(4, dtype=np.float32)
    out[:3, : m.shape[1]] = m
    return out


def get_info(root_split_path, sample_idx, count_inside_pts=True, has_label=True):
    info = {"point_cloud": {"num_features": 4, "lidar_idx": sample_idx}}

    img_file = root_split_path / "image_2" / f"{sample_idx}.png"
    if img_file.exists():
        import struct

        with open(img_file, "rb") as f:
            head = f.read(32)
        w, h = struct.unpack(">II", head[16:24])
        image_shape = np.array([h, w], dtype=np.int32)
    else:
        image_shape = np.array([375, 1242], dtype=np.int32)
    info["image"] = {"image_idx": sample_idx, "image_shape": image_shape}

    calib_file = root_split_path / "calib" / f"{sample_idx}.txt"
    calib = calibration.Calibration(str(calib_file))
    info["calib"] = {
        "P2": _pad_mat(calib.P2),
        "R0_rect": _pad_mat(calib.R0[:, :3] if calib.R0.shape == (3, 3) else calib.R0),
        "Tr_velo_to_cam": _pad_mat(calib.V2C),
    }

    if has_label:
        obj_list = object3d.get_objects_from_label(
            str(root_split_path / "label_2" / f"{sample_idx}.txt")
        )
        annos = {
            "name": np.array([o.cls_type for o in obj_list]),
            "truncated": np.array([o.truncation for o in obj_list]),
            "occluded": np.array([o.occlusion for o in obj_list]),
            "alpha": np.array([o.alpha for o in obj_list]),
            "bbox": np.array([o.box2d for o in obj_list]).reshape(-1, 4),
            "dimensions": np.array([[o.l, o.h, o.w] for o in obj_list]).reshape(-1, 3),
            "location": np.array([o.loc for o in obj_list]).reshape(-1, 3),
            "rotation_y": np.array([o.ry for o in obj_list]),
            "score": np.array([o.score for o in obj_list]),
            "difficulty": np.array([o.level for o in obj_list], np.int32),
        }
        num_objects = sum(1 for o in obj_list if o.cls_type != "DontCare")
        annos["index"] = np.concatenate(
            [np.arange(num_objects), -np.ones(len(obj_list) - num_objects)]
        ).astype(np.int32)

        loc = annos["location"][:num_objects]
        dims = annos["dimensions"][:num_objects]
        rots = annos["rotation_y"][:num_objects]
        loc_lidar = calib.rect_to_lidar(loc)
        l, h, w = dims[:, 0:1], dims[:, 1:2], dims[:, 2:3]
        loc_lidar[:, 2] += h[:, 0] / 2
        gt_boxes_lidar = np.concatenate(
            [loc_lidar, l, w, h, -(np.pi / 2 + rots[..., None])], axis=1
        )
        annos["gt_boxes_lidar"] = gt_boxes_lidar

        if count_inside_pts:
            points = np.fromfile(
                str(root_split_path / "velodyne" / f"{sample_idx}.bin"), dtype=np.float32
            ).reshape(-1, 4)
            pts_rect = calib.lidar_to_rect(points[:, 0:3])
            from .kitti_dataset import KittiDataset

            fov_flag = KittiDataset.get_fov_flag(pts_rect, image_shape, calib)
            pts_fov = points[fov_flag]
            if len(gt_boxes_lidar):
                inb = box_utils.points_in_boxes_mask_np(pts_fov[:, :3], gt_boxes_lidar)
                num_pts = inb.sum(axis=0)
            else:
                num_pts = np.zeros(0)
            annos["num_points_in_gt"] = np.concatenate(
                [num_pts, -np.ones(len(obj_list) - num_objects)]
            ).astype(np.int32)
        info["annos"] = annos
    return info


def get_infos(root_path, split, sample_id_list, count_inside_pts=True, has_label=True, workers=4):
    root_split = Path(root_path) / ("training" if split != "test" else "testing")
    with ThreadPoolExecutor(workers) as ex:
        infos = list(ex.map(
            lambda idx: get_info(root_split, idx, count_inside_pts, has_label),
            sample_id_list,
        ))
    return infos


def create_groundtruth_database(
    root_path, info_path, used_classes=None, split="train"
):
    root_path = Path(root_path)
    db_save_path = root_path / f"gt_database" if split == "train" else root_path / f"gt_database_{split}"
    db_info_save_path = root_path / f"kitti_dbinfos_{split}.pkl"
    db_save_path.mkdir(parents=True, exist_ok=True)
    with open(info_path, "rb") as f:
        infos = pickle.load(f)
    all_db_infos = {}
    for k, info in enumerate(infos):
        sample_idx = info["point_cloud"]["lidar_idx"]
        points = np.fromfile(
            str(root_path / "training" / "velodyne" / f"{sample_idx}.bin"),
            dtype=np.float32,
        ).reshape(-1, 4)
        annos = info["annos"]
        names = annos["name"]
        difficulty = annos["difficulty"]
        gt_boxes = annos["gt_boxes_lidar"]
        num_obj = len(gt_boxes)
        if num_obj == 0:
            continue
        inb = box_utils.points_in_boxes_mask_np(points[:, :3], gt_boxes)
        for i in range(num_obj):
            filename = f"{sample_idx}_{names[i]}_{i}.bin"
            filepath = db_save_path / filename
            gt_points = points[inb[:, i]].copy()
            gt_points[:, :3] -= gt_boxes[i, :3]
            gt_points.astype(np.float32).tofile(str(filepath))
            if used_classes is None or names[i] in used_classes:
                db_info = {
                    "name": names[i],
                    "path": str(filepath.relative_to(root_path)),
                    "image_idx": sample_idx,
                    "gt_idx": i,
                    "box3d_lidar": gt_boxes[i],
                    "num_points_in_gt": int(inb[:, i].sum()),
                    "difficulty": int(difficulty[i]),
                    "bbox": annos["bbox"][i],
                    "score": annos["score"][i],
                }
                all_db_infos.setdefault(names[i], []).append(db_info)
    with open(db_info_save_path, "wb") as f:
        pickle.dump(all_db_infos, f)
    return all_db_infos


def create_kitti_infos(data_path, save_path=None, workers=4):
    """reference `kitti_dataset.py:463`."""
    data_path = Path(data_path)
    save_path = Path(save_path or data_path)
    splits = {}
    for split in ("train", "val", "test"):
        split_file = data_path / "ImageSets" / f"{split}.txt"
        if split_file.exists():
            splits[split] = [x.strip() for x in open(split_file).readlines()]
    for split, ids in splits.items():
        has_label = split != "test"
        infos = get_infos(data_path, split, ids, has_label=has_label, workers=workers)
        out = save_path / f"kitti_infos_{split}.pkl"
        with open(out, "wb") as f:
            pickle.dump(infos, f)
        print(f"kitti infos {split}: {len(infos)} -> {out}")
    if "train" in splits and "val" in splits:
        both = []
        for split in ("train", "val"):
            with open(save_path / f"kitti_infos_{split}.pkl", "rb") as f:
                both.extend(pickle.load(f))
        with open(save_path / "kitti_infos_trainval.pkl", "wb") as f:
            pickle.dump(both, f)
    if "train" in splits:
        create_groundtruth_database(
            data_path, save_path / "kitti_infos_train.pkl", split="train"
        )


if __name__ == "__main__":
    import sys

    create_kitti_infos(sys.argv[1], workers=int(sys.argv[2]) if len(sys.argv) > 2 else 4)
