"""Offline KITTI info and gt-database generation (counterpart of
`btcdet_tpu/datasets/kitti/kitti_infos.py`, reference
`btcdet/datasets/kitti/kitti_dataset.py:129-317,463-533`).

  create_kitti_infos      kitti_infos_{train,val,test,trainval}.pkl with
                          calib matrices, annotations, gt_boxes_lidar and
                          num_points_in_gt, then the train gt database
  create_groundtruth_database
                          per-object point .bin files + the dbinfos pkl
                          the gt-sampling augmentor reads
  create_kitti_infos_with_coverage
                          kitti_cvrg_infos_{train,val}.pkl: the infos with
                          each gt's best-match coverage rate (needs the
                          best-match database, `datasets/bestmatch.py`)

Run:  python -m btcdet_tpu_torch.datasets.kitti.kitti_infos <data_path>
      python -m btcdet_tpu_torch.datasets.bestmatch <data_path>
      python -m btcdet_tpu_torch.datasets.kitti.kitti_infos <data_path> --coverage
"""

from __future__ import annotations

import pickle
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from ...utils import box_utils, common, coords
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


_SPHERE_RES = np.asarray([[0.32, 0.5184, 0.4203125]])


def _unique_sphere_occupancy(points, nx=None, ny=None, nz=None, coords_min=None):
    """Count occupied coarse sphere-grid voxels of a cloud (reference
    `kitti_dataset.py:208-225` get_coords). With nx/ny/nz None the grid is
    sized to the cloud (+10 cell margin); otherwise points outside the
    given grid are dropped before counting."""
    if len(points) == 0:
        return np.zeros(3), 0, 0, 0, 0
    sph = np.asarray(coords.absxyz_to_sphere(points[:, :3]))
    if coords_min is None:
        coords_min = np.minimum(sph.min(axis=0), np.zeros(3)).reshape(1, 3)
    c = np.floor_divide(sph - coords_min, _SPHERE_RES).astype(np.int32)
    if nx is None:
        nx, ny, nz = (int(v) + 11 for v in c.max(axis=0))
    else:
        keep = np.all(c >= 0, axis=-1) & np.all(
            c < np.array([[nx, ny, nz]]), axis=-1)
        c = c[keep]
    return coords_min, nx, ny, nz, len(np.unique(c, axis=0))


def compute_coverage_rates(infos, mlt_bm_root, gt_db_root, workers=4):
    """Per-gt shape coverage = (object's occupied sphere voxels) /
    (best-match shape's occupied sphere voxels), written into
    `info['annos']['coverage_rates']` (reference
    `create_info_file_with_coverage` `kitti_dataset.py:204-266`). Feeds
    the coverage-bucket difficulty axis of the eval
    (`kitti_eval.get_official_eval_result(coverage_rates=...)`)."""
    mlt_bm_root = {k: Path(v) for k, v in mlt_bm_root.items()}
    gt_db_root = Path(gt_db_root)

    def one(info):
        image_idx = info["point_cloud"]["lidar_idx"]
        annos = info["annos"]
        rates = []
        for i, name in enumerate(annos["name"]):
            if name not in mlt_bm_root:
                rates.append(0.0)
                continue
            gt_box = annos["gt_boxes_lidar"][i]
            bm_path = mlt_bm_root[name] / f"{int(image_idx)}_{i}.pkl"
            db_path = gt_db_root / f"{image_idx}_{name}_{i}.bin"
            with open(bm_path, "rb") as f:
                bm = pickle.load(f)
            bm = np.asarray(bm).reshape(-1, 3)[:, :3].astype(np.float32)
            obj = np.fromfile(str(db_path), dtype=np.float32).reshape(-1, 4)[:, :3]
            obj = obj + gt_box[:3].reshape(1, 3)
            bm = common.rotate_points_along_z_np(bm[None], np.asarray([gt_box[6]]))[0]
            bm = bm + gt_box[:3].reshape(1, 3)
            cmin, nx, ny, nz, n_bm = _unique_sphere_occupancy(bm)
            _, _, _, _, n_obj = _unique_sphere_occupancy(
                obj, nx=nx, ny=ny, nz=nz, coords_min=cmin)
            rates.append(n_obj / max(1, n_bm))
        if len(rates) == 0:
            annos["coverage_rates"] = np.zeros([0, 1], dtype=np.float32)
        elif len(rates) == 1:
            annos["coverage_rates"] = np.asarray(rates[0]).reshape(-1, 1)
        else:
            annos["coverage_rates"] = np.stack(rates, axis=0)
        return info

    with ThreadPoolExecutor(workers) as ex:
        return list(ex.map(one, infos))


def create_kitti_infos_with_coverage(data_path, save_path=None, workers=4,
                                     mlt_bm_root=None):
    """reference `kitti_dataset.py:505-533`: re-emit train/val infos with
    per-gt best-match coverage rates as kitti_cvrg_infos_{split}.pkl."""
    data_path = Path(data_path)
    save_path = Path(save_path or data_path)
    if mlt_bm_root is None:
        mlt_bm_root = {
            "Car": save_path / "bm_50maxdist_2num_car",
            "Cyclist": save_path / "bm_5maxdist_1num_Cyclist",
            "Pedestrian": save_path / "bm_5maxdist_1num_Pedestrian",
        }
    for split, db in (("train", "gt_database"), ("val", "gt_database_val")):
        info_path = data_path / f"kitti_infos_{split}.pkl"
        if not info_path.exists():
            continue
        with open(info_path, "rb") as f:
            infos = pickle.load(f)
        covered = compute_coverage_rates(
            infos, mlt_bm_root, data_path / db, workers=workers)
        out = save_path / f"kitti_cvrg_infos_{split}.pkl"
        with open(out, "wb") as f:
            pickle.dump(covered, f)
        print(f"kitti coverage infos {split}: {len(covered)} -> {out}")


if __name__ == "__main__":
    import sys

    args = [a for a in sys.argv[1:] if not a.startswith("-")]
    if "--coverage" in sys.argv:
        create_kitti_infos_with_coverage(args[0])
    else:
        create_kitti_infos(args[0], workers=int(args[1]) if len(args) > 1 else 4)
