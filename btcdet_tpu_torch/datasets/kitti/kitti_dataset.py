"""KITTI dataset (counterpart of `btcdet_tpu/datasets/kitti/kitti_dataset.py`,
reference `btcdet/datasets/kitti/kitti_dataset.py` and `dataset.py`).

Host side, numpy only: `__getitem__` reads a frame and runs the feature
encoder and the processors; `collate_batch` pads every frame to fixed
capacities (points to MAX_POINTS_PER_FRAME, gt boxes to MAX_GT_BOXES,
best-match points to MAX_BM_POINTS) and concatenates the voxel tables
with a batch-index column, the JAX package's batch bit for bit;
`to_device` moves a collated batch onto the run's device as torch tensors.
A training dataset runs the yaml's DATA_AUGMENTOR (`datasets/augmentor.py`:
gt sampling, best-match points, world flip / scaling / rotation) before
the processors, every draw from the frame's (epoch, index) RandomState.

Offline tools (`create_kitti_infos`, `create_groundtruth_database`) are in
`kitti_infos.py`.
"""

from __future__ import annotations

import copy
import pickle
from pathlib import Path

import numpy as np
import torch

from ...utils import box_utils
from .. import augmentor as augmentor_mod
from .. import processor as processor_mod
from . import calibration, object3d


class KittiDataset:
    def __init__(self, dataset_cfg, class_names, training=True, root_path=None, logger=None):
        self.dataset_cfg = dataset_cfg
        self.class_names = list(class_names)
        self.training = training
        self.logger = logger
        self.root_path = Path(root_path or dataset_cfg.DATA_PATH)
        self.split = dataset_cfg.DATA_SPLIT["train" if training else "test"]
        self.root_split_path = self.root_path / ("training" if self.split != "test" else "testing")
        split_file = self.root_path / "ImageSets" / f"{self.split}.txt"
        self.sample_id_list = ([x.strip() for x in open(split_file).readlines()]
                               if split_file.exists() else [])
        self.kitti_infos = []
        self.include_kitti_data("train" if training else "test")

        self.point_cloud_range = np.asarray(dataset_cfg.POINT_CLOUD_RANGE, np.float32)
        self.point_feature_encoder = processor_mod.PointFeatureEncoder(
            dataset_cfg.POINT_FEATURE_ENCODING, self.point_cloud_range)
        self.data_augmentor = (
            augmentor_mod.DataAugmentor(self.root_path, dataset_cfg.DATA_AUGMENTOR,
                                        self.class_names, logger)
            if training and dataset_cfg.get("DATA_AUGMENTOR", None) else None)
        self.data_processor = processor_mod.DataProcessor(
            dataset_cfg.DATA_PROCESSOR, self.point_cloud_range, training,
            occ_config=dataset_cfg.get("OCC", None))
        self.det_grid_size = self.data_processor.det_grid_size
        self.occ_grid_size = self.data_processor.occ_grid_size
        # static collate capacities
        self.max_points = int(dataset_cfg.get("MAX_POINTS_PER_FRAME", 18000))
        self.max_gt = int(dataset_cfg.get("MAX_GT_BOXES", 50))
        self.max_bm = int(dataset_cfg.get("MAX_BM_POINTS", 8192))
        self._epoch = 0

    def include_kitti_data(self, mode):
        infos = []
        for info_path in self.dataset_cfg.INFO_PATH.get(mode, []):
            path = self.root_path / info_path
            if not path.exists():
                continue
            with open(path, "rb") as f:
                infos.extend(pickle.load(f))
        self.kitti_infos = infos
        if self.logger:
            self.logger.info(f"Loaded {len(infos)} kitti infos for {mode}")

    # ----------------------------------------------------------- readers

    def get_lidar(self, idx):
        lidar_file = self.root_split_path / "velodyne" / f"{idx}.bin"
        return np.fromfile(str(lidar_file), dtype=np.float32).reshape(-1, 4)

    def get_calib(self, idx):
        return calibration.Calibration(str(self.root_split_path / "calib" / f"{idx}.txt"))

    def get_label(self, idx):
        return object3d.get_objects_from_label(
            str(self.root_split_path / "label_2" / f"{idx}.txt"))

    def get_road_plane(self, idx):
        plane_file = self.root_split_path / "planes" / f"{idx}.txt"
        if not plane_file.exists():
            return None
        with open(plane_file) as f:
            lines = f.readlines()
        plane = np.asarray([float(i) for i in lines[3].split()])
        if plane[1] > 0:
            plane = -plane
        return plane / np.linalg.norm(plane[:3])

    @staticmethod
    def get_fov_flag(pts_rect, img_shape, calib):
        pts_img, pts_rect_depth = calib.rect_to_img(pts_rect)
        val_flag = ((pts_img[:, 0] >= 0) & (pts_img[:, 0] < img_shape[1])
                    & (pts_img[:, 1] >= 0) & (pts_img[:, 1] < img_shape[0]))
        return val_flag & (pts_rect_depth >= 0)

    # ------------------------------------------------------------ access

    def __len__(self):
        return len(self.kitti_infos)

    def __getitem__(self, index):
        info = copy.deepcopy(self.kitti_infos[index])
        sample_idx = info["point_cloud"]["lidar_idx"]
        points = self.get_lidar(sample_idx)
        calib = self.get_calib(sample_idx)
        img_shape = info["image"]["image_shape"]
        if self.dataset_cfg.get("FOV_POINTS_ONLY", False):
            pts_rect = calib.lidar_to_rect(points[:, 0:3])
            points = points[self.get_fov_flag(pts_rect, img_shape, calib)]

        input_dict = {"points": points, "frame_id": sample_idx, "calib": calib}
        if "annos" in info:
            annos = info["annos"]
            annos = {k: v[annos["name"] != "DontCare"] for k, v in annos.items()}
            input_dict.update({"gt_names": annos["name"], "gt_boxes": annos["gt_boxes_lidar"]})
            road_plane = self.get_road_plane(sample_idx)
            if road_plane is not None:
                input_dict["road_plane"] = road_plane
        return self.prepare_data(input_dict, index)

    def prepare_data(self, data_dict, index=0):
        """Reference `dataset.py:100`; the frame's random draws (augmentor,
        processors, the redraw of a frame left with no box of the classes)
        come from a RandomState seeded by (epoch, index)."""
        rng = np.random.RandomState((self._epoch * 131071 + index * 8191) % (2**31))
        if self.training:
            if "gt_boxes" not in data_dict:
                raise ValueError(f"training frame {data_dict.get('frame_id')} has no labels")
            data_dict["gt_boxes_mask"] = np.array(
                [n in self.class_names for n in data_dict["gt_names"]], dtype=bool)
            if self.data_augmentor is not None:
                data_dict = self.data_augmentor.forward(data_dict, rng=rng)
            if len(data_dict["gt_boxes"]) == 0 or not np.any(
                    np.isin(data_dict["gt_names"], self.class_names)):
                return self[rng.randint(len(self))]  # re-draw empty frames

        if "gt_boxes" in data_dict:
            selected = np.isin(data_dict["gt_names"], self.class_names)
            data_dict["gt_boxes"] = data_dict["gt_boxes"][selected]
            data_dict["gt_names"] = data_dict["gt_names"][selected]
            gt_classes = np.array([self.class_names.index(n) + 1 for n in data_dict["gt_names"]],
                                  dtype=np.int32)
            data_dict["gt_boxes"] = np.concatenate(
                [data_dict["gt_boxes"], gt_classes.reshape(-1, 1).astype(np.float32)], axis=1)
            # mirror supervision excluded for pedestrians (reference `dataset.py:160`)
            data_dict["box_mirr_flag"] = np.array(
                [n != "Pedestrian" for n in data_dict["gt_names"]], dtype=np.float32)

        data_dict = self.point_feature_encoder.forward(data_dict)
        data_dict = self.data_processor.forward(data_dict, rng=rng)
        data_dict.pop("calib", None)
        data_dict.pop("road_plane", None)
        data_dict.pop("gt_names", None)
        return data_dict

    # ----------------------------------------------------------- collate

    def collate_batch(self, batch_list):
        """Static-shape batch assembly: numpy arrays, and `frame_id`, the
        frames' ids as a list of strings."""
        B = len(batch_list)
        out = {}

        def pad_to(arr, n, fill=0.0):
            arr = np.asarray(arr)
            if len(arr) >= n:
                return arr[:n]
            pad = np.full((n - len(arr),) + arr.shape[1:], fill, arr.dtype)
            return np.concatenate([arr, pad], axis=0)

        out["points"] = np.stack([pad_to(d["points"], self.max_points)
                                  for d in batch_list]).astype(np.float32)
        out["points_mask"] = np.stack([np.arange(self.max_points) < len(d["points"])
                                       for d in batch_list])

        use_occ = "occ_voxels" in batch_list[0]
        vox_key = "det_" if use_occ else ""
        for prefix in ([vox_key, "occ_"] if use_occ else [vox_key]):
            v = np.concatenate([d[f"{prefix}voxels"] for d in batch_list])
            c = np.concatenate([
                np.concatenate([np.where(d[f"{prefix}voxel_coords"][:, :1] >= 0, b, -1),
                                d[f"{prefix}voxel_coords"]], axis=1)
                for b, d in enumerate(batch_list)])
            n = np.concatenate([d[f"{prefix}voxel_num_points"] for d in batch_list])
            out[f"{prefix}voxels"] = v.astype(np.float32)
            out[f"{prefix}voxel_coords"] = c.astype(np.int32)
            out[f"{prefix}voxel_num_points"] = n.astype(np.int32)

        if "gt_boxes" in batch_list[0]:
            out["gt_boxes"] = np.stack([pad_to(d["gt_boxes"], self.max_gt)
                                        for d in batch_list]).astype(np.float32)
            out["box_mirr_flag"] = np.stack([
                pad_to(d.get("box_mirr_flag", np.zeros(0)), self.max_gt)
                for d in batch_list]).astype(np.float32)

        if use_occ:
            out["rot_z"] = np.array([d.get("rot_z", 0.0) for d in batch_list], np.float32)
            out["use_occ_prob"] = np.ones((B,), bool)
            bm = [d.get("bm_points", np.zeros((0, 3), np.float32)) for d in batch_list]
            out["bm_points"] = np.stack([pad_to(x, self.max_bm) for x in bm]).astype(np.float32)
            out["bm_points_mask"] = np.stack([np.arange(self.max_bm) < len(x) for x in bm])
        out["frame_id"] = [d.get("frame_id") for d in batch_list]
        return out

    # -------------------------------------------------------- prediction

    def generate_prediction_dicts(self, batch_dict, pred_dicts, class_names, output_path=None):
        """Network output -> KITTI-format annotations (reference
        `kitti_dataset.py:319`). pred_dicts: per-frame dicts of numpy
        pred_boxes / pred_scores / pred_labels (and pred_valid)."""
        annos = []
        for index, box_dict in enumerate(pred_dicts):
            frame_id = batch_dict["frame_id"][index]
            valid = box_dict.get("pred_valid")
            boxes = box_dict["pred_boxes"]
            scores = box_dict["pred_scores"]
            labels = box_dict["pred_labels"]
            if valid is not None:
                boxes, scores, labels = boxes[valid], scores[valid], labels[valid]
            anno = {
                "name": np.array([class_names[l - 1] for l in labels]),
                "truncated": np.zeros(len(boxes)),
                "occluded": np.zeros(len(boxes)),
                "alpha": np.zeros(len(boxes)),
                "bbox": np.zeros((len(boxes), 4)),
                "dimensions": np.zeros((len(boxes), 3)),
                "location": np.zeros((len(boxes), 3)),
                "rotation_y": np.zeros(len(boxes)),
                "score": scores,
                "boxes_lidar": boxes,
            }
            calib = None
            img_shape = None
            if self.kitti_infos:
                if not hasattr(self, "_frame_to_info"):
                    self._frame_to_info = {i["point_cloud"]["lidar_idx"]: i
                                           for i in self.kitti_infos}
                info = self._frame_to_info.get(frame_id)
                if info is not None:
                    calib = calibration.Calibration({
                        "P2": info["calib"]["P2"][:3, :],
                        "R0": info["calib"]["R0_rect"][:3, :3],
                        "Tr_velo2cam": info["calib"]["Tr_velo_to_cam"][:3, :],
                    })
                    img_shape = info["image"]["image_shape"]
            if calib is not None and len(boxes):
                cam_boxes = box_utils.boxes3d_lidar_to_kitti_camera(boxes, calib)
                anno["bbox"] = box_utils.boxes3d_kitti_camera_to_imageboxes(
                    cam_boxes, calib, img_shape)
                anno["dimensions"] = cam_boxes[:, 3:6]
                anno["location"] = cam_boxes[:, 0:3]
                anno["rotation_y"] = cam_boxes[:, 6]
                anno["alpha"] = -np.arctan2(-boxes[:, 1], boxes[:, 0]) + cam_boxes[:, 6]
            anno["frame_id"] = frame_id
            annos.append(anno)
            if output_path is not None:
                self.write_kitti_txt(anno, frame_id, output_path)
        return annos

    @staticmethod
    def write_kitti_txt(anno, frame_id, output_path):
        """Write `anno` as `<output_path>/<frame_id>.txt` in the KITTI label format."""
        with open(Path(output_path) / f"{frame_id}.txt", "w") as f:
            for k in range(len(anno["name"])):
                d = anno["dimensions"][k]
                l_ = anno["location"][k]
                print("%s -1 -1 %.4f %.4f %.4f %.4f %.4f %.4f %.4f %.4f %.4f %.4f %.4f %.4f %.4f"
                      % (anno["name"][k], anno["alpha"][k],
                         anno["bbox"][k][0], anno["bbox"][k][1],
                         anno["bbox"][k][2], anno["bbox"][k][3],
                         d[1], d[2], d[0], l_[0], l_[1], l_[2],
                         anno["rotation_y"][k], anno["score"][k]),
                      file=f)

    def evaluation(self, det_annos, class_names, **kwargs):
        """(result string, result dict, PR-curve details) of the official
        KITTI metric over the split's gt annos."""
        if "annos" not in self.kitti_infos[0]:
            return "no gt annos", {}, {}
        from ...eval import kitti_eval

        eval_det_annos = copy.deepcopy(det_annos)
        eval_gt_annos = [copy.deepcopy(info["annos"]) for info in self.kitti_infos]
        return kitti_eval.get_official_eval_result(
            eval_gt_annos, eval_det_annos, class_names,
            coverage_rates=kwargs.get("coverage_rates"))


def to_device(batch: dict, device) -> dict:
    """A collated batch as torch tensors on `device`, every key but
    `frame_id` (kept as its list of strings); same keys, dtypes and shapes
    as `datasets.synthetic.make_synthetic_batch`, whose voxel coords are
    int64 (collate's int32 values, widened)."""
    out = {}
    for k, v in batch.items():
        if k != "frame_id":
            v = torch.from_numpy(np.ascontiguousarray(v))
            v = v.to(device, torch.int64 if k.endswith("voxel_coords") else v.dtype)
        out[k] = v
    return out
