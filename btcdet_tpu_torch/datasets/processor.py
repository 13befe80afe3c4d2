"""Data processing chain (counterpart of `btcdet_tpu/datasets/processor.py`,
reference `btcdet/datasets/processor/{data_processor,point_feature_encoder}.py`).
Numpy on the host; emits capacity-padded arrays. Every processor reads
its random draws from the `rng` it is given (the dataset seeds one per
frame), so batches are reproducible.
"""

from __future__ import annotations

import numpy as np

from ..ops import voxelizer
from ..utils import box_utils, coords


class PointFeatureEncoder:
    def __init__(self, config, point_cloud_range=None):
        self.config = config
        self.used_feature_list = list(config["used_feature_list"])
        self.src_feature_list = list(config["src_feature_list"])

    @property
    def num_point_features(self):
        return len(self.used_feature_list)

    def forward(self, data_dict):
        data_dict["use_lead_xyz"] = True
        if self.used_feature_list != self.src_feature_list:
            idx = [self.src_feature_list.index(f) for f in self.used_feature_list]
            data_dict["points"] = data_dict["points"][:, idx]
        return data_dict


class DataProcessor:
    """Runs DATA_PROCESSOR's processors in order, each a method of this
    class named by the entry's NAME."""

    def __init__(self, processor_configs, point_cloud_range, training: bool, occ_config=None):
        self.point_cloud_range = np.asarray(point_cloud_range, np.float32)
        self.training = training
        self.mode = "train" if training else "test"
        self.occ_config = occ_config
        self.queue = list(processor_configs)
        self.det_grid_size = None
        self.occ_grid_size = None
        for cfg in self.queue:
            if cfg.NAME in ("det_transform_points_to_voxels", "transform_points_to_voxels"):
                self.det_voxel_size = np.asarray(cfg.VOXEL_SIZE)
                self.det_grid_size = np.asarray(voxelizer.compute_grid_size(
                    self.point_cloud_range, cfg.VOXEL_SIZE))
            if cfg.NAME == "transform_points_to_sphere_voxels":
                assert occ_config is not None
                self.occ_voxel_size = np.asarray(cfg.VOXEL_SIZE)
                self.occ_range = np.asarray(occ_config.POINT_CLOUD_RANGE, np.float32)
                self.occ_grid_size = np.asarray(voxelizer.compute_grid_size(
                    self.occ_range, cfg.VOXEL_SIZE))
        if self.det_grid_size is not None or self.occ_grid_size is not None:
            # build / load the C++ voxelizer here, before loader workers fork
            voxelizer.host_voxelizer()

    def mask_points_and_boxes_outside_range(self, data_dict, config):
        pts = data_dict["points"]
        mask = np.all((pts[:, :3] >= self.point_cloud_range[:3])
                      & (pts[:, :3] <= self.point_cloud_range[3:6]), axis=1)
        data_dict["points"] = pts[mask]
        if config.get("REMOVE_OUTSIDE_BOXES", False) and self.training and len(
                data_dict.get("gt_boxes", [])):
            keep = box_utils.mask_boxes_outside_range(
                data_dict["gt_boxes"], self.point_cloud_range, min_num_corners=1)
            data_dict["gt_boxes"] = data_dict["gt_boxes"][keep]
        return data_dict

    def shuffle_points(self, data_dict, config, rng=None):
        if config["SHUFFLE_ENABLED"][self.mode]:
            rng = rng or np.random
            data_dict["points"] = data_dict["points"][rng.permutation(len(data_dict["points"]))]
        return data_dict

    def transform_points_to_sphere_voxels(self, data_dict, config, rng=None):
        """Occ-grid voxelization in sphere / cylinder coords (reference
        `data_processor.py:105-155`): voxelize the pre-rotation points on
        the sensor-frame grid, then shift the stored azimuth channel by
        -rot_z so the point features are world-frame."""
        pts = data_dict.get("pre_rot_points", data_dict["points"])
        if self.occ_config.COORD_TYPE == "sphere":
            occ_pts = coords.absxyz_to_sphere(pts)
        elif self.occ_config.COORD_TYPE == "cylinder":
            occ_pts = coords.absxyz_to_cylinder(pts)
        else:
            raise NotImplementedError(self.occ_config.COORD_TYPE)
        voxels, coords_zyx, num_points = voxelizer.voxelize_np(
            np.asarray(occ_pts), self.occ_range, config.VOXEL_SIZE,
            int(config.MAX_POINTS_PER_VOXEL), int(config.MAX_NUMBER_OF_VOXELS[self.mode]))
        if "pre_rot_points" in data_dict:
            voxels[..., 1] -= data_dict["rot_z"]
            voxels[..., 1] *= (np.abs(voxels).sum(-1) > 0)  # keep padding zero
            data_dict.pop("pre_rot_points")
        data_dict["occ_voxels"] = voxels
        data_dict["occ_voxel_coords"] = coords_zyx
        data_dict["occ_voxel_num_points"] = num_points
        return data_dict

    def det_transform_points_to_voxels(self, data_dict, config, rng=None):
        voxels, coords_zyx, num_points = voxelizer.voxelize_np(
            data_dict["points"], self.point_cloud_range, config.VOXEL_SIZE,
            int(config.MAX_POINTS_PER_VOXEL), int(config.MAX_NUMBER_OF_VOXELS[self.mode]))
        prefix = "det_" if self.occ_config is not None else ""
        data_dict[f"{prefix}voxels"] = voxels
        data_dict[f"{prefix}voxel_coords"] = coords_zyx
        data_dict[f"{prefix}voxel_num_points"] = num_points
        return data_dict

    transform_points_to_voxels = det_transform_points_to_voxels

    def gen_pnt_label(self, data_dict, config, rng=None):
        """Per-voxel-point foreground class labels (reference
        `data_processor.py:193` + `point_box_utils.py:10` with slack): the
        max over boxes of (inside the slack-scaled box) * box class id."""
        voxels = data_dict["voxels"]
        num_points = data_dict["voxel_num_points"]
        V, VP, _ = voxels.shape
        slack = float(config.get("SLACK", 1.0))
        gt = np.asarray(data_dict.get("gt_boxes", np.zeros((0, 8))))
        label = np.zeros((V, VP), np.float32)
        if len(gt):
            mask = np.arange(VP)[None, :] < np.asarray(num_points)[:, None]
            pts = voxels.reshape(V * VP, -1)[:, :3]
            slacked = np.concatenate([gt[:, :3], gt[:, 3:6] * slack, gt[:, 6:7]], axis=1)
            inbox = box_utils.points_in_boxes_mask_np(pts, slacked)  # (V*VP, M)
            lab = (inbox * gt[None, :, 7]).max(axis=1)
            label = (lab.reshape(V, VP) * mask).astype(np.float32)
        data_dict["voxel_points_label"] = label
        return data_dict

    def sample_points(self, data_dict, config, rng=None):
        """Keep NUM_POINTS points: every far one (depth >= 40 m) and near
        ones drawn without replacement (reference `data_processor.py:157`)."""
        num = config["NUM_POINTS"][self.mode]
        pts = data_dict["points"]
        if num < len(pts):
            rng = rng or np.random
            depth = np.linalg.norm(pts[:, :3], axis=1)
            near = depth < 40.0
            far_idx = np.where(~near)[0]
            near_idx = np.where(near)[0]
            choice = (rng.choice(near_idx, num - len(far_idx), replace=False)
                      if num > len(far_idx) else rng.choice(far_idx, num, replace=False))
            if num > len(far_idx):
                choice = np.concatenate([far_idx, choice])
            data_dict["points"] = pts[choice]
        return data_dict

    def forward(self, data_dict, rng=None):
        for cfg in self.queue:
            fn = getattr(self, cfg.NAME)
            data_dict = (fn(data_dict, cfg) if cfg.NAME == "mask_points_and_boxes_outside_range"
                         else fn(data_dict, cfg, rng=rng))
        return data_dict
