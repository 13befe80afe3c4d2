"""Data augmentation (counterpart of `btcdet_tpu/datasets/augmentor.py`,
reference `btcdet/datasets/augmentor/`).

Queue of named augmentors driven by the YAML AUG_CONFIG_LIST:
  gt_sampling           paste objects from the gt database into the scene
                        (class-balanced sampling, road-plane height snap,
                        BEV-IoU collision rejection; reference
                        `database_sampler.py`)
  sup_gt_sampling       the same with cylinder-space placement jitter and
                        bm-shape-only boxes (reference `sup_gt_sampling.py`)
  add_multi_best_match  load per-object approximate complete shapes
                        (`bm_*.pkl`) and place them for real + pasted
                        boxes (reference `multi_best_match_querier.py`)
  add_best_match        the older single-best-match variant
  random_world_flip / random_world_rotation / random_world_scaling
                        global transforms applied to gt, points, and the
                        special point lists; SAVE_PRE_ROT stashes the
                        pre-rotation points + rot_z degrees so the occ
                        grid can be built in the sensor frame
                        (reference `data_augmentor.py:136-155`)

Numpy only (the collision IoU is `ops.iou3d.boxes_bev_iou_cpu`); runs in
DataLoader worker processes. Every draw comes from the `rng` passed in, in
the JAX package's order, so a frame's augmentation is the JAX package's
bit for bit.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from ..ops import iou3d
from ..utils import box_utils, common
from ..utils import coords as common_coords

# point sets carried through flip/rotation/scaling alongside the raw
# cloud (reference `data_augmentor.py:8`): the bm supervision points plus
# the 9 occ-vis debug sets emitted by the ABLATION.VIS branch of
# MltBestMatchQuerier.filter_bm
SPECIAL_NAMES = [
    "bm_points", "miss_points", "self_points", "other_points",
    "miss_occ_points", "self_occ_points", "other_occ_points",
    "self_limit_occ_mask", "miss_full_occ_points", "other_full_occ_points",
]

# spherical support grid resolution used by the ablation filtering
# (reference `multi_best_match_querier.py:31`): (range m, azimuth deg,
# elevation deg)
_BM_SPHERE_RES = np.array([[0.32, 0.5184, 0.4203125]])


def random_flip_along_x(gt_boxes, points, special_points_lst, enable=None, rng=None):
    rng = rng or np.random
    if enable is None:
        enable = rng.choice([False, True])
    if enable:
        gt_boxes[:, 1] = -gt_boxes[:, 1]
        gt_boxes[:, 6] = -gt_boxes[:, 6]
        points[:, 1] = -points[:, 1]
        for sp in special_points_lst:
            if len(sp):
                sp[:, 1] = -sp[:, 1]
    return gt_boxes, points, special_points_lst


def global_rotation(gt_boxes, points, rot_range, special_points_lst, rng=None):
    rng = rng or np.random
    noise_rotation = rng.uniform(rot_range[0], rot_range[1])
    points[:, :3] = common.rotate_points_along_z_np(
        points[None, :, :3], np.array([noise_rotation])
    )[0]
    gt_boxes[:, 0:3] = common.rotate_points_along_z_np(
        gt_boxes[None, :, 0:3], np.array([noise_rotation])
    )[0]
    gt_boxes[:, 6] += noise_rotation
    for sp in special_points_lst:
        if len(sp):
            sp[:, :3] = common.rotate_points_along_z_np(
                sp[None, :, :3], np.array([noise_rotation])
            )[0]
    return gt_boxes, points, noise_rotation, special_points_lst


def global_scaling(gt_boxes, points, scale_range, special_points_lst, rng=None):
    rng = rng or np.random
    if scale_range[1] - scale_range[0] < 1e-3:
        return gt_boxes, points, special_points_lst
    scale = rng.uniform(scale_range[0], scale_range[1])
    points[:, :3] *= scale
    gt_boxes[:, :6] *= scale
    for sp in special_points_lst:
        if len(sp):
            sp[:, :3] *= scale
    return gt_boxes, points, special_points_lst


class DataBaseSampler:
    """gt_sampling (reference `database_sampler.py`)."""

    def __init__(self, root_path, sampler_cfg, class_names, logger=None):
        self.root_path = Path(root_path)
        self.class_names = class_names
        self.sampler_cfg = sampler_cfg
        self.logger = logger
        self.db_infos = {c: [] for c in class_names}
        for db_info_path in sampler_cfg.DB_INFO_PATH:
            path = self.root_path / db_info_path
            with open(path, "rb") as f:
                infos = pickle.load(f)
                for c in class_names:
                    if c in infos:
                        self.db_infos[c].extend(infos[c])
        for func_name, val in sampler_cfg.PREPARE.items():
            self.db_infos = getattr(self, func_name)(self.db_infos, val)

        self.sample_groups = {}
        self.sample_class_num = {}
        self.limit_whole_scene = sampler_cfg.get("LIMIT_WHOLE_SCENE", False)
        for x in sampler_cfg.SAMPLE_GROUPS:
            class_name, sample_num = x.split(":")
            if class_name not in class_names:
                continue
            self.sample_class_num[class_name] = int(sample_num)
            self.sample_groups[class_name] = {
                "sample_num": int(sample_num),
                "pointer": len(self.db_infos[class_name]),
                "indices": np.arange(len(self.db_infos[class_name])),
            }

    def filter_by_difficulty(self, db_infos, removed_difficulty):
        new_db_infos = {}
        for key, dinfos in db_infos.items():
            new_db_infos[key] = [
                info for info in dinfos if info["difficulty"] not in removed_difficulty
            ]
        return new_db_infos

    def filter_by_min_points(self, db_infos, min_gt_points_list):
        for name_num in min_gt_points_list:
            name, min_num = name_num.split(":")
            min_num = int(min_num)
            if min_num > 0 and name in db_infos:
                db_infos[name] = [
                    info for info in db_infos[name]
                    if info["num_points_in_gt"] >= min_num
                ]
        return db_infos

    def sample_with_fixed_number(self, class_name, sample_group, rng):
        sample_num, pointer, indices = (
            sample_group["sample_num"], sample_group["pointer"], sample_group["indices"]
        )
        if pointer >= len(self.db_infos[class_name]):
            indices = rng.permutation(len(self.db_infos[class_name]))
            pointer = 0
        sampled = [
            self.db_infos[class_name][idx]
            for idx in indices[pointer: pointer + sample_num]
        ]
        sample_group["pointer"] = pointer + sample_num
        sample_group["indices"] = indices
        return sampled

    @staticmethod
    def put_boxes_on_road_planes(gt_boxes, road_planes, calib):
        """Snap sampled boxes to the road plane (reference
        `database_sampler.py:91`)."""
        a, b, c, d = road_planes
        center_cam = calib.lidar_to_rect(gt_boxes[:, 0:3])
        cur_height_cam = (-d - a * center_cam[:, 0] - c * center_cam[:, 2]) / b
        center_cam[:, 1] = cur_height_cam
        cur_lidar_height = calib.rect_to_lidar(center_cam)[:, 2]
        mv_height = gt_boxes[:, 2] - gt_boxes[:, 5] / 2 - cur_lidar_height
        gt_boxes[:, 2] -= mv_height
        return gt_boxes, mv_height

    def add_sampled_boxes_to_scene(self, data_dict, sampled_gt_boxes, total_valid_sampled_dict):
        root = self.root_path
        gt_boxes_mask = data_dict["gt_boxes_mask"]
        gt_boxes = data_dict["gt_boxes"][gt_boxes_mask]
        gt_names = data_dict["gt_names"][gt_boxes_mask]
        # original (post-DontCare, pre-class-filter) gt label indices must
        # track the surviving boxes: the bm pkl files are keyed by that
        # index space (reference `database_sampler.py:114`)
        if "gt_boxes_inds" in data_dict:
            data_dict["gt_boxes_inds"] = data_dict["gt_boxes_inds"][gt_boxes_mask]
        points = data_dict["points"]
        if self.sampler_cfg.get("USE_ROAD_PLANE", False) and "road_plane" in data_dict:
            sampled_gt_boxes, mv_height = self.put_boxes_on_road_planes(
                sampled_gt_boxes, data_dict["road_plane"], data_dict["calib"]
            )
        else:
            mv_height = np.zeros(len(sampled_gt_boxes))

        obj_points_list = []
        image_idx_list = []
        gt_idx_list = []
        for idx, info in enumerate(total_valid_sampled_dict):
            file_path = root / info["path"]
            obj_points = np.fromfile(str(file_path), dtype=np.float32).reshape(
                [-1, self.sampler_cfg.NUM_POINT_FEATURES]
            ).copy()
            obj_points[:, :3] += info["box3d_lidar"][:3]
            obj_points[:, 2] -= mv_height[idx]
            obj_points_list.append(obj_points)
            image_idx_list.append(info["image_idx"])
            gt_idx_list.append(info["gt_idx"])

        obj_points = (
            np.concatenate(obj_points_list, axis=0)
            if obj_points_list else np.zeros((0, points.shape[1]), points.dtype)
        )
        sampled_gt_names = np.array([x["name"] for x in total_valid_sampled_dict])

        # remove scene points inside pasted boxes
        if len(sampled_gt_boxes):
            mask = np.asarray(
                box_utils.points_in_boxes_mask_np(points[:, :3], sampled_gt_boxes[:, :7])
            ).any(axis=1)
            points = points[~mask]
        data_dict["points"] = np.concatenate([obj_points, points], axis=0)
        data_dict["gt_boxes"] = np.concatenate([gt_boxes, sampled_gt_boxes], axis=0)
        data_dict["gt_names"] = np.concatenate([gt_names, sampled_gt_names], axis=0)
        # bookkeeping for the bm querier (reference :214-215)
        data_dict["aug_boxes_image_idx"] = np.array(image_idx_list)
        data_dict["aug_boxes_gt_idx"] = np.array(gt_idx_list)
        data_dict["gt_boxes_mask"] = np.ones(len(data_dict["gt_boxes"]), dtype=bool)
        return data_dict

    def __call__(self, data_dict, rng=None):
        rng = rng or np.random
        gt_boxes = data_dict["gt_boxes"]
        gt_names = data_dict["gt_names"].astype(str)
        existed_boxes = gt_boxes
        total_valid_sampled_dict = []
        sampled_mv_height = []
        for class_name, sample_group in self.sample_groups.items():
            if self.limit_whole_scene:
                num_gt = np.sum(class_name == gt_names)
                sample_group["sample_num"] = self.sample_class_num[class_name] - num_gt
            if sample_group["sample_num"] > 0:
                sampled_dict = self.sample_with_fixed_number(class_name, sample_group, rng)
                sampled_boxes = np.stack(
                    [x["box3d_lidar"] for x in sampled_dict], axis=0
                ).astype(np.float32)

                iou1 = iou3d.boxes_bev_iou_cpu(sampled_boxes[:, :7], existed_boxes[:, :7]) \
                    if len(existed_boxes) else np.zeros((len(sampled_boxes), 0))
                iou2 = iou3d.boxes_bev_iou_cpu(sampled_boxes[:, :7], sampled_boxes[:, :7])
                iou2[range(len(sampled_boxes)), range(len(sampled_boxes))] = 0
                iou1 = iou1 if iou1.shape[1] else iou2
                valid = ((iou2.max(axis=1) + iou1.max(axis=1)) == 0).nonzero()[0]
                valid_sampled_dict = [sampled_dict[x] for x in valid]
                valid_sampled_boxes = sampled_boxes[valid]
                existed_boxes = np.concatenate([existed_boxes, valid_sampled_boxes], axis=0)
                total_valid_sampled_dict.extend(valid_sampled_dict)

        sampled_gt_boxes = existed_boxes[gt_boxes.shape[0]:, :]
        if len(total_valid_sampled_dict) > 0:
            data_dict = self.add_sampled_boxes_to_scene(
                data_dict, sampled_gt_boxes, total_valid_sampled_dict
            )
        data_dict.pop("gt_boxes_mask", None)
        return data_dict


class MltBestMatchQuerier:
    """add_multi_best_match (reference `multi_best_match_querier.py`):
    loads the per-object `bm_*.pkl` approximate complete shapes and
    rotates/translates them into the scene for real and pasted boxes.
    Optional ABLATION filtering removes self-occluded / non-occluded
    ("miss") bm points via spherical cumsum occupancy (`filter_bm:101`)."""

    def __init__(self, root_path, querier_cfg, class_names, logger=None):
        self.root_path = Path(root_path)
        self.cfg = querier_cfg
        self.class_names = class_names
        self.bm_roots = {
            "Car": querier_cfg.get("CAR_MLT_BM_ROOT", None),
            "Cyclist": querier_cfg.get("CYC_MLT_BM_ROOT", None),
            "Pedestrian": querier_cfg.get("PED_MLT_BM_ROOT", None),
        }
        self.add_bm_2_raw = bool(querier_cfg.get("ADD_BM_2_RAW", False))
        abl = querier_cfg.get("ABLATION", None)
        self.ablation = abl is not None
        self.rmv_self_occ = bool(abl.get("RMV_SELF_OCC", False)) if abl else False
        self.rmv_miss = bool(abl.get("RMV_MISS", False)) if abl else False
        self.abl_num_feat = int(abl.get("NUM_POINT_FEATURES", 4)) if abl else 4
        self.abl_vis = bool(abl.get("VIS", False)) if abl else False

    def _load_bm(self, cls_name, image_idx, gt_idx):
        root = self.bm_roots.get(cls_name)
        if root is None:
            return None
        try:
            name = f"{int(image_idx)}_{int(gt_idx)}.pkl"  # bm files strip zero-padding
        except (TypeError, ValueError):
            name = f"{image_idx}_{gt_idx}.pkl"
        path = self.root_path / root / name
        if not path.exists():
            return None
        with open(path, "rb") as f:
            return pickle.load(f)

    def __call__(self, data_dict, rng=None):
        gt_boxes = data_dict["gt_boxes"]
        gt_names = data_dict["gt_names"].astype(str)
        n_aug = len(data_dict.get("aug_boxes_image_idx", []))
        n_real = len(gt_boxes) - n_aug
        frame_id = data_dict.get("frame_id")
        # SupGTSampling already loaded the pasted boxes' shapes and set
        # pre_aug_bm (reference `__call__:284-285`): only real boxes here
        pre_aug = data_dict.pop("pre_aug_bm", False)
        pre_list = list(data_dict.get("bm_points", [])) if pre_aug else []
        bm_list, bm_boxes = [], []
        for i, (box, name) in enumerate(zip(gt_boxes, gt_names)):
            if name not in self.class_names:
                continue
            if pre_aug and i >= n_real:
                continue
            if i < n_real:
                # real box: original label-file index (post-DontCare, before
                # class filtering) threaded through `gt_boxes_inds`
                # (reference `multi_best_match_querier.py:55-63`). A bare
                # enumerate index would be wrong whenever non-class objects
                # (Vans/Trucks) precede this box in the label file.
                inds = data_dict.get("gt_boxes_inds")
                image_idx = frame_id
                gt_idx = int(inds[i]) if inds is not None else i
            else:
                j = i - n_real
                image_idx = data_dict["aug_boxes_image_idx"][j]
                gt_idx = data_dict["aug_boxes_gt_idx"][j]
            pts = self._load_bm(name, image_idx, gt_idx)
            if pts is None or len(pts) == 0:
                continue
            pts = np.asarray(pts, dtype=np.float32)[:, :3]
            # canonical -> scene: rotate by box yaw, translate to center
            c, s = np.cos(box[6]), np.sin(box[6])
            world = np.stack([
                pts[:, 0] * c - pts[:, 1] * s + box[0],
                pts[:, 0] * s + pts[:, 1] * c + box[1],
                pts[:, 2] + box[2],
            ], axis=1)
            bm_list.append(world)
            bm_boxes.append(np.asarray(box[:7], np.float32))
        if pre_list:
            # align with gt order [real..., sampled...]
            bm_list = bm_list + pre_list
            bm_boxes = bm_boxes + [
                np.asarray(b[:7], np.float32) for b in gt_boxes[n_real:]
            ][: len(pre_list)]
        if self.ablation and bm_list:
            bm_list = self.filter_bm(data_dict, np.stack(bm_boxes), bm_list)
        data_dict["bm_points"] = (
            np.concatenate(bm_list, axis=0).astype(np.float32)
            if bm_list else np.zeros((0, 3), np.float32)
        )
        return data_dict

    # -------------------------------------------------- ABLATION filtering
    # (reference `multi_best_match_querier.py:101-243`): on a spherical
    # support grid over the whole frame, drop bm points that (a) fall in a
    # voxel already occupied by the object's real points, (b) RMV_SELF_OCC:
    # sit behind the bm shape's own first surface along the ray (cumsum
    # over the range axis >= 1.5), (c) RMV_MISS: are NOT occluded by
    # anything in the scene (cumsum occupancy mask == 0) -- i.e. a
    # visible-but-unscanned region the sensor should have seen. Boxes are
    # processed nearest-first and their kept bm voxels become occluders
    # for farther boxes.

    def _sphere_grid(self, pts3):
        sp = np.asarray(common_coords.absxyz_to_sphere(pts3[:, :3]))
        cmin = sp.min(axis=0, keepdims=True) - 10.0 * _BM_SPHERE_RES
        coords = np.floor_divide(sp - cmin, _BM_SPHERE_RES).astype(np.int32)
        dims = coords.max(axis=0) + 11
        return cmin, tuple(int(d) for d in dims)

    def _sphere_coords(self, pts, cmin, dims):
        """Returns (kept pts, sphere pts, coords) clipped to the grid."""
        if len(pts) == 0:
            z = np.zeros((0, 3), np.float32)
            return pts, z, np.zeros((0, 3), np.int32)
        sp = np.asarray(common_coords.absxyz_to_sphere(pts[:, :3]))
        coords = np.floor_divide(sp - cmin, _BM_SPHERE_RES).astype(np.int32)
        keep = np.all(coords >= 0, axis=1) & np.all(
            coords < np.asarray(dims)[None], axis=1)
        return pts[keep], sp[keep], coords[keep]

    @staticmethod
    def _mask_of(coords, dims, back_expand: int = 0):
        """Occupancy mask; back_expand also marks the `back_expand` voxels
        in FRONT (smaller range) of each site (reference `exclude_map`)."""
        m = np.zeros(dims, np.uint8)
        if len(coords) == 0:
            return m
        reps = [coords]
        for d in range(1, back_expand + 1):
            c = coords.copy()
            c[:, 0] = np.maximum(c[:, 0] - d, 0)
            reps.append(c)
        c = np.concatenate(reps, axis=0)
        m[c[:, 0], c[:, 1], c[:, 2]] = 1
        return m

    @staticmethod
    def _nearest_per_voxel(pts, sp, coords):
        """Keep the nearest-range point per occupied voxel (reference
        `get_nearest_points`)."""
        if len(pts) == 0:
            return pts, coords
        order = np.argsort(sp[:, 0], kind="stable")
        pts, coords = pts[order], coords[order]
        _, first = np.unique(coords, axis=0, return_index=True)
        return pts[first], coords[first]

    def _box_point_labels(self, points, boxes):
        """Per-point gt label (1..M, 0 = background) with slack 1.0 and a
        +0.15 m z floor shift (reference `points_in_box_3d_label`,
        `point_box_utils.py:10`); ties keep the highest label like the
        reference's max-reduction."""
        if len(boxes) == 0:
            return np.zeros(len(points), np.int32)
        label = np.zeros(len(points), np.int32)
        for i, b in enumerate(boxes):
            c, s = np.cos(-b[6]), np.sin(-b[6])
            rel = points[:, :3] - b[None, :3]
            local = np.stack([
                rel[:, 0] * c - rel[:, 1] * s,
                rel[:, 0] * s + rel[:, 1] * c,
                rel[:, 2],
            ], axis=1)
            half = b[3:6] * 0.5
            lo = -half + np.array([0.0, 0.0, 0.15])
            inb = np.all(local >= lo[None], axis=1) & np.all(
                local <= half[None], axis=1)
            label[inb] = i + 1
        return label

    def filter_bm(self, data_dict, boxes, bm_list):
        points = np.asarray(data_dict["points"], np.float32)
        order = np.argsort(np.linalg.norm(boxes[:, :2], axis=1))
        boxes_sorted = boxes[order]
        bm_sorted = [bm_list[i] for i in order]
        labels = self._box_point_labels(points, boxes_sorted)

        cmin, dims = self._sphere_grid(points)
        _, _, raw_coords = self._sphere_coords(points, cmin, dims)
        vox_mask = self._mask_of(raw_coords, dims)
        occ_mask = (np.cumsum(vox_mask, axis=0) > 0.5).astype(np.uint8)

        out = [None] * len(bm_list)
        vis = {k: [] for k in ("miss", "self", "other")}
        vis_masks = {k: np.zeros(dims, np.uint8) for k in ("miss", "other", "bm")}
        for j, (box, bm) in enumerate(zip(boxes_sorted, bm_sorted)):
            obj_pts = points[labels == (j + 1)]
            _, _, obj_coords = self._sphere_coords(obj_pts, cmin, dims)
            # the object's own surface blocks a couple of voxels in front
            # (reference get_coords x_expand -> exclude_map, x_epansion=2)
            obj_mask = self._mask_of(obj_coords, dims, back_expand=2)

            bm_pts, bm_sp, bm_coords = self._sphere_coords(
                np.asarray(bm, np.float32), cmin, dims)
            bm_vox = self._mask_of(bm_coords, dims)
            bm_occ = (np.cumsum(bm_vox, axis=0) < 1.5).astype(np.uint8)

            at = (bm_coords[:, 0], bm_coords[:, 1], bm_coords[:, 2])
            keep = 1 - obj_mask[at]
            not_self_occluded = bm_occ[at]          # first bm surface only
            scene_occluded = occ_mask[at]           # behind something real

            if self.abl_vis:
                miss = (keep * not_self_occluded * (1 - scene_occluded)).astype(bool)
                self_m = (keep * (1 - not_self_occluded)).astype(bool)
                other = (keep * not_self_occluded * scene_occluded).astype(bool)
                for k, m in (("miss", miss), ("self", self_m), ("other", other)):
                    p_k, c_k = self._nearest_per_voxel(bm_pts[m], bm_sp[m], bm_coords[m])
                    vis[k].append(p_k[:, :3])
                    if k != "self":
                        vis_masks[k][c_k[:, 0], c_k[:, 1], c_k[:, 2]] = 1
                vis_masks["bm"] = np.maximum(vis_masks["bm"], bm_vox)

            if self.rmv_self_occ:
                keep = keep * not_self_occluded
            if self.rmv_miss:
                keep = keep * scene_occluded
            keep = keep.astype(bool)
            kept_pts, kept_coords = self._nearest_per_voxel(
                bm_pts[keep], bm_sp[keep], bm_coords[keep])
            out[int(order[j])] = kept_pts[:, :3]  # back to original box order

            # kept bm voxels occlude farther boxes
            vox_mask[kept_coords[:, 0], kept_coords[:, 1], kept_coords[:, 2]] = 1
            occ_mask = (np.cumsum(vox_mask, axis=0) > 0.5).astype(np.uint8)
            if self.add_bm_2_raw and len(kept_pts):
                pad = np.zeros((len(kept_pts), points.shape[1] - 3), points.dtype)
                data_dict["points"] = np.concatenate(
                    [data_dict["points"],
                     np.concatenate([kept_pts[:, :3], pad], axis=1)], axis=0)

        if self.abl_vis:
            self._emit_vis(data_dict, vis, vis_masks, raw_coords, cmin, dims)
        return [o if o is not None else np.zeros((0, 3), np.float32) for o in out]

    def _emit_vis(self, data_dict, vis, vis_masks, raw_coords, cmin, dims):
        """The 9 occ-vis debug point sets (reference `filter_bm:160-230`,
        SPECIAL_NAMES entries 2-10)."""
        def centers(mask):
            coords = np.stack(np.nonzero(mask), axis=-1)
            sp = cmin + (coords + 0.5) * _BM_SPHERE_RES
            return np.asarray(common_coords.sphere_to_absxyz(
                sp[:, 0], sp[:, 1], sp[:, 2]), np.float32)

        def cat(lst):
            return (np.concatenate(lst, axis=0).astype(np.float32)
                    if lst else np.zeros((0, 3), np.float32))

        def propagate(mask3d):
            return np.broadcast_to(mask3d.max(axis=0, keepdims=True), mask3d.shape)

        bm_tot = vis_masks["bm"]
        self_cum = np.cumsum(bm_tot, axis=0)
        self_rev = np.flip(np.cumsum(np.flip(bm_tot, axis=0), axis=0), axis=0)
        self_tot_occ = (self_cum > 0.5).astype(np.uint8)
        self_limit_occ = (self_rev > 0.5).astype(np.uint8) * self_tot_occ

        occluder = self._mask_of(raw_coords, dims)
        other_full = (np.cumsum(occluder, axis=0) > 0.5).astype(
            np.uint8) * propagate(vis_masks["other"])
        other_tot = other_full * (1 - self_tot_occ)
        miss_full = propagate(vis_masks["miss"])
        miss_tot = miss_full * (1 - self_tot_occ)

        data_dict.update({
            "miss_points": cat(vis["miss"]),
            "self_points": cat(vis["self"]),
            "other_points": cat(vis["other"]),
            "miss_occ_points": centers(miss_tot),
            "miss_full_occ_points": centers(miss_full),
            "self_occ_points": centers(self_tot_occ),
            "self_limit_occ_mask": centers(self_limit_occ),
            "other_occ_points": centers(other_tot),
            "other_full_occ_points": centers(other_full),
        })


class BestMatchQuerier:
    """add_best_match -- the older single-best-match variant reading a
    precomputed `bmatch_infos` pkl (reference `best_match_querier.py`;
    superseded by MltBestMatchQuerier, kept for config compatibility)."""

    def __init__(self, root_path, querier_cfg, class_names, logger=None):
        self.root_path = Path(root_path)
        self.cfg = querier_cfg
        path = self.root_path / querier_cfg.get("BM_INFO_PATH", "bmatch_infos.pkl")
        self.bmatch_infos = {}
        if path.exists():
            with open(path, "rb") as f:
                self.bmatch_infos = pickle.load(f)

    def __call__(self, data_dict, rng=None):
        gt_boxes = data_dict["gt_boxes"]
        bm_list = []
        frame_id = data_dict.get("frame_id")
        for i, box in enumerate(gt_boxes):
            pts = self.bmatch_infos.get((frame_id, i))
            if pts is None or len(pts) == 0:
                continue
            pts = np.asarray(pts, np.float32)[:, :3]
            c, s = np.cos(box[6]), np.sin(box[6])
            world = np.stack([
                pts[:, 0] * c - pts[:, 1] * s + box[0],
                pts[:, 0] * s + pts[:, 1] * c + box[1],
                pts[:, 2] + box[2],
            ], axis=1)
            bm_list.append(world)
        data_dict["bm_points"] = (
            np.concatenate(bm_list, axis=0).astype(np.float32)
            if bm_list else np.zeros((0, 3), np.float32)
        )
        return data_dict


class SupGTSampling(DataBaseSampler):
    """sup_gt_sampling (reference `sup_gt_sampling.py`, full parity):
    pastes db objects either with their REAL points (GT_SMP group) or as
    bm-shape-only supervision boxes (MLT_BM group), each with cylinder-
    space placement jitter (range / azimuth / yaw, optional yaw_type
    'main' = copy a scene box's yaw); iterative BEV-IoU collision
    pruning; optional NO_STUCKING rejection of boxes containing scene
    points; per-group `remove_occ` spherical first-surface filtering +
    per-voxel dedup + drop rate; emits `bm_points` as a per-box list and
    sets `pre_aug_bm` so the bm querier skips the pasted boxes."""

    _SPHERE_RES = np.array([[0.2, 0.0875 * 2, 0.4203125]])

    def __init__(self, root_path, sampler_cfg, class_names, logger=None):
        super().__init__(root_path, sampler_cfg, class_names, logger)
        self.no_stucking = bool(sampler_cfg.get("NO_STUCKING", False))
        self.det_height_shift = float(sampler_cfg.get("DETECT_HEIGHT_SHIFT", 0.0))
        self.mlt_bm_root = Path(root_path) / sampler_cfg.get("MLT_BM_ROOT", "")
        self.bm_num_point_features = int(sampler_cfg.get("BM_NUM_POINT_FEATURES", 3))
        self.num_point_features = int(sampler_cfg.get("NUM_POINT_FEATURES", 4))
        self.gt_smp_cfg = self._group_cfg(sampler_cfg.get("GT_SMP", None))
        self.mlt_bm_cfg = self._group_cfg(sampler_cfg.get("MLT_BM", None))

    def _group_cfg(self, blk):
        if blk is None:
            return None
        groups = {}
        for x in blk.get("SAMPLE_GROUPS", []):
            cls, num = x.split(":")
            if cls in self.class_names:
                groups[cls] = int(num)
        return {
            "sample_groups": groups,
            "box_range_jitter": blk.get("BOX_RANGE_JITTER", 0.0),
            "box_rot_jitter": blk.get("BOX_ROT_JITTER", 0.0),
            "box_yaw_jitter": blk.get("BOX_YAW_JITTER", 0.0),
            "yaw_type": blk.get("YAW_TYPE", None),
            "remove_yz_expansion": int(blk.get("RMV_YZ_EXPSN", 0)),
            "dp_rate": float(blk.get("DROP_RATE", 0)),
        }

    def add_box_jitter(self, boxes, existed_boxes, cfg, rng):
        """Cylinder-space placement jitter (reference `add_box_jitter`):
        range and azimuth jittered within the KITTI working envelope,
        yaw either around the (azimuth-corrected) source yaw or copied
        from a random scene box (yaw_type 'main'). Returns (N, 8) with
        the ORIGINAL yaw appended as col 7."""
        boxes = np.array(boxes, np.float32)
        centers = np.asarray(common_coords.absxyz_to_cylinder(boxes[:, :3]))
        r_lim = [min(5.3, centers[:, 0].min()), max(67.0, centers[:, 0].max())]
        a_lim = [min(-40.6944, centers[:, 1].min()), max(40.6944, centers[:, 1].max())]
        jit = rng.uniform(0.0, 1.0, (3, len(boxes)))
        r_lo = np.clip(centers[:, 0] - cfg["box_range_jitter"], *r_lim)
        r_hi = np.clip(centers[:, 0] + cfg["box_range_jitter"], *r_lim)
        new_r = r_lo + jit[0] * (r_hi - r_lo)
        a_lo = np.clip(centers[:, 1] - cfg["box_rot_jitter"], *a_lim)
        a_hi = np.clip(centers[:, 1] + cfg["box_rot_jitter"], *a_lim)
        new_a = a_lo + jit[1] * (a_hi - a_lo)
        if cfg["yaw_type"] == "main" and len(existed_boxes):
            base_yaw = existed_boxes[
                rng.randint(0, len(existed_boxes), len(boxes)), 6]
        else:
            # keep the object's appearance-consistent yaw under azimuth shift
            base_yaw = boxes[:, 6] - np.deg2rad(new_a - centers[:, 1])
        new_yaw = base_yaw + (2 * jit[2] - 1) * cfg["box_yaw_jitter"]
        ori_yaw = boxes[:, 6:7].copy()
        boxes[:, :3] = np.asarray(common_coords.occ_uvd_to_absxyz(
            new_r, new_a, centers[:, 2], "cylinder"))
        boxes = np.concatenate([boxes, ori_yaw], axis=-1)
        boxes[:, 6] = new_yaw
        return boxes

    def remove_collide_boxes(self, sampled_boxes, existed_boxes):
        """Iteratively prune the worst mutual overlapper (reference
        `remove_collide_boxes`) after rejecting scene collisions."""
        if len(existed_boxes):
            iou1 = iou3d.boxes_bev_iou_cpu(sampled_boxes[:, :7], existed_boxes[:, :7])
            valid = (iou1.max(axis=1) == 0).nonzero()[0]
        else:
            valid = np.arange(len(sampled_boxes))
        iou2 = iou3d.boxes_bev_iou_cpu(sampled_boxes[:, :7], sampled_boxes[:, :7])
        iou2[range(len(sampled_boxes)), range(len(sampled_boxes))] = 0
        iou2 = iou2[valid][:, valid]
        while len(valid) and iou2.size and iou2.max() > 0:
            worst = int(np.argmax(iou2.sum(axis=1)))
            valid = np.delete(valid, worst)
            iou2 = np.delete(np.delete(iou2, worst, 0), worst, 1)
        return valid

    def remove_occ(self, points, bm_points, boxes, yz_expansion, drop_rate, rng):
        """First-surface filtering of pasted points on a spherical grid
        (reference `remove_occ`): pasted points behind any occupied voxel
        (raw scene + yz-expanded pasted footprint) are removed, then one
        point per voxel (lowest z), optional drop rate, and boxes keep
        >= 5 points or lose all of them. Returns (points, per-box mask)."""
        if yz_expansion > 1:
            sc = np.asarray(common_coords.absxyz_to_sphere(points[:, :3]))
            bsc = np.asarray(common_coords.absxyz_to_sphere(bm_points[:, :3]))
            cmin = np.concatenate([sc, bsc]).min(axis=0, keepdims=True)
            occ = np.floor_divide(sc - cmin, self._SPHERE_RES).astype(np.int32)
            bocc = np.floor_divide(bsc - cmin, self._SPHERE_RES).astype(np.int32)
            # yz-expand the pasted coords one step forward in range and
            # +-1 in azimuth/elevation (reference expand_voxel)
            y_ind = np.arange(-1, yz_expansion)
            z_ind = np.arange(-1, yz_expansion)
            yy, zz = np.meshgrid(y_ind, z_ind)
            shift = np.stack([np.ones_like(yy), yy, zz], -1).reshape(1, -1, 3)
            shift[0, shift.shape[1] // 2, 0] = 0
            exp = (bocc[:, None, :] + shift).reshape(-1, 3)
            allc = np.concatenate([occ, np.maximum(exp, 0)], axis=0)
            dims = allc.max(axis=0) + 1
            mask = np.zeros(dims, np.uint8)
            mask[allc[:, 0], allc[:, 1], allc[:, 2]] = 1
            first = np.cumsum(mask, axis=0) < 1.5
            keep = first[bocc[:, 0], bocc[:, 1], bocc[:, 2]]
            bm_points, bocc = bm_points[keep], bocc[keep]
            order = np.argsort(bm_points[:, 2], kind="stable")
            bm_points, bocc = bm_points[order], bocc[order]
            _, idx = np.unique(bocc, axis=0, return_index=True)
            bm_points = bm_points[idx]
        if drop_rate > 0 and len(bm_points):
            m = np.ones(len(bm_points), bool)
            m[: int(len(bm_points) * drop_rate)] = False
            rng.shuffle(m)
            bm_points = bm_points[m]
        inb = np.asarray(
            box_utils.points_in_boxes_mask_np(bm_points[:, :3], boxes[:, :7])
        ) if len(bm_points) else np.zeros((0, len(boxes)), bool)
        box_ok = inb.sum(axis=0) >= 5
        if box_ok.any():
            bm_points = bm_points[inb[:, box_ok].any(axis=1)]
        else:
            bm_points = np.zeros((0, bm_points.shape[1]), bm_points.dtype)
        return bm_points, box_ok

    def __call__(self, data_dict, rng=None):
        rng = rng or np.random
        gt_boxes = data_dict["gt_boxes"]
        gt_names = data_dict["gt_names"].astype(str)
        existed_boxes = gt_boxes
        total_dict, total_type = [], []
        total_img_idx, total_gt_idx, total_oriyaw = [], [], []
        for class_name, sample_group in self.sample_groups.items():
            if self.limit_whole_scene:
                num_gt = np.sum(class_name == gt_names)
                sample_group["sample_num"] = self.sample_class_num[class_name] - num_gt
            if sample_group["sample_num"] <= 0:
                continue
            sampled = self.sample_with_fixed_number(class_name, sample_group, rng)
            boxes = np.stack([x["box3d_lidar"] for x in sampled]).astype(np.float32)
            img_idx = np.array([x["image_idx"] for x in sampled])
            gt_idx = np.array([x["gt_idx"] for x in sampled])
            parts, types = [], []
            gt_num = 0
            if self.gt_smp_cfg and self.gt_smp_cfg["sample_groups"].get(class_name, 0) > 0:
                gt_num = min(self.gt_smp_cfg["sample_groups"][class_name], len(sampled))
                parts.append(self.add_box_jitter(
                    boxes[:gt_num], existed_boxes, self.gt_smp_cfg, rng))
                types.append(np.ones(gt_num))
            bm_num = len(sampled) - gt_num
            if self.mlt_bm_cfg and bm_num > 0:
                parts.append(self.add_box_jitter(
                    boxes[len(boxes) - bm_num:], existed_boxes, self.mlt_bm_cfg, rng))
                types.append(np.zeros(bm_num))
            if not parts:
                continue
            boxes = np.concatenate(parts)
            btypes = np.concatenate(types)
            valid = self.remove_collide_boxes(boxes, existed_boxes)
            boxes, btypes = boxes[valid], btypes[valid]
            img_idx, gt_idx = img_idx[valid], gt_idx[valid]
            sampled = [sampled[i] for i in valid]
            if self.no_stucking and len(boxes):
                det = boxes[:, :7].copy()
                det[:, 2] += self.det_height_shift
                inb = np.asarray(box_utils.points_in_boxes_mask_np(
                    data_dict["points"][:, :3], det))
                clean = (inb.sum(axis=0) == 0).nonzero()[0]
                boxes, btypes = boxes[clean], btypes[clean]
                img_idx, gt_idx = img_idx[clean], gt_idx[clean]
                sampled = [sampled[i] for i in clean]
            existed_boxes = np.concatenate([existed_boxes, boxes[:, :7]]) \
                if len(existed_boxes) else boxes[:, :7]
            total_dict.extend(sampled)
            total_type.append(btypes)
            total_img_idx.append(img_idx)
            total_gt_idx.append(gt_idx)
            total_oriyaw.append(boxes[:, 7:8])
        if total_dict:
            data_dict = self._paste(
                data_dict,
                existed_boxes[len(gt_boxes):, :7],
                np.concatenate(total_oriyaw),
                total_dict,
                np.concatenate(total_img_idx),
                np.concatenate(total_gt_idx),
                np.concatenate(total_type),
                rng,
            )
            data_dict["pre_aug_bm"] = True
        data_dict.pop("gt_boxes_mask", None)
        return data_dict

    def _paste(self, data_dict, sampled_boxes, ori_yaw, infos, img_idx,
               gt_idx, btypes, rng):
        """reference `add_sampled_boxes_best_match_points_to_scene`."""
        root = self.root_path
        mask = data_dict.get("gt_boxes_mask")
        gt_boxes = data_dict["gt_boxes"]
        gt_names = data_dict["gt_names"]
        if mask is not None:
            gt_boxes, gt_names = gt_boxes[mask], gt_names[mask]
            if "gt_boxes_inds" in data_dict:
                data_dict["gt_boxes_inds"] = data_dict["gt_boxes_inds"][mask]
        points = data_dict["points"]
        if self.sampler_cfg.get("USE_ROAD_PLANE", False) and "road_plane" in data_dict:
            sampled_boxes, _ = self.put_boxes_on_road_planes(
                sampled_boxes.copy(), data_dict["road_plane"], data_dict["calib"])

        smp_pts, smp_bm, bm_only = [], [], []
        for i, info in enumerate(infos):
            obj = np.fromfile(str(root / info["path"]), np.float32).reshape(
                -1, self.num_point_features).copy()
            with open(self.mlt_bm_root / f"{int(img_idx[i])}_{int(gt_idx[i])}.pkl",
                      "rb") as f:
                bm = pickle.load(f)
            bm = np.asarray(bm, np.float32).reshape(-1, self.bm_num_point_features)[:, :3]
            box = sampled_boxes[i]
            c, s = np.cos(box[6]), np.sin(box[6])
            bm_w = np.stack([bm[:, 0] * c - bm[:, 1] * s + box[0],
                             bm[:, 0] * s + bm[:, 1] * c + box[1],
                             bm[:, 2] + box[2]], axis=1)
            if btypes[i] > 0:
                # real points re-rotated by the jittered yaw delta
                dy = box[6] - float(ori_yaw[i, 0])
                cd, sd = np.cos(dy), np.sin(dy)
                xy = obj[:, :2].copy()
                obj[:, 0] = xy[:, 0] * cd - xy[:, 1] * sd + box[0]
                obj[:, 1] = xy[:, 0] * sd + xy[:, 1] * cd + box[1]
                obj[:, 2] += box[2]
                smp_pts.append(obj)
                smp_bm.append(bm_w)
            else:
                avg = (np.mean(obj[:, 3:], axis=0, keepdims=True)
                       if len(obj) else np.zeros((1, obj.shape[1] - 3)))
                bm_only.append(np.concatenate(
                    [bm_w, np.tile(avg, (len(bm_w), 1))], axis=-1))

        if not self.no_stucking and len(sampled_boxes):
            big = box_utils.enlarge_box3d_np(
                sampled_boxes[:, :7],
                extra_width=self.sampler_cfg.get("REMOVE_EXTRA_WIDTH", [0, 0, 0]))
            inb = np.asarray(box_utils.points_in_boxes_mask_np(points[:, :3], big))
            points = points[~inb.any(axis=1)]

        final_bm, keep_rows = [], []
        smp_rows = (btypes > 0).nonzero()[0]
        bm_rows = (btypes == 0).nonzero()[0]
        if smp_pts:
            pts = np.concatenate(smp_pts)
            if self.gt_smp_cfg["remove_yz_expansion"] > 0:
                pts, ok = self.remove_occ(
                    points, pts, sampled_boxes[smp_rows],
                    self.gt_smp_cfg["remove_yz_expansion"],
                    self.gt_smp_cfg["dp_rate"], rng)
                smp_rows = smp_rows[ok]
                final_bm.extend([smp_bm[i] for i in range(len(smp_bm)) if ok[i]])
            else:
                final_bm.extend(smp_bm)
            points = np.concatenate([points, pts])
            keep_rows.extend(smp_rows.tolist())
        if bm_only:
            pts = np.concatenate(bm_only)
            if self.mlt_bm_cfg["remove_yz_expansion"] > 0:
                pts, ok = self.remove_occ(
                    points, pts, sampled_boxes[bm_rows],
                    self.mlt_bm_cfg["remove_yz_expansion"],
                    self.mlt_bm_cfg["dp_rate"], rng)
                bm_rows = bm_rows[ok]
                final_bm.extend([bm_only[i][:, :3] for i in range(len(bm_only)) if ok[i]])
            else:
                final_bm.extend([b[:, :3] for b in bm_only])
            # bm-only pastes add their (feature-padded) bm points to the cloud
            pad = points.shape[1] - pts.shape[1]
            if pad > 0:
                pts = np.concatenate([pts, np.zeros((len(pts), pad), pts.dtype)], 1)
            points = np.concatenate([points, pts[:, :points.shape[1]]])
            keep_rows.extend(bm_rows.tolist())

        if final_bm:
            keep_rows = np.array(keep_rows, int)
            names = np.array([infos[i]["name"] for i in keep_rows])
            data_dict["bm_points"] = [b[:, :3] for b in final_bm]
            data_dict["gt_boxes"] = np.concatenate(
                [gt_boxes, sampled_boxes[keep_rows, :7]]) if len(gt_boxes) \
                else sampled_boxes[keep_rows, :7]
            data_dict["gt_names"] = np.concatenate([gt_names, names]) \
                if len(gt_names) else names
            data_dict["points"] = points
            data_dict["augment_box_num"] = len(names)
            data_dict["aug_boxes_image_idx"] = img_idx[keep_rows]
            data_dict["aug_boxes_gt_idx"] = gt_idx[keep_rows]
        else:
            data_dict["gt_boxes"], data_dict["gt_names"] = gt_boxes, gt_names
        return data_dict


class DataAugmentor:
    def __init__(self, root_path, augmentor_configs, class_names, logger=None):
        self.root_path = root_path
        self.class_names = class_names
        self.logger = logger
        self.queue = []
        disable = augmentor_configs.get("DISABLE_AUG_LIST", [])
        for cfg in augmentor_configs.AUG_CONFIG_LIST:
            if cfg.NAME in disable:
                continue
            self.queue.append((cfg.NAME, self._build(cfg)))

    def _build(self, cfg):
        name = cfg.NAME
        if name == "gt_sampling":
            return DataBaseSampler(self.root_path, cfg, self.class_names, self.logger)
        if name == "sup_gt_sampling":
            return SupGTSampling(self.root_path, cfg, self.class_names, self.logger)
        if name == "add_multi_best_match":
            return MltBestMatchQuerier(self.root_path, cfg, self.class_names, self.logger)
        if name == "add_best_match":
            return BestMatchQuerier(self.root_path, cfg, self.class_names, self.logger)
        if name in ("random_world_flip", "random_world_rotation", "random_world_scaling"):
            return cfg  # handled inline in forward
        raise NotImplementedError(name)

    def forward(self, data_dict, rng=None):
        rng = rng or np.random
        # original gt indices, in the post-DontCare pre-class-filter space
        # the bm pkl files are keyed by (reference `data_augmentor.py:182`)
        if "gt_boxes_mask" in data_dict:
            data_dict["gt_boxes_inds"] = np.arange(len(data_dict["gt_boxes_mask"]))
        elif "gt_boxes" in data_dict:
            data_dict["gt_boxes_inds"] = np.arange(len(data_dict["gt_boxes"]))
        for name, handler in self.queue:
            if name in ("gt_sampling", "sup_gt_sampling",
                        "add_multi_best_match", "add_best_match"):
                data_dict = handler(data_dict, rng=rng)
                continue
            cfg = handler
            # bm_points may still be a per-box list (SupGTSampling output);
            # world transforms need one array
            if isinstance(data_dict.get("bm_points"), list):
                lst = data_dict["bm_points"]
                data_dict["bm_points"] = (
                    np.concatenate(lst, axis=0).astype(np.float32)
                    if lst else np.zeros((0, 3), np.float32))
            specials = [
                data_dict[k] for k in SPECIAL_NAMES if k in data_dict and len(data_dict[k])
            ]
            if name == "random_world_flip":
                gt, pts, specials = random_flip_along_x(
                    data_dict["gt_boxes"], data_dict["points"], specials, rng=rng
                )
                data_dict["gt_boxes"], data_dict["points"] = gt, pts
            elif name == "random_world_scaling":
                gt, pts, specials = global_scaling(
                    data_dict["gt_boxes"], data_dict["points"],
                    cfg.WORLD_SCALE_RANGE, specials, rng=rng,
                )
                data_dict["gt_boxes"], data_dict["points"] = gt, pts
            elif name == "random_world_rotation":
                pre_rot_points = data_dict["points"].copy()
                gt, pts, noise_rot, specials = global_rotation(
                    data_dict["gt_boxes"], data_dict["points"],
                    cfg.WORLD_ROT_ANGLE, specials, rng=rng,
                )
                data_dict["gt_boxes"], data_dict["points"] = gt, pts
                if cfg.get("SAVE_PRE_ROT", False):
                    data_dict["pre_rot_points"] = pre_rot_points
                    data_dict["rot_z"] = noise_rot * 180.0 / np.pi
        data_dict["gt_boxes"][:, 6] = common.limit_period_np(
            data_dict["gt_boxes"][:, 6], offset=0.5, period=2 * np.pi
        )
        data_dict.pop("gt_boxes_inds", None)
        # SupGTSampling leaves bm_points as a per-box list when no bm
        # querier follows it in the queue; downstream wants one array
        if isinstance(data_dict.get("bm_points"), list):
            lst = data_dict["bm_points"]
            data_dict["bm_points"] = (
                np.concatenate(lst, axis=0).astype(np.float32)
                if lst else np.zeros((0, 3), np.float32))
        return data_dict
