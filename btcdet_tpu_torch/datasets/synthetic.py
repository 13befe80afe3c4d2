"""Synthetic KITTI-like batches (counterpart of
`btcdet_tpu/datasets/synthetic.py`), voxelized by the host voxelizer of
the KITTI pipeline (`ops.voxelizer.voxelize_np`).

The numpy generator reproduces the JAX package's batch bit for bit for
the same seed and config; `make_synthetic_batch` then moves it onto the
run's device as torch tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.voxelizer import voxelize_np
from ..utils import coords as coords_utils
from ..utils.common import resolve_device

# best-match point slots of a frame (the JAX generator's default)
BM_POINTS = 2048


def _plant_boxes(rng, n, point_range):
    lo = np.asarray(point_range[:3])
    hi = np.asarray(point_range[3:6])
    ctr = rng.uniform(lo + 3, np.maximum(lo + 3.5, hi - 3), size=(n, 3))
    ctr[:, 2] = rng.uniform(-1.2, -0.6, size=n)
    dims = np.stack([
        rng.uniform(3.4, 4.4, n), rng.uniform(1.5, 1.8, n), rng.uniform(1.4, 1.7, n)
    ], axis=1)
    yaw = rng.uniform(-np.pi, np.pi, size=n)
    return np.concatenate([ctr, dims, yaw[:, None]], axis=1).astype(np.float32)


def _raycast_cloud(rng, boxes, pcr, num_points):
    """HDL-64-like LiDAR scan of a ground plane, random walls and the
    planted boxes (ring-structured like real scans, with self-occlusion).
    Returns (points (N, 4) float32, per-box hit points)."""
    n_elev = 64
    elev = np.radians(np.linspace(2.0, -24.9, n_elev))
    n_az = max(int(np.ceil(num_points * 1.35 / n_elev)), 64)
    azim = np.radians(np.linspace(-47.0, 47.0, n_az))
    E, A = np.meshgrid(elev, azim, indexing="ij")
    ce, se = np.cos(E.ravel()), np.sin(E.ravel())
    ca, sa = np.cos(A.ravel()), np.sin(A.ravel())
    dirs = np.stack([ce * ca, ce * sa, se], axis=1)
    M = dirs.shape[0]

    t_hit = np.full(M, np.inf)
    hit_box = np.full(M, -1, np.int32)  # >=0: box index, -2: wall, -3: ground

    dz = dirs[:, 2]
    with np.errstate(divide="ignore"):
        t_g = np.where(dz < -1e-6, -1.73 / dz, np.inf)
    upd = t_g < t_hit
    t_hit, hit_box = np.where(upd, t_g, t_hit), np.where(upd, -3, hit_box)

    for _ in range(5):
        r0 = rng.uniform(12, 55)
        a0 = rng.uniform(-0.7, 0.7)
        cx, cy = r0 * np.cos(a0), r0 * np.sin(a0)
        ang = rng.uniform(0, np.pi)
        half_len = rng.uniform(4, 12)
        z_top = rng.uniform(0.5, 3.0)
        nx_, ny_ = -np.sin(ang), np.cos(ang)
        denom = dirs[:, 0] * nx_ + dirs[:, 1] * ny_
        with np.errstate(divide="ignore", invalid="ignore"):
            t_w = (cx * nx_ + cy * ny_) / denom
        px = dirs[:, 0] * t_w - cx
        py = dirs[:, 1] * t_w - cy
        u = px * np.cos(ang) + py * np.sin(ang)
        pz = dirs[:, 2] * t_w
        ok = (
            (np.abs(denom) > 1e-6) & (t_w > 2.0)
            & (np.abs(u) < half_len) & (pz > -1.73) & (pz < z_top)
        )
        upd = ok & (t_w < t_hit)
        t_hit, hit_box = np.where(upd, t_w, t_hit), np.where(upd, -2, hit_box)

    for bi, box in enumerate(boxes):
        c, s = np.cos(box[6]), np.sin(box[6])
        ox, oy, oz = -box[0], -box[1], -box[2]
        lox = ox * c + oy * s
        loy = -ox * s + oy * c
        ldx = dirs[:, 0] * c + dirs[:, 1] * s
        ldy = -dirs[:, 0] * s + dirs[:, 1] * c
        ldz = dirs[:, 2]
        t0 = np.full(M, 2.0)
        t1 = np.full(M, 80.0)
        ok = np.ones(M, bool)
        for lo_, ld_, half in (
            (lox, ldx, box[3] / 2), (loy, ldy, box[4] / 2), (oz, ldz, box[5] / 2),
        ):
            nz_ = np.abs(ld_) > 1e-8
            safe = np.where(nz_, ld_, 1.0)
            near = np.where(nz_, (-half - lo_) / safe, -np.inf)
            far = np.where(nz_, (half - lo_) / safe, np.inf)
            lo_t = np.minimum(near, far)
            hi_t = np.maximum(near, far)
            inside = np.abs(lo_) <= half
            lo_t = np.where(nz_, lo_t, np.where(inside, -np.inf, np.inf))
            hi_t = np.where(nz_, hi_t, np.where(inside, np.inf, -np.inf))
            t0 = np.maximum(t0, lo_t)
            t1 = np.minimum(t1, hi_t)
        ok &= t0 <= t1
        upd = ok & (t0 < t_hit)
        t_hit = np.where(upd, t0, t_hit)
        hit_box = np.where(upd, bi, hit_box)

    keep = np.isfinite(t_hit) & (t_hit > 2.0) & (t_hit < 75.0)
    t = t_hit[keep] + rng.randn(int(keep.sum())) * 0.015
    pts3 = dirs[keep] * t[:, None]
    which = hit_box[keep]
    inten = np.where(
        which >= 0, rng.uniform(0.3, 0.9, len(t)), rng.uniform(0.05, 0.5, len(t))
    )
    pts = np.concatenate([pts3, inten[:, None]], axis=1).astype(np.float32)
    per_box = [pts3[which == bi].astype(np.float32) for bi in range(len(boxes))]
    return pts, per_box


def make_synthetic_batch_np(data_cfg, batch_size: int = 2, num_points: int = 16384,
                            num_gt: int = 10, seed: int = 0, mode: str = "train"):
    """Numpy batch dict shaped like the real pipeline output. With
    `DATA_CONFIG.OCC` and a sphere-voxel processor it also holds the
    occupancy keys (`occ_voxels` / `occ_voxel_coords` /
    `occ_voxel_num_points` from cylinder voxelization of the same points,
    `rot_z`, `use_occ_prob`, `bm_points` / `bm_points_mask`) and the det
    voxel keys under `det_*`."""
    rng = np.random.RandomState(seed)
    pcr = np.asarray(data_cfg.POINT_CLOUD_RANGE, np.float64)
    det_cfg = occ_cfg = None
    for proc in data_cfg.DATA_PROCESSOR:
        if proc.NAME in ("det_transform_points_to_voxels", "transform_points_to_voxels"):
            det_cfg = proc
        if proc.NAME == "transform_points_to_sphere_voxels":
            occ_cfg = proc
    assert det_cfg is not None, "no det voxelization in DATA_PROCESSOR"
    use_occ = data_cfg.get("OCC") is not None and occ_cfg is not None
    det_max_vox = int(det_cfg.MAX_NUMBER_OF_VOXELS[mode])
    occ_max_vox = int(occ_cfg.MAX_NUMBER_OF_VOXELS[mode]) if use_occ else 0

    pts_list, det_v, det_c, det_n, gt_list, mirr_list = [], [], [], [], [], []
    occ_v, occ_c, occ_n, bm_list, bm_mask_list = [], [], [], [], []
    for b in range(batch_size):
        boxes = _plant_boxes(rng, num_gt, pcr)
        pts, box_pts = _raycast_cloud(rng, boxes, pcr, num_points)
        inside = np.all(
            (pts[:, :3] >= pcr[:3] + 1e-3) & (pts[:, :3] <= pcr[3:6] - 1e-3), axis=1
        )
        pts = pts[inside]
        if len(pts) >= num_points:
            sel = rng.choice(len(pts), num_points, replace=False)
            pts = pts[sel]
        else:
            pts = np.concatenate([pts, np.zeros((num_points - len(pts), 4), np.float32)])
        pts_list.append(pts)

        v, c, n = voxelize_np(
            pts, pcr, det_cfg.VOXEL_SIZE, int(det_cfg.MAX_POINTS_PER_VOXEL), det_max_vox
        )
        det_v.append(v)
        det_c.append(np.concatenate([np.where(c[:, :1] >= 0, b, -1), c], axis=1))
        det_n.append(n)

        gt = np.zeros((max(num_gt, 1), 8), np.float32)
        gt[:num_gt, :7] = boxes
        gt[:num_gt, 7] = 1  # class Car
        gt_list.append(gt)
        mirr_list.append((gt[:, 7] > 0).astype(np.float32))

        if use_occ:
            occ_pcr = np.asarray(data_cfg.OCC.POINT_CLOUD_RANGE, np.float64)
            vo, co, no = voxelize_np(
                np.asarray(coords_utils.absxyz_to_cylinder(pts)), occ_pcr,
                data_cfg.OCC.VOXEL_SIZE, int(occ_cfg.MAX_POINTS_PER_VOXEL), occ_max_vox,
            )
            occ_v.append(vo)
            occ_c.append(np.concatenate([np.where(co[:, :1] >= 0, b, -1), co], axis=1))
            occ_n.append(no)
            # best-match points: the planted boxes' surface hits stand in
            # for the offline best-match shapes
            obj_pts = [p for p in box_pts if len(p)]
            allobj = np.concatenate(obj_pts, axis=0)[:, :3] if obj_pts else np.zeros((0, 3))
            k = min(len(allobj), BM_POINTS)
            bm = np.zeros((BM_POINTS, 3), np.float32)
            bm_m = np.zeros((BM_POINTS,), bool)
            bm[:k] = allobj[:k]
            bm_m[:k] = True
            bm_list.append(bm)
            bm_mask_list.append(bm_m)

    batch = {}
    batch["points"] = np.stack(pts_list)
    batch["points_mask"] = np.abs(batch["points"][..., :3]).sum(-1) > 0
    pre = "det_" if use_occ else ""
    batch[pre + "voxels"] = np.concatenate(det_v)
    batch[pre + "voxel_coords"] = np.concatenate(det_c)
    batch[pre + "voxel_num_points"] = np.concatenate(det_n)
    batch["gt_boxes"] = np.stack(gt_list)
    batch["box_mirr_flag"] = np.stack(mirr_list)
    if use_occ:
        batch["occ_voxels"] = np.concatenate(occ_v)
        batch["occ_voxel_coords"] = np.concatenate(occ_c)
        batch["occ_voxel_num_points"] = np.concatenate(occ_n)
        batch["rot_z"] = np.zeros((batch_size,), np.float32)
        batch["use_occ_prob"] = np.ones((batch_size,), bool)
        batch["bm_points"] = np.stack(bm_list)
        batch["bm_points_mask"] = np.stack(bm_mask_list)
    return batch


def make_synthetic_batch(data_cfg, batch_size: int = 2, num_points: int = 16384,
                         num_gt: int = 10, seed: int = 0, mode: str = "train",
                         device=None):
    """`make_synthetic_batch_np` as torch tensors on `device` (CUDA
    unless the caller passes another)."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in make_synthetic_batch_np(
                data_cfg, batch_size, num_points, num_gt, seed, mode).items()}
