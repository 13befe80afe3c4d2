"""The benchmark's traffic: synthetic KITTI-shaped frames in plain numpy.

A frozen copy of the port's synthetic batch generator (an HDL-64-like
ray cast of a ground plane, random walls and the planted gt boxes) and
of the numpy voxelizer it feeds, so that no later change to the port can
move the benchmark's inputs. With a gt mix of cars only, the frames
equal the port's `make_synthetic_batch_np` bit for bit
(`tests/test_bench_traffic.py` holds them to a stored digest).

A traffic file (`traffic/<name>.json`) holds the parameters one general
generator reads:

    kind         "eval" (forward + post-processing) or "train"
    batch_size   frames a batch
    pool         distinct batches made from the seed, cycled by the window
    num_points   points a frame
    gt           {class name: boxes a frame}; classes other than Car take
                 their anchor sizes from the configuration
    mode         "test" or "train": which voxel caps of the configuration
    scene_seed   the frames come from this seed in every run; the run's seed
                 deals them into the pool's batches
    weight_seed  the weights come from this seed in every run
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

TRAFFIC_DIR = Path(__file__).resolve().parent
# best-match point slots of a frame
BM_POINTS = 2048
# ground height of the ray cast (lidar frame)
GROUND_Z = -1.73


def load_traffic(name: str) -> dict:
    return json.loads((TRAFFIC_DIR / f"{name}.json").read_text())


def frame_seed(seed: int, index: int) -> int:
    """The numpy seed of pool batch `index` of run seed `seed` (any whole
    number; large ones are folded into 32 bits)."""
    return int(np.random.SeedSequence([int(seed) % (1 << 63), int(index)]).generate_state(1)[0])


def compute_grid_size(point_cloud_range, voxel_size) -> tuple[int, int, int]:
    pr = np.asarray(point_cloud_range, dtype=np.float64)
    vs = np.asarray(voxel_size, dtype=np.float64)
    grid = np.round((pr[3:6] - pr[0:3]) / vs).astype(np.int64)
    return int(grid[0]), int(grid[1]), int(grid[2])


def voxelize(points, point_cloud_range, voxel_size, max_points: int, max_voxels: int):
    """Points (N, C) -> (voxels (max_voxels, max_points, C), coords
    (max_voxels, 3) int32 zyx with -1 padding, num_points (max_voxels,)
    int32): voxels in key order up to `max_voxels`, points within a voxel
    in point order up to `max_points`."""
    points = np.asarray(points)
    nx, ny, nz = compute_grid_size(point_cloud_range, voxel_size)
    lo = np.asarray(point_cloud_range[:3], dtype=points.dtype)
    vs = np.asarray(voxel_size, dtype=points.dtype)
    cxyz = np.floor((points[:, :3] - lo) / vs).astype(np.int64)
    in_range = ((cxyz[:, 0] >= 0) & (cxyz[:, 0] < nx) & (cxyz[:, 1] >= 0) & (cxyz[:, 1] < ny)
                & (cxyz[:, 2] >= 0) & (cxyz[:, 2] < nz))
    pts = points[in_range]
    cxyz = cxyz[in_range]
    key = (cxyz[:, 2] * ny + cxyz[:, 1]) * nx + cxyz[:, 0]
    order = np.argsort(key, kind="stable")
    skey, spts = key[order], pts[order]
    ukeys, inv, counts = np.unique(skey, return_inverse=True, return_counts=True)
    n_vox = min(len(ukeys), max_voxels)
    voxels = np.zeros((max_voxels, max_points, points.shape[1]), dtype=points.dtype)
    coords = np.full((max_voxels, 3), -1, dtype=np.int32)
    num_points = np.zeros((max_voxels,), dtype=np.int32)
    seg_start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(len(skey)) - seg_start[inv]
    keep = (inv < max_voxels) & (slot < max_points)
    voxels[inv[keep], slot[keep]] = spts[keep]
    np.add.at(num_points, inv[keep], 1)
    uk = ukeys[:n_vox]
    coords[:n_vox, 0] = uk // (ny * nx)
    coords[:n_vox, 1] = (uk % (ny * nx)) // nx
    coords[:n_vox, 2] = uk % nx
    return voxels, coords, num_points


def absxyz_to_cylinder(points):
    """(N, 3+C) cartesian -> (N, 3+C) cylinder (xydist, azi_deg, z)."""
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    out = np.stack([np.sqrt(x * x + y * y), np.arctan2(-y, x) * (180.0 / np.pi), z], axis=-1)
    return np.concatenate([out, points[..., 3:]], axis=-1)


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


def _resize_classes(rng, boxes, labels, anchor_sizes):
    """Boxes of classes other than Car (label > 1) take their class's
    anchor size, each side scaled by U(0.9, 1.1), standing on the ground."""
    for i in np.nonzero(labels > 1)[0]:
        size = np.asarray(anchor_sizes[int(labels[i]) - 1], np.float64)
        dims = size * rng.uniform(0.9, 1.1, 3)
        boxes[i, 3:6] = dims
        boxes[i, 2] = GROUND_Z + dims[2] / 2
    return boxes


def _raycast_cloud(rng, boxes, pcr, num_points):
    """HDL-64-like LiDAR scan of a ground plane, random walls and the
    planted boxes (ring-structured, with self-occlusion). Returns (points
    (N, 4) float32, per-box hit points)."""
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


def _gt_labels(cfg, gt: dict) -> np.ndarray:
    """(num_gt,) 1-based class labels of the traffic's gt mix, in the
    configuration's class order."""
    names = list(cfg["CLASS_NAMES"])
    labels = []
    for name, n in gt.items():
        labels += [names.index(name) + 1] * int(n)
    return np.asarray(labels, np.float32)


def _anchor_sizes(cfg) -> list:
    return [a["anchor_sizes"][0]
            for a in cfg["MODEL"]["DENSE_HEAD"]["ANCHOR_GENERATOR_CONFIG"]]


def make_batch(cfg, batch_size: int, num_points: int, gt: dict, seed: int, mode: str) -> dict:
    """A numpy batch dict shaped like the port's data pipeline output:
    points, the det voxel table (under `det_*` with the occupancy subnet),
    the occupancy voxel table of the same points (cylinder voxelization),
    gt boxes, and the occupancy subnet's side inputs."""
    data_cfg = cfg["DATA_CONFIG"]
    labels = _gt_labels(cfg, gt)
    num_gt = len(labels)
    rng = np.random.RandomState(seed)
    pcr = np.asarray(data_cfg["POINT_CLOUD_RANGE"], np.float64)
    det_cfg = occ_cfg = None
    for proc in data_cfg["DATA_PROCESSOR"]:
        if proc["NAME"] in ("det_transform_points_to_voxels", "transform_points_to_voxels"):
            det_cfg = proc
        if proc["NAME"] == "transform_points_to_sphere_voxels":
            occ_cfg = proc
    assert det_cfg is not None, "no det voxelization in DATA_PROCESSOR"
    use_occ = data_cfg.get("OCC") is not None and occ_cfg is not None
    det_max_vox = int(det_cfg["MAX_NUMBER_OF_VOXELS"][mode])
    occ_max_vox = int(occ_cfg["MAX_NUMBER_OF_VOXELS"][mode]) if use_occ else 0
    sizes = _anchor_sizes(cfg)

    pts_list, det_v, det_c, det_n, gt_list, mirr_list = [], [], [], [], [], []
    occ_v, occ_c, occ_n, bm_list, bm_mask_list = [], [], [], [], []
    for b in range(batch_size):
        boxes = _plant_boxes(rng, num_gt, pcr)
        if (labels > 1).any():
            boxes = _resize_classes(rng, boxes, labels, sizes)
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

        v, c, n = voxelize(pts, pcr, det_cfg["VOXEL_SIZE"], int(det_cfg["MAX_POINTS_PER_VOXEL"]),
                           det_max_vox)
        det_v.append(v)
        det_c.append(np.concatenate([np.where(c[:, :1] >= 0, b, -1), c], axis=1))
        det_n.append(n)

        g = np.zeros((max(num_gt, 1), 8), np.float32)
        g[:num_gt, :7] = boxes
        g[:num_gt, 7] = labels
        gt_list.append(g)
        mirr_list.append((g[:, 7] > 0).astype(np.float32))

        if use_occ:
            occ = data_cfg["OCC"]
            vo, co, no = voxelize(absxyz_to_cylinder(pts), np.asarray(occ["POINT_CLOUD_RANGE"],
                                                                      np.float64),
                                  occ["VOXEL_SIZE"], int(occ_cfg["MAX_POINTS_PER_VOXEL"]),
                                  occ_max_vox)
            occ_v.append(vo)
            occ_c.append(np.concatenate([np.where(co[:, :1] >= 0, b, -1), co], axis=1))
            occ_n.append(no)
            # the planted boxes' surface hits stand in for the best-match shapes
            obj_pts = [p for p in box_pts if len(p)]
            allobj = np.concatenate(obj_pts, axis=0)[:, :3] if obj_pts else np.zeros((0, 3))
            k = min(len(allobj), BM_POINTS)
            bm = np.zeros((BM_POINTS, 3), np.float32)
            bm_m = np.zeros((BM_POINTS,), bool)
            bm[:k] = allobj[:k]
            bm_m[:k] = True
            bm_list.append(bm)
            bm_mask_list.append(bm_m)

    batch = {"points": np.stack(pts_list)}
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


# per-frame keys of a batch: stacked on a leading frame axis, or voxel
# tables of a fixed number of rows a frame whose coords lead with the frame
_STACKED = ("points", "points_mask", "gt_boxes", "box_mirr_flag", "rot_z", "use_occ_prob",
            "bm_points", "bm_points_mask")
_TABLES = (("det_voxels", "det_voxel_coords", "det_voxel_num_points"),
           ("voxels", "voxel_coords", "voxel_num_points"),
           ("occ_voxels", "occ_voxel_coords", "occ_voxel_num_points"))


def split_frames(batch: dict, batch_size: int) -> list:
    """The batch's frames, each a batch of one."""
    frames = [{} for _ in range(batch_size)]
    for k in _STACKED:
        if k in batch:
            for f in range(batch_size):
                frames[f][k] = batch[k][f:f + 1]
    for keys in _TABLES:
        if keys[0] not in batch:
            continue
        rows = batch[keys[0]].shape[0] // batch_size
        for f in range(batch_size):
            for k in keys:
                frames[f][k] = batch[k][f * rows:(f + 1) * rows].copy()
            c = frames[f][keys[1]]
            c[:, 0] = np.where(c[:, 0] >= 0, 0, -1)
    return frames


def collate(frames: list) -> dict:
    """Frames (batches of one) as one batch, frame f at index f."""
    batch = {k: np.concatenate([fr[k] for fr in frames]) for k in frames[0]}
    for keys in _TABLES:
        if keys[0] in batch:
            rows = frames[0][keys[0]].shape[0]
            c = batch[keys[1]]
            b = np.repeat(np.arange(len(frames)), rows)
            c[:, 0] = np.where(c[:, 0] >= 0, b, -1)
    return batch


def seed_of(traffic: dict, key: str, seed: int) -> int:
    """The traffic's `key` seed: its number, or the run's seed where the
    traffic says "run"."""
    v = traffic[key]
    return int(seed) if v == "run" else int(v)


def make_pool(cfg, traffic: dict, seed: int) -> list:
    """The traffic's pool of batches for run seed `seed`: its frames made
    from the traffic's `scene_seed` (the run's seed where that says "run"),
    dealt into the pool's batches in an order drawn from the run's seed."""
    B, P = int(traffic["batch_size"]), int(traffic["pool"])
    batches = [make_batch(cfg, B, int(traffic["num_points"]), traffic["gt"],
                          frame_seed(seed_of(traffic, "scene_seed", seed), i), traffic["mode"])
               for i in range(P)]
    frames = [f for b in batches for f in split_frames(b, B)]
    order = np.random.RandomState(frame_seed(seed, P)).permutation(len(frames))
    return [collate([frames[j] for j in order[i * B:(i + 1) * B]]) for i in range(P)]


def digest(batch: dict) -> str:
    """sha256 over the batch's arrays in key order."""
    import hashlib

    h = hashlib.sha256()
    for k in sorted(batch):
        v = np.ascontiguousarray(batch[k])
        h.update(k.encode())
        h.update(str(v.dtype).encode())
        h.update(str(v.shape).encode())
        h.update(v.tobytes())
    return h.hexdigest()
