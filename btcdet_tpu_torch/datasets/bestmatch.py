"""Offline "best-match" approximate-complete-shape generation (counterpart
of `btcdet_tpu/datasets/bestmatch.py`, reference
`btcdet/datasets/multifindbestfit.py`) -- the supervision source for the
occupancy network.

Per class, every gt object's point cloud is canonicalized (rotated to
yaw 0 around the box center, bottom 15 cm dropped) and mirrored across
the box's y axis; then each object greedily borrows points from its
highest-IoU (dims-only) neighbors in the dataset to approximate the
complete shape. The greedy heuristic and all constants follow the
reference (`find_multi_best_match_boxpnts:358`, heuristic at `:387`;
class constants at `__main__:455-493`):

  heuristic = max_chamfer(own -> candidate)
            + ex_coords_ratio / extra_bev_coords
            + 2.0 * [iou < iou_thresh] + 1.0 * [extra_coords < 30]

Outputs `bm_<ratio>maxdist_<n>num_<cls>/<image>_<gt>.pkl` files consumed
by the `add_multi_best_match` augmentor.

Run: python -m btcdet_tpu_torch.datasets.bestmatch <data_path> (after
`python -m btcdet_tpu_torch.datasets.kitti.kitti_infos <data_path>`);
`--inspect` summarises a written database.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

CLASS_PARAMS = {
    # (apply_mirror, PNT_THRESH, ex_coords_ratio, max_num_bm, nearest_dist,
    #  iou_thresh, num_extra_coords)
    "Car": (True, 80, 50, 2, 0.10, 0.90, 2000),
    "Cyclist": (True, 5, 5, 1, 0.05, 0.90, 2000),
    "Pedestrian": (False, 5, 5, 1, 0.05, 0.90, 2000),
}
VOXEL_SIZE = np.array([0.16, 0.16, 0.16])
TOP_K = 800


def nn_dist(query, ref):
    """For each query point, distance to the nearest ref point."""
    if len(ref) == 0:
        return np.full(len(query), np.inf)
    from scipy.spatial import cKDTree

    return cKDTree(ref).query(query, k=1)[0]


def rotate_to_canonical(points, yaw):
    c, s = np.cos(-yaw), np.sin(-yaw)
    out = points.copy()
    out[:, 0] = points[:, 0] * c - points[:, 1] * s
    out[:, 1] = points[:, 0] * s + points[:, 1] * c
    return out


def canonical_cloud(bin_path, gt_box, bottom: float = 0.15, num_features: int = 4):
    pts = np.fromfile(str(bin_path), dtype=np.float32).reshape(-1, num_features)
    xyz = rotate_to_canonical(pts[:, :3], gt_box[6])
    zthresh = -gt_box[5] / 2 + bottom
    return xyz[xyz[:, 2] > zthresh]


def mirror_cloud(pts, nearest_dist: float = 0.05):
    """Append the y-reflection, deduping near-coincident points."""
    if len(pts) == 0:
        return pts
    m = pts * np.array([1.0, -1.0, 1.0])
    keep = nn_dist(m, pts) > nearest_dist
    return np.concatenate([pts, m[keep]], axis=0)


def dims_iou(dims):
    """All-pairs 3D IoU of origin-centered yaw-0 boxes: closed form."""
    d = np.asarray(dims)  # (M, 3)
    inter = np.prod(np.minimum(d[:, None], d[None, :]), axis=-1)
    vol = np.prod(d, axis=-1)
    return inter / np.clip(vol[:, None] + vol[None, :] - inter, 1e-9, None)


def bev_occ_map(pts, allrange, nx, ny):
    occ = np.zeros((nx, ny), np.int32)
    if len(pts):
        idx = np.floor((pts[:, :2] - allrange[None, :2]) / VOXEL_SIZE[None, :2]).astype(int)
        idx = idx[(idx[:, 0] >= 0) & (idx[:, 0] < nx) & (idx[:, 1] >= 0) & (idx[:, 1] < ny)]
        occ[idx[:, 0], idx[:, 1]] = 1
    return occ


def in_box(pts, dims):
    return pts[np.all(np.abs(pts) <= dims[None] * 0.5, axis=1)]


def assemble_object(
    own_mirrored, own_occ, cand_ious, cand_clouds, cand_occ_maps,
    *, max_num_bm, num_extra_coords, iou_thresh, ex_coords_ratio, nearest_dist,
):
    """Greedy donor selection for one object (reference
    `find_multi_best_match_boxpnts`)."""
    bm_pnts = own_mirrored
    aug_map = own_occ.copy()
    aug_coords = 0
    ious = cand_ious.copy()
    alive = list(range(len(cand_clouds)))

    # max chamfer from own points to each candidate (computed once)
    max_inst = np.zeros(len(cand_clouds))
    if len(own_mirrored):
        for j, cand in enumerate(cand_clouds):
            max_inst[j] = nn_dist(own_mirrored, cand).max() if len(cand) else 100.0

    for _ in range(max_num_bm):
        if not alive:
            break
        sel_occ = np.stack([cand_occ_maps[j] for j in alive])
        extra = ((sel_occ > 0) & (aug_map[None] == 0)).reshape(len(alive), -1).sum(1)
        iou_a = ious[alive]
        heur = (
            max_inst[alive]
            + ex_coords_ratio / np.maximum(extra, 1e-9)
            + (iou_a < iou_thresh) * 2.0
            + (extra < 30) * 1.0
        )
        k = int(np.argmin(heur))
        j = alive[k]
        if (iou_a[k] < iou_thresh and len(bm_pnts) > 0) or extra[k] == 0:
            break
        added = cand_clouds[j]
        if len(bm_pnts):
            added = added[nn_dist(added, bm_pnts) > nearest_dist]
        if len(added) > 4:
            bm_pnts = np.concatenate([bm_pnts, added], axis=0)
            aug_map |= cand_occ_maps[j]
            aug_coords = int(aug_map.sum())
        if aug_coords >= num_extra_coords:
            break
        alive.pop(k)
    return bm_pnts, aug_coords


def create_best_match_db(
    data_path, class_names=("Car", "Cyclist", "Pedestrian"), splits=("train", "val"),
    save=True, logger=None,
):
    data_path = Path(data_path)
    log = logger.info if logger else print
    for cls in class_names:
        apply_mirror, pnt_thresh, ex_ratio, max_bm, near_d, iou_t, n_extra = CLASS_PARAMS[cls]
        out_dir = data_path / f"bm_{ex_ratio}maxdist_{max_bm}num_{cls if cls != 'Car' else 'car'}"
        out_dir.mkdir(parents=True, exist_ok=True)

        infos, dims, clouds, mirrored = [], [], [], []
        for split in splits:
            db_path = data_path / f"kitti_dbinfos_{split}.pkl"
            if not db_path.exists():
                continue
            with open(db_path, "rb") as f:
                db = pickle.load(f).get(cls, [])
            for info in db:
                box = info["box3d_lidar"]
                pts = canonical_cloud(data_path / info["path"], box)
                infos.append(info)
                dims.append(box[3:6])
                clouds.append(pts)
                mirrored.append(mirror_cloud(pts) if apply_mirror else pts)
        if not infos:
            log(f"bestmatch {cls}: no db entries, skipped")
            continue
        log(f"bestmatch {cls}: {len(infos)} objects")

        nonempty = [m for m in mirrored if len(m)]
        lo = np.min([m.min(0) for m in nonempty], axis=0)
        hi = np.max([m.max(0) for m in nonempty], axis=0)
        allrange = np.concatenate([lo, hi])
        nx = int(np.ceil((allrange[3] - allrange[0]) / VOXEL_SIZE[0]))
        ny = int(np.ceil((allrange[4] - allrange[1]) / VOXEL_SIZE[1]))

        occ_maps = [bev_occ_map(m, allrange, nx, ny) for m in mirrored]
        coords_num = np.array([o.sum() for o in occ_maps])
        iou = dims_iou(dims)

        rich = np.where(coords_num > pnt_thresh)[0]
        for car_id in range(len(infos)):
            iou_row = iou[car_id, rich]
            order = np.argsort(-iou_row)[: min(TOP_K, len(rich))]
            cand_idx = rich[order]
            cand_ious = iou_row[order]
            cand_clouds = [in_box(mirrored[j], np.asarray(dims[car_id])) for j in cand_idx]
            cand_occ = [bev_occ_map(c, allrange, nx, ny) for c in cand_clouds]
            bm_pnts, n_coords = assemble_object(
                mirrored[car_id], occ_maps[car_id], cand_ious, cand_clouds, cand_occ,
                max_num_bm=max_bm, num_extra_coords=n_extra, iou_thresh=iou_t,
                ex_coords_ratio=ex_ratio, nearest_dist=near_d,
            )
            if save:
                info = infos[car_id]
                name = f"{int(info['image_idx'])}_{int(info['gt_idx'])}.pkl"
                with open(out_dir / name, "wb") as f:
                    pickle.dump(bm_pnts.astype(np.float32), f)
            if car_id % 200 == 0:
                log(f"  {cls} {car_id}/{len(infos)}: bm pts {len(bm_pnts)} vox {n_coords}")
    log("bestmatch generation done")


def inspect_bm_db(data_path, cls: str = "Car", logger=None):
    """Summarize a generated bm db: object count, point-count and
    BEV-coverage distributions. Replaces the reference's hard-coded
    inspection script (`btcdet/datasets/finddiff.py`; its sibling
    `findbestfit.py` car-only generator is subsumed by
    `create_best_match_db`)."""
    log = logger.info if logger else print
    data_path = Path(data_path)
    _, _, ex_ratio, max_bm, _, _, _ = CLASS_PARAMS[cls]
    out_dir = data_path / f"bm_{ex_ratio}maxdist_{max_bm}num_{cls if cls != 'Car' else 'car'}"
    files = sorted(out_dir.glob("*.pkl"))
    if not files:
        log(f"inspect {cls}: no bm files under {out_dir}")
        return {}
    counts, spans = [], []
    for fp in files:
        with open(fp, "rb") as f:
            pts = pickle.load(f)
        counts.append(len(pts))
        if len(pts):
            spans.append((pts[:, :3].max(0) - pts[:, :3].min(0)))
    counts = np.array(counts)
    stats = {
        "num_objects": len(files),
        "pts_mean": float(counts.mean()),
        "pts_p50": float(np.percentile(counts, 50)),
        "pts_p95": float(np.percentile(counts, 95)),
        "pts_max": int(counts.max()),
        "span_mean_xyz": np.mean(spans, axis=0).round(2).tolist() if spans else None,
    }
    log(f"inspect {cls}: {stats}")
    return stats


if __name__ == "__main__":
    import sys

    if "--inspect" in sys.argv:
        args = [a for a in sys.argv[1:] if a != "--inspect"]
        inspect_bm_db(args[0] if args else "data/kitti/detection3d",
                      cls=args[1] if len(args) > 1 else "Car")
    else:
        create_best_match_db(sys.argv[1] if len(sys.argv) > 1 else "data/kitti/detection3d")
