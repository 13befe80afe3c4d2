"""Visualization utilities (counterpart of `btcdet_tpu/utils/vis_utils.py`,
reference `btcdet/utils/vis_occ_utils.py` and `tools/visual_utils/`).

Dependency-light: BEV raster images are plain numpy arrays (H, W, 3)
uint8 suitable for tensorboard / PNG; the mayavi 3D viewers of the
reference are replaced by `.npy` point-cloud dumps plus an export to
PLY for any external viewer.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from . import box_utils
from .common import rotate_points_along_z_np


def bev_raster(
    points=None, boxes=None, occ_points=None,
    point_cloud_range=(0, -40, -3, 70.4, 40, 1), resolution: float = 0.1,
):
    """Rasterize points (white), occ points (orange) and boxes (green) on
    a BEV canvas (reference `draw_lidars_box3d_on_birdview`)."""
    pr = np.asarray(point_cloud_range)
    W = int((pr[3] - pr[0]) / resolution)
    H = int((pr[4] - pr[1]) / resolution)
    img = np.zeros((H, W, 3), np.uint8)

    def to_px(xy):
        u = ((xy[:, 0] - pr[0]) / resolution).astype(int)
        v = ((xy[:, 1] - pr[1]) / resolution).astype(int)
        ok = (u >= 0) & (u < W) & (v >= 0) & (v < H)
        return u[ok], v[ok]

    if points is not None and len(points):
        u, v = to_px(np.asarray(points)[:, :2])
        img[v, u] = (220, 220, 220)
    if occ_points is not None and len(occ_points):
        u, v = to_px(np.asarray(occ_points)[:, :2])
        img[v, u] = (255, 140, 0)
    if boxes is not None and len(boxes):
        corners = np.asarray(box_utils.boxes_to_corners_bev_np(np.asarray(boxes)))
        for quad in corners:  # (4, 2)
            for i in range(4):
                a, b = quad[i], quad[(i + 1) % 4]
                n = int(np.linalg.norm(b - a) / resolution) + 1
                seg = a[None] + (b - a)[None] * np.linspace(0, 1, n)[:, None]
                u, v = to_px(seg)
                img[v, u] = (0, 255, 0)
    return img[::-1]  # +x up


def collect_occ_vis_clouds(out, batch, spec, vis_cfg, frame=0):
    """Assemble the reference's occ-debug views from one frame of model
    outputs (reference `add_occ_template.visualize:290-422`, gated by the
    `OCC_PNT_UPDATE.VIS` config block). Host-side numpy: `out` holds the
    train forward's dense masks (`btcnet.VIS_MASK_KEYS`) and occ outputs as
    numpy arrays, `spec` is the occ grid spec (`occ_targets.build_grid_spec`).

    Returns (tb_imgs, pc): BEV raster uint8 images for tensorboard, and
    the point-cloud dict written to `cloud/*.npy` for
    `tools/visual_utils/visualize_pc.py` -- keys match the reference so
    the same viewer works.
    """
    g = lambda flag: bool(vis_cfg.get(flag, False))
    b = frame
    tb, pc = {}, {}

    def npy(x):
        return None if x is None else np.asarray(x)

    rot_z = npy(batch.get("rot_z", None))
    centers = np.asarray(spec.voxel_centers_xyz, np.float32)  # (nz,ny,nx,3)
    if rot_z is not None and float(np.abs(rot_z[b])) > 1e-6:
        # sensor -> world frame (reference rotatez(all_voxel_centers, rot_z))
        sh = centers.shape
        centers = rotate_points_along_z_np(
            centers.reshape(1, -1, 3),
            np.asarray([float(rot_z[b]) * np.pi / 180.0], np.float32),
        ).reshape(sh)
    res = npy(out.get("res_mtrx", None))
    gt_centers = centers
    if res is not None:
        r = res[b]
        if r.shape[0] == 3 and r.shape[-1] != 3:     # channel-first layout
            r = np.moveaxis(r, 0, -1)
        gt_centers = centers + r

    def mask_centers(mask, source=centers):
        if mask is None:
            return np.zeros((0, 3), np.float32)
        m = np.asarray(mask[b]).astype(bool)
        return source[m]

    points = np.zeros((0, 3), np.float32)
    if "points" in batch:
        p = npy(batch["points"])[b]
        points = p[np.abs(p[:, :3]).sum(-1) > 0][:, :3]
    boxes = np.zeros((0, 7), np.float32)
    if "gt_boxes" in batch:
        gb = npy(batch["gt_boxes"])[b]
        boxes = gb[np.abs(gb[:, 3:6]).sum(-1) > 0][:, :7]

    def bev(occ_pts):
        return bev_raster(points, boxes, occ_pts,
                          point_cloud_range=spec.det_point_cloud_range)

    gcls = npy(out.get("general_cls_loss_mask", None))
    fore = npy(out.get("fore_voxelwise_mask", None))
    mirr = npy(out.get("mirr_voxelwise_mask", None))
    bm = npy(out.get("bm_voxelwise_mask", None))

    if g("FORE_VOX_GT_VIEW") and fore is not None:
        fc = mask_centers(fore, gt_centers)
        pc["fore_gt_center"] = fc
        tb["forevox_gt_view_img"] = bev(fc)
    # occluded-region intersections (reference occ_{fore,mirr,bm}_cls_mask
    # = the per-source masks clipped to the cls-loss region)
    for flag, m, key in [
        ("OCC_FORE_VOX_GT_VIEW", fore, "occ_fore_center"),
        ("OCC_MIRR_VOX_GT_VIEW", mirr, "occ_mirr_center"),
        ("OCC_BM_VOX_GT_VIEW", bm, "occ_bm_center"),
    ]:
        if g(flag) and m is not None and gcls is not None:
            pc[key] = mask_centers(np.asarray(m) & np.asarray(gcls), gt_centers)
    if g("OCC_POS_VOX_GT_VIEW"):
        pc["occ_pos_center"] = mask_centers(npy(out.get("pos_mask")), gt_centers)
    if g("OCC_NEG_VOX_GT_VIEW"):
        pc["occ_neg_center"] = mask_centers(npy(out.get("neg_mask")), gt_centers)
    if g("OCC_VOX"):
        pc["occ_center"] = mask_centers(npy(out.get("occ_voxelwise_mask")), gt_centers)
    if g("BM_VOX_VIEW"):
        pc["bmvoxel_center"] = mask_centers(bm, gt_centers)
    if g("CLS_LOSS"):
        pc["general_cls_loss_center"] = mask_centers(gcls, gt_centers)
    if g("FILTER_VIEW") and "vcc_mask" in out:
        fc = mask_centers(npy(out["vcc_mask"]))
        pc["filter_center"] = fc
        tb["filter_view_img"] = bev(fc)
    if g("DROP_VOX_VIEW") and out.get("voxel_drop_mask") is not None:
        pc["drop_voxel_center"] = mask_centers(npy(out["voxel_drop_mask"]))
    if g("BOX_VIEW") and out.get("forebox_label") is not None:
        bc = mask_centers(npy(out["forebox_label"]))
        pc["boxvoxel_center"] = bc
        tb["box_view_img"] = bev(bc)

    probs = npy(out.get("probs", out.get("occ_probs", None)))
    if g("PRED_FORE_VIEW") and probs is not None:
        for thresh in (0.9, 0.8, 0.7, 0.6, 0.5, 0.4, 0.3, 0.2, 0.1):
            sel = centers[probs[b] >= thresh]
            tb[f"pred_fore_{thresh}_img"] = bev(sel)
            if thresh == 0.5:
                pc["proboccpoints"] = sel
    if g("ADD_PNT_VIEW") and out.get("occ_points") is not None:
        op = npy(out["occ_points"])[b]
        om = npy(out["occ_points_mask"])[b].astype(bool)
        added = op[om][:, :3]
        pc["addpnt_view"] = added
        tb["addpnt_img"] = bev(added)

    if g("OUTPUT_CLOUD"):
        pc["gt_points"] = points
        pc["gt_boxes"] = boxes
        if "bm_points" in batch and g("BM_POINTS"):
            bp = npy(batch["bm_points"])[b]
            bmm = npy(batch["bm_points_mask"])[b].astype(bool)
            pc["bm_points"] = bp[bmm][:, :3]
    else:
        pc = {}
    return tb, pc


def save_point_cloud(points, path, colors=None):
    """Dump points as .npy (the reference's cloud/ dumps) or .ply."""
    path = Path(path)
    points = np.asarray(points)
    if path.suffix == ".npy":
        np.save(str(path), points)
        return
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(points)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for i, p in enumerate(points):
            line = f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}"
            if colors is not None:
                c = colors[i]
                line += f" {int(c[0])} {int(c[1])} {int(c[2])}"
            f.write(line + "\n")
