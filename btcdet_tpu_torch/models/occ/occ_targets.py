"""Occupancy targets (counterpart of `btcdet_tpu/models/occ/occ_targets.py`
and of `OccSubnet._make_targets` in `btcdet_tpu/models/occ/occ_subnet.py`, reference
`btcdet/models/occ_pnt/occ_training_targets/{occ_targets_template.py,
occ_targets_3d.py}`).

All masks live on the dense occ grid (B, nz, ny, nx) (cylinder coords,
sensor frame):

  voxelwise   observed voxels (scatter of the occ voxel coords)
  vcc         "predict area": DIST_KERN dilation of voxelwise, shifted
              forward in range when HALF_X
  occluded    cumulative occupancy along the range axis of an auxiliary
              sphere support grid (> 0.9), carried into the occ grid by a
              static sphere -> occ cell map, then `z_filter`
  fore/mirr   point-in-gt-box membership; points mirrored across each
              box's local y axis
  bm          best-match points inside the gt boxes
  drop        the cells of the occ voxel rows that train-time dropout
              zeroed (OCC.DROPOUT_RATE), and the fore cells among them

OccTargetsPillar dilates vcc over the BEV footprint instead, and
OCC.REVERSE_VIS changes what `occlusion_mask` counts as occluded.

At train `make_targets` adds the loss maps: the per-voxel residual
targets (`scatter_mean_res` of the fore / mirror / bm points, minus the
voxel centre), the `forebox` label (voxel centres inside a gt box, when
BOX_WEIGHT != 1) and the cls / reg weight maps.

The grid spec is built on the host in float64 exactly as the JAX
package builds it, so both packages use the same sphere -> occ map.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...utils import box_utils, common, coords


class OccGridSpec(NamedTuple):
    """Static geometry of the occ pipeline, precomputed on the host."""

    coord_type: str
    grid_size: tuple          # (nx, ny, nz) occ grid
    voxel_size: tuple         # occ voxel size (u, v, d)
    point_cloud_range: tuple  # occ range in occ coords (6,)
    det_point_cloud_range: tuple
    dist_kern: tuple          # (kz, ky, kx)
    concede_x: int
    empt_sur_thresh: int
    sphere_grid_size: tuple   # (snx, sny, snz)
    sphere_voxel_size: tuple
    sphere_range: tuple
    sphere_to_grid_map: np.ndarray   # (snz*sny*snx,) int32 -> occ cell or -1
    voxel_centers_xyz: np.ndarray    # (nz, ny, nx, 3) cartesian centers (sensor frame)
    reverse_vis: str = "NOTHING"


def build_grid_spec(data_cfg) -> OccGridSpec:
    """The JAX package's `build_grid_spec`, float64 numpy on the host."""
    occ = data_cfg.OCC
    coord_type = occ.COORD_TYPE
    pcr = np.asarray(occ.POINT_CLOUD_RANGE, np.float64)
    vs = np.asarray(occ.VOXEL_SIZE, np.float64)
    grid = np.round((pcr[3:6] - pcr[0:3]) / vs).astype(np.int64)
    nx, ny, nz = int(grid[0]), int(grid[1]), int(grid[2])

    sr = np.asarray(occ.SUPPORT_SPHERE_RANGE, np.float64)
    svs = np.array([vs[0], vs[1], sr[6]])
    if occ.get("SUPPORT_SPHERE_VOXEL_SIZE") is not None:
        svs = np.array([occ.SUPPORT_SPHERE_VOXEL_SIZE[0], occ.SUPPORT_SPHERE_VOXEL_SIZE[1], sr[6]])
    sgrid = ((sr[3:6] - sr[0:3]) / svs).astype(np.int64)
    snx, sny, snz = int(sgrid[0]), int(sgrid[1]), int(sgrid[2])

    # sphere cell CORNER -> cartesian -> occ coords -> occ cell
    # (in-range test, then clamp)
    iz, iy, ix = np.meshgrid(np.arange(snz), np.arange(sny), np.arange(snx), indexing="ij")
    su = sr[0] + ix.astype(np.float64) * svs[0]
    sv = sr[1] + iy.astype(np.float64) * svs[1]
    sd = sr[2] + iz.astype(np.float64) * svs[2]
    cart = coords.sphere_to_absxyz(su.ravel(), sv.ravel(), sd.ravel())
    if coord_type == "cylinder":
        occ_pts = coords.absxyz_to_cylinder(cart)
    elif coord_type == "cartesian":
        occ_pts = cart
    else:
        occ_pts = coords.absxyz_to_sphere(cart)
    in_range = np.all((occ_pts[:, :3] >= pcr[None, :3]) & (occ_pts[:, :3] <= pcr[None, 3:6]),
                      axis=1)
    cell = np.floor((occ_pts[:, :3] - pcr[None, :3]) / vs[None]).astype(np.int64)
    cell = np.clip(cell, 0, np.array([nx - 1, ny - 1, nz - 1])[None])
    lin = (cell[:, 2] * ny + cell[:, 1]) * nx + cell[:, 0]
    sphere_map = np.where(in_range, lin, -1).astype(np.int32)

    # cylinder grids sharing the sphere grid's azimuth binning: azimuth
    # factors out of the map, which is built at azimuth 0 from (el, r)
    # alone and repeated over the azimuth bins (no float jitter at bin
    # boundaries)
    az_shared = (
        coord_type == "cylinder"
        and abs(sr[1] - pcr[1]) < 1e-9 and abs(sr[4] - pcr[4]) < 1e-9
        and abs(svs[1] - vs[1]) < 1e-9 and sny == ny
    )
    if az_shared:
        iz2, ix2 = np.meshgrid(np.arange(snz), np.arange(snx), indexing="ij")
        su2 = sr[0] + ix2.astype(np.float64) * svs[0]
        sd2 = sr[2] + iz2.astype(np.float64) * svs[2]
        occ2 = coords.absxyz_to_cylinder(
            coords.sphere_to_absxyz(su2.ravel(), np.zeros(su2.size), sd2.ravel()))
        inr2 = ((occ2[:, 0] >= pcr[0]) & (occ2[:, 0] <= pcr[3])
                & (occ2[:, 2] >= pcr[2]) & (occ2[:, 2] <= pcr[5]))
        cr = np.clip(np.floor((occ2[:, 0] - pcr[0]) / vs[0]).astype(np.int64), 0, nx - 1)
        cz2 = np.clip(np.floor((occ2[:, 2] - pcr[2]) / vs[2]).astype(np.int64), 0, nz - 1)
        m2 = np.where(inr2, cz2 * nx + cr, -1).astype(np.int32).reshape(snz, snx)
        z_t = m2 // nx
        r_t = m2 - z_t * nx
        full = z_t[:, None, :] * (ny * nx) + np.arange(sny)[None, :, None] * nx + r_t[:, None, :]
        sphere_map = np.where(m2[:, None, :] >= 0, full, -1).reshape(-1).astype(np.int32)

    czi, cyi, cxi = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx), indexing="ij")
    centers = coords.occ_uvd_to_absxyz(
        (pcr[0] + (cxi + 0.5) * vs[0]).ravel(), (pcr[1] + (cyi + 0.5) * vs[1]).ravel(),
        (pcr[2] + (czi + 0.5) * vs[2]).ravel(), coord_type,
    ).reshape(nz, ny, nx, 3).astype(np.float32)

    dk = tuple(int(d) for d in occ.DIST_KERN)  # (kz, ky, kx)
    concede = dk[2] // 2 if occ.get("HALF_X", False) else 0
    concede = int(occ.get("CONCEDE_X", concede))
    return OccGridSpec(
        coord_type=coord_type,
        grid_size=(nx, ny, nz),
        voxel_size=tuple(float(v) for v in vs),
        point_cloud_range=tuple(float(v) for v in pcr),
        det_point_cloud_range=tuple(float(v) for v in data_cfg.POINT_CLOUD_RANGE),
        dist_kern=dk,
        concede_x=concede,
        empt_sur_thresh=int(occ.get("EMPT_SUR_THRESH", 9)),
        sphere_grid_size=(snx, sny, snz),
        sphere_voxel_size=tuple(float(v) for v in svs),
        sphere_range=tuple(float(v) for v in sr),
        sphere_to_grid_map=sphere_map,
        voxel_centers_xyz=centers,
        reverse_vis=str(occ.get("REVERSE_VIS", "NOTHING")),
    )


class GridTables(nn.Module):
    """The spec's constant tables as non-persistent buffers, so they follow
    the owning module's device and a forward copies nothing from the host:
    the occ and sphere grid origins / extents / voxel sizes / last cells,
    the sphere -> occ cell map (int64) and the occ cell centres (sensor
    frame, cartesian) and their z."""

    def __init__(self, spec: OccGridSpec):
        super().__init__()
        self.spec = spec
        nx, ny, nz = spec.grid_size
        snx, sny, snz = spec.sphere_grid_size
        for name, val in (
                ("occ_range", torch.tensor(spec.point_cloud_range, dtype=torch.float32)),
                ("occ_vs", torch.tensor(spec.voxel_size, dtype=torch.float32)),
                ("occ_hi", torch.tensor([nx - 1, ny - 1, nz - 1])),
                ("sphere_range", torch.tensor(spec.sphere_range[:6], dtype=torch.float32)),
                ("sphere_vs", torch.tensor(spec.sphere_voxel_size, dtype=torch.float32)),
                ("sphere_hi", torch.tensor([snx - 1, sny - 1, snz - 1])),
                ("sphere_map", torch.from_numpy(spec.sphere_to_grid_map.astype(np.int64))),
                ("centers", torch.from_numpy(spec.voxel_centers_xyz.copy())),
                ("centers_z", torch.from_numpy(spec.voxel_centers_xyz[..., 2].copy()))):
            self.register_buffer(name, val, persistent=False)


def scatter_mask(coords_bzyx, valid, batch_size: int, grid):
    """(N, 4) (b, z, y, x) -> dense bool (B, nz, ny, nx)."""
    nx, ny, nz = grid
    ncell = nz * ny * nx
    c = coords_bzyx.long()
    lin = (c[:, 1] * ny + c[:, 2]) * nx + c[:, 3]
    idx = torch.where(valid, c[:, 0] * ncell + lin, torch.full_like(lin, batch_size * ncell))
    out = torch.zeros(batch_size * ncell + 1, dtype=torch.bool, device=c.device)
    out[idx] = True
    return out[:-1].reshape(batch_size, nz, ny, nx)


# fixed-point scale of `scatter_mean_res`'s sums: 2^-32 m steps, exact in
# int64 for coordinates and sums below 2^31 m
_MEAN_SCALE = 2.0 ** 32


def scatter_mean_res(points_xyz, coords_bzyx, valid, centers_xyz, batch_size: int, grid):
    """Per-voxel mean of the contributing points minus the voxel centre
    (reference `get_mean_res`): (B, nz, ny, nx, 3), 0 where no point
    falls. centers_xyz (B, nz, ny, nx, 3). The points are summed in int64
    fixed point (steps of 2^-32 m), exactly and so in any order: a float
    `index_add_` on the card adds in atomic order, and a voxel of three or
    more points would round differently from run to run."""
    nx, ny, nz = grid
    ncell = nz * ny * nx
    c = coords_bzyx.long()
    lin = (c[:, 1] * ny + c[:, 2]) * nx + c[:, 3]
    idx = torch.where(valid, c[:, 0] * ncell + lin, torch.full_like(lin, batch_size * ncell))
    fixed = torch.round(points_xyz.double() * _MEAN_SCALE).long()
    acc = torch.zeros((batch_size * ncell + 1, 3), dtype=torch.long, device=points_xyz.device)
    acc.index_add_(0, idx, torch.where(valid[:, None], fixed, torch.zeros_like(fixed)))
    cnt = torch.zeros((batch_size * ncell + 1,), dtype=torch.long, device=points_xyz.device)
    cnt.index_add_(0, idx, valid.long())
    mean = (acc[:-1].double() / _MEAN_SCALE / cnt[:-1, None].clamp(min=1)).float()
    mean = mean.reshape(batch_size, nz, ny, nx, 3)
    has = (cnt[:-1] > 0).reshape(batch_size, nz, ny, nx)
    return torch.where(has[..., None], mean - centers_xyz, torch.zeros((), device=acc.device))


def centers_world(tab: GridTables, rot_z) -> torch.Tensor:
    """Occ voxel centres in each frame's world frame (rotated by rot_z
    degrees): (B, nz, ny, nx, 3)."""
    c = tab.centers
    B = rot_z.shape[0]
    flat = c.reshape(1, -1, 3).expand(B, -1, 3)
    return common.rotate_points_along_z(flat, rot_z * (np.pi / 180.0)).reshape(
        (B,) + tuple(c.shape))


def dilate_predict_area(mask, dist_kern, concede_x: int):
    """vcc mask (reference `create_predict_area3d`): each active voxel
    marks a (kz, ky, kx) neighbourhood starting at offset
    (-kz//2, -ky//2, -kx//2 + concede_x)."""
    kz, ky, kx = dist_kern
    starts = (-(kz // 2), -(ky // 2), -(kx // 2) + concede_x)
    # output o covers inputs o + a .. o + a + k - 1 with a = -(s + k - 1)
    pads = []
    for s, k in zip(starts, (kz, ky, kx)):
        pads.append((s + k - 1, -s))
    m = mask[:, None].float()
    # F.pad takes (x_lo, x_hi, y_lo, y_hi, z_lo, z_hi); negative pads crop
    m = F.pad(m, (pads[2][0], pads[2][1], pads[1][0], pads[1][1], pads[0][0], pads[0][1]),
              value=0.0)
    return F.max_pool3d(m, (kz, ky, kx), stride=1)[:, 0] > 0


def points_to_grid_coords(occ_pts, tab: GridTables):
    """Occ-coord points -> (cell_xyz (N, 3) int64, in_range (N,)) with the
    in-range-then-clamp semantics of the reference `point2coords_inrange`."""
    pcr = tab.occ_range
    inr = ((occ_pts[:, :3] >= pcr[:3]) & (occ_pts[:, :3] <= pcr[3:6])).all(dim=1)
    cell = torch.floor((occ_pts[:, :3] - pcr[:3]) / tab.occ_vs).long()
    return torch.minimum(cell.clamp(min=0), tab.occ_hi), inr


def world_to_occ_coords(points_xyz, rot_z_deg, coord_type: str):
    """World-frame cartesian points (N, 3) -> sensor-frame occ coords, rot_z
    in degrees per point (N,): a cartesian grid rotates each point by -rot_z
    about z, a cylinder / sphere grid adds rot_z to the azimuth."""
    if coord_type == "cartesian":
        return common.rotate_points_along_z(points_xyz[:, None, :],
                                            -rot_z_deg * (np.pi / 180.0))[:, 0]
    oc = coords.cartesian_to_occ(points_xyz, coord_type)
    return torch.cat([oc[:, :1], oc[:, 1:2] + rot_z_deg[:, None], oc[:, 2:]], dim=1)


def occlusion_mask(tab: GridTables, points_xyz, points_valid, points_b, rot_z,
                   batch_size: int):
    """Sphere-support-grid occlusion (reference `occ_from_cylin_ocp` /
    `occ_from_sphere_ocp`) along the range axis of each beam:

      default     at or behind the first return, with the EMPT_SUR_THRESH
                  empty-beam rule;
      BACK_TRACK  beyond the last return, or at or behind the first;
      VCC         everything but the cells in front of a return (the
                  (DIST_KERN x + 1) // 2 cells before it, range index
                  clamped at 0), returns included.

    The two REVERSE_VIS modes skip the empty-beam rule, as the reference
    does. points_xyz (N, 3) world-frame cartesian. Returns bool
    (B, nz, ny, nx)."""
    spec = tab.spec
    dev = points_xyz.device
    snx, sny, snz = spec.sphere_grid_size
    sr = tab.sphere_range

    sph = coords.absxyz_to_sphere(points_xyz)
    sph = torch.cat([sph[:, :1], sph[:, 1:2] + rot_z[points_b][:, None], sph[:, 2:3]], dim=1)
    inr = ((sph >= sr[:3]) & (sph <= sr[3:6])).all(dim=1) & points_valid
    cell = torch.floor((sph - sr[:3]) / tab.sphere_vs).long()
    cell = torch.minimum(cell.clamp(min=0), tab.sphere_hi)
    scell = snz * sny * snx
    lin = (cell[:, 2] * sny + cell[:, 1]) * snx + cell[:, 0]
    idx = torch.where(inr, points_b.long() * scell + lin,
                      torch.full_like(lin, batch_size * scell))
    smask = torch.zeros(batch_size * scell + 1, dtype=torch.float32, device=dev)
    smask[idx] = 1.0
    smask = smask[:-1].reshape(batch_size, snz, sny, snx)

    if spec.empt_sur_thresh < 9 and spec.reverse_vis not in ("VCC", "BACK_TRACK"):
        # an empty beam with more than `thresh` occupied beams in its 3x3
        # (elevation, azimuth) neighbourhood counts as occupied at range 0
        # (reference `get_empty_mask:186`); the range-0 cell is overwritten
        counts2d = smask.sum(dim=3)                                   # (B, snz, sny)
        neigh = F.conv2d(counts2d[:, None], torch.ones((1, 1, 3, 3), device=dev),
                         padding=1)[:, 0]
        empty_occ = (counts2d == 0) & (neigh > spec.empt_sur_thresh)
        smask[:, :, :, 0] = empty_occ.float()

    # the returns are 0 / 1, so every sum below is an exact small integer
    ahead = torch.cumsum(smask, dim=3)                   # returns at range <= i
    if spec.reverse_vis == "BACK_TRACK":
        behind = smask.flip(3).cumsum(3).flip(3)         # returns at range >= i
        occluded_sphere = (behind < 0.9) | (ahead > 0.9)
    elif spec.reverse_vis == "VCC":
        h = (spec.dist_kern[2] + 1) // 2
        vis = smask[..., :1] * (torch.arange(snx, device=dev) == 0)
        for d in range(1, h + 1):                        # a return d cells further on
            vis = vis + F.pad(smask[..., d:], (0, min(d, snx)))
        occluded_sphere = (vis < 0.5) | (smask > 0.5)
    else:
        occluded_sphere = ahead > 0.9
    if spec.coord_type == "sphere":
        return occluded_sphere

    # exact scatter-or through the static sphere -> occ map
    nx, ny, nz = spec.grid_size
    ncell = nz * ny * nx
    smap = tab.sphere_map
    tgt = torch.where(smap >= 0, smap, torch.full_like(smap, ncell))
    hits = torch.zeros((batch_size, ncell + 1), dtype=torch.float32, device=dev)
    hits.index_add_(1, tgt, occluded_sphere.reshape(batch_size, -1).float())
    return (hits[:, :-1] > 0.5).reshape(batch_size, nz, ny, nx)


def z_filter(tab: GridTables, occluded, voxelwise):
    """Reference `filter_occ:249`: keep occluded voxels above the
    per-range-column minimum observed z and inside the det z range."""
    spec = tab.spec
    centers_z = tab.centers_z
    B = voxelwise.shape[0]
    masked_z = torch.where(voxelwise, centers_z[None], centers_z[None] + 100.0)
    col_min = masked_z.reshape(B, -1, masked_z.shape[-1]).min(dim=1).values   # (B, nx)
    col_min = col_min - (col_min > 20.0).float() * 200.0
    col_min = col_min.clamp(min=spec.det_point_cloud_range[2])
    above = centers_z[None] > col_min[:, None, None, :]
    below = centers_z[None] < spec.det_point_cloud_range[5]
    return occluded & above & below


def mirror_points_in_boxes(points_xyz, valid, gt_boxes, gt_valid, mirr_flag):
    """Per frame (leading batch dims allowed): points (..., N, 3) vs boxes
    (..., G, 8). Returns (fore (..., N), mirrored points (..., N, 3),
    mirrored valid (..., N)); each point mirrors across the local y axis of
    the FIRST box with mirr_flag that contains it."""
    inb = box_utils.points_in_boxes_mask(points_xyz, gt_boxes[..., :7])   # (..., N, G)
    inb = inb & gt_valid[..., None, :] & valid[..., :, None]
    fore = inb.any(dim=-1)
    inb_mirr = inb & (mirr_flag[..., None, :] > 0.5)
    has_mirr = inb_mirr.any(dim=-1)
    bidx = inb_mirr.to(torch.uint8).argmax(dim=-1)
    box = torch.gather(gt_boxes, -2, bidx[..., None].expand(*bidx.shape, gt_boxes.shape[-1]))
    d = points_xyz - box[..., 0:3]
    c, s = torch.cos(-box[..., 6]), torch.sin(-box[..., 6])
    lx = d[..., 0] * c - d[..., 1] * s
    ly = -(d[..., 0] * s + d[..., 1] * c)
    c2, s2 = torch.cos(box[..., 6]), torch.sin(box[..., 6])
    wx = lx * c2 - ly * s2 + box[..., 0]
    wy = lx * s2 + ly * c2 + box[..., 1]
    wz = d[..., 2] + box[..., 2]
    return fore, torch.stack([wx, wy, wz], dim=-1), has_mirr


def mirror_points_in_boxes_blocked(points_xyz, valid, gt_boxes, gt_valid, mirr_flag,
                                   batch_size: int):
    """`mirror_points_in_boxes` for a flat point list made of per-frame
    contiguous blocks of equal size (the voxel tables' layout)."""
    n = points_xyz.shape[0]
    m = n // batch_size
    fore, mp, mv = mirror_points_in_boxes(points_xyz.reshape(batch_size, m, 3),
                                          valid.reshape(batch_size, m), gt_boxes, gt_valid,
                                          mirr_flag)
    return fore.reshape(n), mp.reshape(n, 3), mv.reshape(n)


def points_in_gt_blocked(points_xyz, valid, gt_boxes, gt_valid, batch_size: int):
    """Blocked-layout in-any-gt-box test."""
    n = points_xyz.shape[0]
    p = points_xyz.reshape(batch_size, n // batch_size, 3)
    hit = box_utils.points_in_boxes_mask(p, gt_boxes[..., :7]) & gt_valid[:, None, :]
    return (hit.any(dim=-1) & valid.reshape(batch_size, -1)).reshape(n)


def mirror_points_in_boxes_batched(points_xyz, valid, points_b, gt_boxes, gt_valid, mirr_flag,
                                   batch_size: int):
    """`mirror_points_in_boxes` for a flat point list (N, 3) whose points
    carry their frame `points_b` (N,), against the boxes of their own
    frame (gt_boxes (B, G, 8), reference
    `torch_points_and_sym_in_box_3d_batch`). Returns (fore (N,),
    mirrored points (N, 3), mirrored valid (N,))."""
    fore = torch.zeros_like(valid)
    mirr_pts = torch.zeros_like(points_xyz)
    mirr_val = torch.zeros_like(valid)
    for b in range(batch_size):
        sel = valid & (points_b == b)
        f, mp, mv = mirror_points_in_boxes(points_xyz, sel, gt_boxes[b], gt_valid[b],
                                           mirr_flag[b])
        fore = fore | (f & sel)
        mirr_pts = torch.where((mv & sel)[:, None], mp, mirr_pts)
        mirr_val = mirr_val | (mv & sel)
    return fore, mirr_pts, mirr_val


def points_in_gt_batched(points_xyz, valid, points_b, gt_boxes, gt_valid, batch_size: int):
    """In-any-gt-box test of a flat point list (N, 3) whose points carry
    their frame `points_b` (N,) against their own frame's boxes (reference
    `torch_points_in_box_3d_label_batch`): (N,) bool."""
    out = torch.zeros_like(valid)
    for b in range(batch_size):
        hit = (box_utils.points_in_boxes_mask(points_xyz, gt_boxes[b][:, :7])
               & gt_valid[b][None, :]).any(dim=1)
        out = out | (hit & valid & (points_b == b))
    return out


def make_targets(tab: GridTables, occ_pnts, slot_mask, vcoords, batch, train: bool = False,
                 weights=None, box_weight: float = 1.0, pillar: bool = False,
                 drop_rows=None):
    """The occ subnet's targets (JAX `OccSubnet._make_targets`). occ_pnts
    (N, P, 3+) world-frame cartesian voxel points, slot_mask (N, P),
    vcoords (N, 4). At train, `weights` are the OCC_DENSE_HEAD loss weights
    and `box_weight` DATA_CONFIG.OCC.BOX_WEIGHT. `pillar` (OccTargetsPillar)
    dilates the predict area over the BEV footprint in (y, x) only and
    applies it to the whole z column. `drop_rows` (N,) marks the occ voxel
    rows that dropout zeroed: their cells make `voxel_drop_mask`, the fore
    cells among them `fore_voxel_drop_mask`, which the train loss maps
    weight up by `fore_dropout_cls_weight` / `fore_dropout_reg_weight`."""
    spec = tab.spec
    nx, ny, nz = spec.grid_size
    grid = (nx, ny, nz)
    gt_boxes = batch["gt_boxes"]
    B = gt_boxes.shape[0]
    dev = gt_boxes.device
    rot_z = batch.get("rot_z")
    if rot_z is None:
        rot_z = torch.zeros((B,), dtype=torch.float32, device=dev)
    mirr_flag = batch.get("box_mirr_flag")
    if mirr_flag is None:
        mirr_flag = torch.ones(gt_boxes.shape[:2], dtype=torch.float32, device=dev)
    vcoords = vcoords.long()

    voxelwise = scatter_mask(vcoords, vcoords[:, 0] >= 0, B, grid)
    if pillar:
        kz, ky, kx = spec.dist_kern
        vcc = dilate_predict_area(voxelwise.any(dim=1, keepdim=True), (1, ky, kx),
                                  spec.concede_x).expand_as(voxelwise)
    else:
        vcc = dilate_predict_area(voxelwise, spec.dist_kern, spec.concede_x)

    N, P, _ = occ_pnts.shape
    pts = occ_pnts[..., :3].reshape(N * P, 3)
    pvalid = slot_mask.reshape(N * P)
    pb = vcoords[:, 0].repeat_interleave(P)
    pb = torch.where(pvalid, pb, torch.zeros_like(pb))
    pcoords = vcoords.repeat_interleave(P, dim=0)

    occluded = z_filter(tab, occlusion_mask(tab, pts, pvalid, pb, rot_z, B), voxelwise)

    gt_valid = gt_boxes[..., 7] > 1e-2
    fore_p, mirr_pts, mirr_val = mirror_points_in_boxes_blocked(
        pts, pvalid, gt_boxes, gt_valid, mirr_flag, B)
    fore_mask = scatter_mask(pcoords, fore_p, B, grid)
    cw = centers_world(tab, rot_z) if train else None

    mirr_cell, mirr_inr = points_to_grid_coords(
        world_to_occ_coords(mirr_pts, rot_z[pb], spec.coord_type), tab)
    mirr_coords = torch.cat([pb[:, None], mirr_cell.flip(-1)], dim=1)
    mirr_ok = mirr_val & mirr_inr
    mirr_mask = scatter_mask(mirr_coords, mirr_ok, B, grid) & ~voxelwise

    bm_res = None
    bm_pts = batch.get("bm_points")
    if bm_pts is not None:
        Nbm = bm_pts.shape[1]
        bmp = bm_pts.reshape(B * Nbm, 3)
        bmb = torch.arange(B, device=dev).repeat_interleave(Nbm)
        in_gt = points_in_gt_blocked(bmp, batch["bm_points_mask"].reshape(B * Nbm), gt_boxes,
                                     gt_valid, B)
        bm_cell, bm_inr = points_to_grid_coords(world_to_occ_coords(bmp, rot_z[bmb], spec.coord_type), tab)
        bm_coords = torch.cat([bmb[:, None], bm_cell.flip(-1)], dim=1)
        bm_ok = in_gt & bm_inr
        excl = ~voxelwise & ~mirr_mask
        bm_mask = scatter_mask(bm_coords, bm_ok, B, grid) & excl
        if train:
            bm_res = scatter_mean_res(bmp, bm_coords, bm_ok, cw, B, grid) * excl[..., None]
    else:
        bm_mask = torch.zeros_like(voxelwise)

    general_cls = vcc & occluded
    fore_cls, mirr_cls, bm_cls = fore_mask & general_cls, mirr_mask & general_cls, \
        bm_mask & general_cls
    pos = fore_cls | mirr_cls | bm_cls
    out = {
        "voxelwise_mask": voxelwise,
        "vcc_mask": vcc,
        "occ_voxelwise_mask": occluded,
        "fore_voxelwise_mask": fore_mask,
        "mirr_voxelwise_mask": mirr_mask,
        "bm_voxelwise_mask": bm_mask,
        "pos_mask": pos,
        "neg_mask": general_cls & ~pos,
        "general_cls_loss_mask": general_cls,
    }
    fore_drop = None
    if drop_rows is not None:
        out["voxel_drop_mask"] = scatter_mask(vcoords, drop_rows, B, grid)
        out["fore_voxel_drop_mask"] = fore_drop = fore_mask & out["voxel_drop_mask"]
    if not train:
        return out

    w = weights
    neg = out["neg_mask"]
    cls_f = (fore_cls * w["occ_fore_cls_weight"] + mirr_cls * w["occ_mirr_cls_weight"]
             + bm_cls * w["occ_bm_cls_weight"] + neg * w["occ_neg_cls_weight"]).float()
    if fore_drop is not None and w.get("fore_dropout_cls_weight", 0.0) > 1e-4:
        cls_f = cls_f + (general_cls & fore_drop) * w["fore_dropout_cls_weight"]
    forebox = None
    if box_weight != 1.0:
        hit = box_utils.points_in_boxes_mask(cw.reshape(B, -1, 3), gt_boxes[..., :7])
        forebox = (hit & gt_valid[:, None, :]).any(-1).reshape(voxelwise.shape)
        cls_f = cls_f + (neg & forebox) * (box_weight - w["occ_neg_cls_weight"])
    reg_f = (fore_cls * w.get("occ_fore_res_weight", 0.1)
             + mirr_cls * w.get("occ_mirr_res_weight", 0.1)
             + bm_cls * w.get("occ_bm_res_weight", 0.1)).float()
    reg_m = reg_f > 0
    if fore_drop is not None and w.get("fore_dropout_reg_weight", 0.0) > 1e-4:
        reg_f = reg_f + (reg_m & fore_drop) * w["fore_dropout_reg_weight"]
    fore_res = scatter_mean_res(pts, pcoords, fore_p, cw, B, grid)
    mirr_res = scatter_mean_res(mirr_pts, mirr_coords, mirr_ok, cw, B, grid) \
        * (~voxelwise)[..., None]
    res = fore_res + mirr_res if bm_res is None else fore_res + mirr_res + bm_res
    out.update({
        "general_cls_loss_mask_float": cls_f,
        "general_reg_loss_mask": reg_m,
        "general_reg_loss_mask_float": reg_f,
        "res_mtrx": res * reg_m[..., None],
        "forebox_label": forebox,
    })
    return out
