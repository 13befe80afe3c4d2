"""Voxelizers: the host one of the data pipeline, and the fused PassOccVox
merge + OccVFE of the occ subnet (counterparts of `btcdet_tpu/ops/voxelizer.py`).

Host (`compute_grid_size`, `voxelize_np`): points -> a capacity-padded
voxel table, on the CPU, by the C++ core `csrc/host/voxelizer_core.cpp`
(g++, built at first use; a failed build raises); `voxelize_np_plain` is
its numpy twin, equal bit for bit.

Device (`merge_points_into_voxel_features`): the occ subnet's points are
binned into the det voxel grid and merged
into the det voxel table, and the merged table is reduced straight to the
OccVFE features without ever being built. The JAX package reduces with a
segmented scan over the key-sorted points; here a stable sort fixes the
same kept set and index_add / scatter_reduce accumulate it, so counts,
maxes and coords are exact and the sums differ from the JAX package's by
float32 reassociation only. `merge_points_into_voxels` builds the merged
point table itself (OCC_PNT_UPDATE.FUSED_VFE False, or a det VFE other
than OccVFE): the same kept set, every point copied into its slot, equal
bit for bit to both of the JAX package's merges (`MERGE_IMPL` v1 and v2).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils import trace
from . import kernel_build
from .cuda_conv import INT32_MAX

NEG = -3.0e38   # "no point" in the per-voxel max of the occ code


# ------------------------------------------------------------------- host

def compute_grid_size(point_cloud_range, voxel_size) -> tuple[int, int, int]:
    """(nx, ny, nz): the range over the voxel size, rounded."""
    pr = np.asarray(point_cloud_range, dtype=np.float64)
    vs = np.asarray(voxel_size, dtype=np.float64)
    grid = np.round((pr[3:6] - pr[0:3]) / vs).astype(np.int64)
    return int(grid[0]), int(grid[1]), int(grid[2])


def host_voxelizer() -> ctypes.CDLL:
    """The C++ core, built by g++ at first use (raises if it cannot be)."""
    lib = kernel_build.load_host("voxelizer_core")
    if lib.voxelize.argtypes is None:
        fp, ip = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
        lib.voxelize.restype = ctypes.c_int
        lib.voxelize.argtypes = [fp, ctypes.c_long, ctypes.c_long, fp, fp, ctypes.c_long,
                                 ctypes.c_long, fp, ip, ip]
    return lib


def voxelize_np(points, point_cloud_range, voxel_size, max_points: int, max_voxels: int):
    """Points (N, C) -> (voxels (max_voxels, max_points, C), coords
    (max_voxels, 3) int32 zyx with -1 padding, num_points (max_voxels,)
    int32). Voxels are kept in key order up to `max_voxels`, points within
    a voxel in point order up to `max_points`; cells are found in the
    points' dtype. float32 clouds (under 2**24 points, the C++ core's
    packed sort) run the C++ core; other inputs its numpy twin, as in the
    JAX package."""
    points = np.asarray(points)
    nx, ny, nz = compute_grid_size(point_cloud_range, voxel_size)
    if not (points.dtype == np.float32 and points.ndim == 2 and points.shape[0] < (1 << 24)
            and nx * ny * nz < (1 << 39)):
        return voxelize_np_plain(points, point_cloud_range, voxel_size, max_points, max_voxels)
    lib = host_voxelizer()
    pts = np.ascontiguousarray(points)
    pcr = np.asarray(point_cloud_range, np.float32)
    vs = np.asarray(voxel_size, np.float32)
    C = pts.shape[1]
    voxels = np.empty((max_voxels, max_points, C), np.float32)
    coords = np.empty((max_voxels, 3), np.int32)
    num = np.zeros((max_voxels,), np.int32)
    fp, ip = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
    lib.voxelize(pts.ctypes.data_as(fp), pts.shape[0], C, pcr.ctypes.data_as(fp),
                 vs.ctypes.data_as(fp), max_points, max_voxels, voxels.ctypes.data_as(fp),
                 coords.ctypes.data_as(ip), num.ctypes.data_as(ip))
    return voxels, coords, num


def voxelize_np_plain(points, point_cloud_range, voxel_size, max_points: int,
                      max_voxels: int):
    """`voxelize_np` in numpy: the C++ core's twin."""
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


# ----------------------------------------------------------------- device


def merge_points_into_voxel_features(dvox, dcoords, dnum, opts, ovalid, *, grid_size, lo, vs,
                                     extra: int, max_points: int, num_raw_features: int):
    """Per frame: merge points `opts` into the det voxel table and reduce
    the merged table with OccVFE.

    dvox (B, Nd, Pd, Cd) det voxel point slots (slots past dnum zero);
    dcoords (B, Nd, 4) (b, z, y, x) with each frame's rows key-sorted
    valid-first (-1 padding); dnum (B, Nd); opts (B, K, C6) new points
    (xyz, `num_raw_features - 3` more head channels, then the occ-code
    tail); ovalid (B, K). grid_size (nx, ny, nz), lo / vs the det grid's
    origin and voxel size, (3,) float32 tensors on the points' device.

    Kept set (the JAX package's exactly): each point lands in the det
    voxel of its clamped cell; within a cell points keep point order. A
    point hitting a det voxel takes slot dnum + (its rank in the cell) and
    is kept below `max_points`; cells no det voxel holds become new rows
    in key order, at most `extra` of them a frame, each keeping its first
    `max_points` points. Det points count as raw points with a zero
    occ-code tail; a new point is an occ point when its last channel is
    >= 0.05 (OccVFE's test).

    Returns (features (B, Nd+extra, nrf+ncode), occ_code (B, Nd+extra,
    ncode), num (B, Nd+extra), coords_zyx (B, Nd+extra, 3), row_valid
    (B, Nd+extra)); rows [0, Nd) are the det rows, [Nd, Nd+extra) the new
    ones."""
    B, Nd, Pd, Cd = dvox.shape
    K, C6 = opts.shape[1], opts.shape[2]
    nrf = num_raw_features
    ncode = C6 - nrf
    assert Cd <= nrf + ncode and ncode >= 1
    dev = opts.device
    R = Nd + extra

    dc, dvalid, dkey = _det_keys(dcoords, grid_size)
    order, row, _, kept, ekey = _merge_plan(dkey, dnum, opts, ovalid, grid_size, lo, vs, extra,
                                            max_points)
    sp = torch.gather(opts, 1, order[..., None].expand(B, K, C6))

    # destination row of every kept point, flattened over frames
    frame = torch.arange(B, device=dev)[:, None] * R
    with trace.readback("merge.kept_points"):
        dest = (frame + row)[kept]
        pk = sp[kept]
    is_occ = pk[:, -1] >= 0.05
    head, tail = pk[:, :nrf], pk[:, nrf:]
    zero = torch.zeros((), device=dev)
    sum_raw = torch.zeros((B * R, nrf), device=dev).index_add_(
        0, dest, torch.where(is_occ[:, None], zero, head))
    sum_occ = torch.zeros((B * R, nrf), device=dev).index_add_(
        0, dest, torch.where(is_occ[:, None], head, zero))
    cnt_raw = torch.zeros(B * R, dtype=torch.long, device=dev).index_add_(
        0, dest, (~is_occ).long())
    cnt_occ = torch.zeros(B * R, dtype=torch.long, device=dev).index_add_(
        0, dest, is_occ.long())
    tail_max = torch.full((B * R, ncode), NEG, device=dev).scatter_reduce_(
        0, dest[:, None].expand(-1, ncode), tail, reduce="amax")

    # det-side contribution: every det point is raw with a zero tail
    dn = dnum.long()
    dmask = (torch.arange(Pd, device=dev) < dn[..., None]) & dvalid[..., None]
    det_sum = torch.where(dmask[..., None], dvox[..., :nrf], zero).sum(dim=2)   # (B, Nd, nrf)
    det_cnt = torch.where(dvalid, dn, torch.zeros_like(dn))
    pad = torch.zeros((B, extra), dtype=torch.long, device=dev)
    sum_raw = sum_raw.reshape(B, R, nrf) + torch.cat(
        [det_sum, torch.zeros((B, extra, nrf), device=dev)], dim=1)
    raw_n = cnt_raw.reshape(B, R) + torch.cat([det_cnt, pad], dim=1)
    cnt_occ = cnt_occ.reshape(B, R)
    tail_max = tail_max.reshape(B, R, ncode)
    has_det_pt = torch.cat([det_cnt > 0, pad > 0], dim=1)
    tail_max = torch.where(has_det_pt[..., None], tail_max.clamp(min=0.0), tail_max)
    occ_code = torch.where(tail_max <= NEG / 2, zero, tail_max)

    f_raw = sum_raw / raw_n[..., None].float().clamp(min=1.0)
    f_occ = sum_occ.reshape(B, R, nrf) / cnt_occ[..., None].float().clamp(min=1.0)
    occ_only = (cnt_occ > 0) & (raw_n < 1)
    features = torch.cat([f_raw + occ_only[..., None].float() * f_occ, occ_code], dim=-1)

    coords_zyx = torch.cat([dc[..., 1:4], _decode_keys(ekey, grid_size)], dim=1).to(torch.int32)
    row_valid = torch.cat([dvalid, ekey != INT32_MAX], dim=1)
    return features, occ_code, raw_n + cnt_occ, coords_zyx, row_valid


def _det_keys(dcoords, grid_size):
    """(coords as int64, row valid, cell key with INT32_MAX on padding) of
    det rows (..., 4) (b, z, y, x)."""
    nxd, nyd, _ = (int(v) for v in grid_size)
    dc = dcoords.long()
    dvalid = dc[..., 0] >= 0
    dkey = torch.where(dvalid, (dc[..., 1] * nyd + dc[..., 2]) * nxd + dc[..., 3],
                       torch.full_like(dc[..., 0], INT32_MAX))
    return dc, dvalid, dkey


def _merge_plan(dkey, dnum, opts, ovalid, grid_size, lo, vs, extra: int, max_points: int):
    """The kept set of a merge (the JAX package's `merge_points_into_voxels`
    and its v2, which agree bit for bit), per frame: the points sorted by
    det cell key (stable), and for each its destination row (a det row for
    a hit, Nd + the cell's rank among the missing cells otherwise), its
    slot, and whether it is kept; the new rows' keys (INT32_MAX pads).
    dkey (B, Nd) int64 cell keys of the det rows, key-sorted valid-first.
    Tallies the new cells a frame offered and those kept as rows
    (`occ.merge.new_cells` / `occ.merge.new_rows`)."""
    nxd, nyd, nzd = (int(v) for v in grid_size)
    B, K = ovalid.shape
    Nd = dkey.shape[1]
    dev = opts.device
    cell = torch.floor((opts[..., :3] - lo) / vs).long()
    # out-of-range points are clamped into the edge voxels, not dropped
    # (reference `trans_voxel_grid`)
    cx, cy, cz = (cell[..., i].clamp(0, n - 1) for i, n in enumerate((nxd, nyd, nzd)))
    okey = torch.where(ovalid, (cz * nyd + cy) * nxd + cx, torch.full_like(cx, INT32_MAX))
    sk, order = torch.sort(okey, dim=1, stable=True)
    pos = torch.arange(K, device=dev).expand(B, K)
    first = torch.ones_like(sk, dtype=torch.bool)
    first[:, 1:] = sk[:, 1:] != sk[:, :-1]
    slot = pos - torch.cummax(torch.where(first, pos, torch.zeros_like(pos)), dim=1).values
    live = sk != INT32_MAX
    il = torch.searchsorted(dkey, sk).clamp(max=Nd - 1)
    hit = (torch.gather(dkey, 1, il) == sk) & live
    dest_slot = torch.gather(dnum.long(), 1, il) + slot
    keep_h = hit & (dest_slot < max_points)
    miss_head = live & ~hit & first
    nrank = torch.cumsum(miss_head.long(), dim=1) - 1
    keep_m = ~hit & live & (nrank >= 0) & (nrank < extra) & (slot < max_points)
    row = torch.where(hit, il, Nd + nrank)
    new_head = miss_head & (nrank < extra)
    trace.tally("occ.merge.new_cells", lambda: miss_head.sum(1))
    trace.tally("occ.merge.new_rows", lambda: new_head.sum(1))
    frame = torch.arange(B, device=dev)[:, None] * extra
    ekey = torch.full((B * extra,), INT32_MAX, dtype=torch.long, device=dev)
    with trace.readback("merge.new_keys"):
        ekey[(frame + nrank)[new_head]] = sk[new_head]
    return (order, row, torch.where(hit, dest_slot, slot), keep_h | keep_m,
            ekey.reshape(B, extra))


def _decode_keys(ekey, grid_size):
    """(B, E) cell keys -> (B, E, 3) (z, y, x), -1 where the key pads."""
    nxd, nyd, _ = (int(v) for v in grid_size)
    ez = ekey // (nyd * nxd)
    ey = (ekey - ez * (nyd * nxd)) // nxd
    ex = ekey - ez * (nyd * nxd) - ey * nxd
    return torch.where((ekey == INT32_MAX)[..., None], torch.full_like(ekey[..., None], -1),
                       torch.stack([ez, ey, ex], dim=-1))


def merge_points_into_voxels(dvox, dcoords, dnum, opts, ovalid, *, grid_size, lo, vs,
                             extra: int, max_points: int):
    """Per frame: merge points `opts` into the det voxel table and return
    the merged point table (the JAX package's `merge_points_into_voxels`,
    and its `merge_points_into_voxels_v2`, equal to it bit for bit).

    dvox (B, Nd, max_points, C) det voxel point slots (slots past dnum
    zero), already widened to the points' channels; dcoords (B, Nd, 4) (b,
    z, y, x), each frame's rows key-sorted valid-first (-1 padding); dnum
    (B, Nd); opts (B, K, C) new points (xyz leading); ovalid (B, K).
    grid_size (nx, ny, nz); lo / vs the det grid's origin and voxel size,
    (3,) float32 tensors on the points' device.

    The kept set is `merge_points_into_voxel_features`'s: a point hitting a
    det voxel takes slot dnum + (its rank in the cell) below `max_points`;
    cells no det voxel holds become new rows in key order, at most `extra`
    a frame. Every kept point is copied into its slot, so the table is
    exact, and a gradient reaches the kept points' values.

    Returns (vox (B, Nd+extra, max_points, C), num (B, Nd+extra), coords_zyx
    (B, Nd+extra, 3) int32, row_valid (B, Nd+extra)); rows [0, Nd) are the
    det rows, [Nd, Nd+extra) the new ones."""
    B, Nd, P, C = dvox.shape
    K = opts.shape[1]
    dev = opts.device
    R = Nd + extra
    dc, dvalid, dkey = _det_keys(dcoords, grid_size)
    order, row, slot, kept, ekey = _merge_plan(dkey, dnum, opts, ovalid, grid_size, lo, vs,
                                               extra, max_points)
    sp = torch.gather(opts, 1, order[..., None].expand(B, K, C))
    frame = torch.arange(B, device=dev)[:, None] * R
    dest = ((frame + row) * P + slot)[kept]
    base = torch.cat([dvox, dvox.new_zeros((B, extra, P, C))], dim=1).reshape(B * R * P, C)
    vox = base.index_put((dest,), sp[kept].to(dvox.dtype)).reshape(B, R, P, C)
    num = torch.cat([dnum.long(), torch.zeros((B, extra), dtype=torch.long, device=dev)], 1)
    num = num.reshape(-1).index_add(0, (frame + row)[kept],
                                    torch.ones_like(dest)).reshape(B, R).to(dnum.dtype)
    coords_zyx = torch.cat([dc[..., 1:4], _decode_keys(ekey, grid_size)], dim=1).to(torch.int32)
    row_valid = torch.cat([dvalid, ekey != INT32_MAX], dim=1)
    return vox, num, coords_zyx, row_valid
