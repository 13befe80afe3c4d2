"""Occupancy subnet (counterpart of `btcdet_tpu/models/occ/occ_subnet.py`,
reference module topology
occ_targets -> vfe -> backbone_3d -> occ_dense_head -> occ_pnt_update).

  point chain  the occ voxels' points back to cartesian, the target masks
               (`occ_targets.make_targets`; TARGETS.NAME OccTargetsPillar dilates the predict area over
               the BEV footprint), the plain-mean occ VFE (of the absolute
               xyz, the raw voxel points or both, OCC.USE_ABSXYZ) scattered
               into the dense occ grid
  backbone     BACKBONE_3D.NAME: `VoxelBackBoneDeconv`, `VoxelBackBoneDeconvRes`
               or `VoxelBackBoneInverseRes` (dense masked conv3d on the grid)
  head         OccHead3D: 3x3x3 `conv_cls` (occupancy logits, softmax or
               sigmoid) and `conv_res` (residuals); OccHead2D: 3x3 convs over
               the BEV grid with z folded into channels, predicting every z
               of a column; the probability is masked to
               `general_cls_loss_mask`
  PassOccVox   threshold, top-K, cell centre + residual -> occ points;
               then the fused merge + OccVFE into the det voxel table, or
               (`fused_vfe` False) the merged point table itself
               (OCC_PNT_UPDATE.DB_PROJ first expands each occ point onto
               the det cells of its occ voxel, for the merge only)

The selection uses the TRAIN `OCC_THRESH` at eval too, with the eval
point cap: the reference's `EVAL_OCC_THRESH` quirk, kept on purpose.

The reference runs the eval forward only, without a gradient.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import voxelizer
from ...utils import coords
from .. import backbones_3d
from . import occ_targets as T

# point slots of a merged det voxel (the JAX package's `det_max_points_merged`)
MAX_POINTS_MERGED = 8


class _HeadConv(nn.Module):
    """Dense 3x3x3 conv holding `weight` in the spconv layout (kz, ky, kx,
    Cin, Cout) and an optional bias (reference `conv_cls.0`)."""

    out_axis = -1   # of the weight, for `common.jax_default_init_`

    def __init__(self, cin, cout, bias: bool):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(3, 3, 3, cin, cout))
        nn.init.normal_(self.weight, std=0.001)
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        return F.conv3d(x.float(), self.weight.permute(4, 3, 0, 1, 2), self.bias, padding=1)


class _HeadConv2D(nn.Module):
    """OccHead2D's dense 3x3 conv over the BEV grid (torch Conv2d layout
    (Cout, Cin, 3, 3), optional bias). It reads the (B, C, nz, ny, nx)
    volume with z folded into channels, z-major (z * C + c), and returns
    (B, nz * cout_per_z, ny, nx), also z-major."""

    out_axis = 0    # of the weight, for `common.jax_default_init_`

    def __init__(self, cin, cout, bias: bool):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
        nn.init.normal_(self.weight, std=0.001)
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        B, C, D, H, W = x.shape
        bev = x.float().permute(0, 2, 1, 3, 4).reshape(B, D * C, H, W)
        return F.conv2d(bev, self.weight, self.bias, padding=1)


def _occ_frame(xyz, rot_z, coord_type: str):
    """World-frame cartesian points (B, M, 3) -> sensor-frame occ coords,
    rot_z (B,) degrees (`occ_targets.world_to_occ_coords` per point)."""
    B, M, _ = xyz.shape
    return T.world_to_occ_coords(xyz.reshape(B * M, 3), rot_z.repeat_interleave(M),
                                 coord_type).reshape(B, M, 3)


def db_proj_expand(xyz, tail, valid, src_cell, rot_z, *, det_lo, det_vs, det_grid, occ_lo,
                   occ_vs, coord_type: str, expand=(1.0, 5.0, 3.0), stride=(1.0, 2.5, 1.5)):
    """DB_PROJ (reference `add_occ_template.py:45` `db_proj_func`; the JAX
    package's `db_proj_expand`): each occ point expands onto a lattice of
    candidates around its det cell, offsets from -expand to +expand in
    steps of `stride` det cells ((z, y, x) like the reference); a candidate
    is kept where it lies in the det grid and its det cell centre still
    falls in the point's source occ voxel.

    xyz (B, K, 3) world-frame occ points; tail (B, K, Ct) features copied
    onto every kept candidate; valid (B, K); src_cell (B, K, 3) int occ
    cell (x, y, z); rot_z (B,) degrees. Returns ((B, K*E, 3+Ct) candidate
    det cell centres + tail, (B, K*E) kept), E candidates a point."""
    offs = [np.arange(-e, e + 1, s, dtype=np.float32) for e, s in zip(expand, stride)]
    oz, oy, ox = np.meshgrid(*offs, indexing="ij")
    dev = xyz.device
    off = torch.from_numpy(np.stack([ox, oy, oz], -1).reshape(1, 1, -1, 3)).to(dev)
    E = off.shape[2]
    B, K = valid.shape
    det_lo = torch.tensor(det_lo, dtype=torch.float32, device=dev)
    det_vs = torch.tensor(det_vs, dtype=torch.float32, device=dev)
    gs = torch.tensor(det_grid, dtype=torch.float32, device=dev)
    # det cell of the (residual-shifted) point, clamped like the reference's
    # trans_voxel_grid
    c0 = torch.minimum(torch.floor((xyz - det_lo) / det_vs).clamp(min=0), gs - 1)
    cand = c0[:, :, None, :] + off                                     # (B, K, E, 3)
    loc = (cand + 0.5) * det_vs + det_lo
    inr = ((cand >= 0) & (cand <= gs - 1)).all(-1)
    occ_loc = _occ_frame(loc.reshape(B, -1, 3), rot_z, coord_type)
    ocell = torch.floor((occ_loc - torch.tensor(occ_lo, dtype=torch.float32, device=dev))
                        / torch.tensor(occ_vs, dtype=torch.float32, device=dev)).long()
    pick = (ocell.reshape(B, K, E, 3) == src_cell.long()[:, :, None, :]).all(-1)
    keep = pick & inr & valid[:, :, None]
    pts = torch.cat([loc, tail[:, :, None, :].expand(B, K, E, tail.shape[-1])], dim=-1)
    pts = torch.where(keep[..., None], pts, torch.zeros((), dtype=pts.dtype, device=dev))
    return pts.reshape(B, K * E, -1), keep.reshape(B, K * E)


class OccSubnet(nn.Module):
    """`MODEL.OCC`. The parameters sit under `backbone_3d` and
    `occ_dense_head` (reference `occ_modules.*` names)."""

    def __init__(self, model_cfg, data_cfg, point_cloud_range, det_voxel_size,
                 num_point_features: int = 4, fused_vfe: bool = True):
        super().__init__()
        occ_d = data_cfg.OCC
        p = model_cfg.PARAMS
        upd = model_cfg.OCC_PNT_UPDATE
        head = model_cfg.OCC_DENSE_HEAD
        # a cartesian occ grid reaches no model (the host processor refuses it)
        if occ_d.COORD_TYPE == "cartesian":
            raise NotImplementedError("occ subnet option OCC.COORD_TYPE cartesian is not ported")
        # both of the JAX package's merges build the same table bit for bit
        if upd.get("MERGE_IMPL", "v1") not in ("v1", "v2"):
            raise KeyError(f"unknown OCC_PNT_UPDATE.MERGE_IMPL {upd.MERGE_IMPL!r}")
        # the fused merge + OccVFE, or the materialized merged point table
        # (`det_voxels`) for the det VFE to reduce
        self.fused_vfe = bool(fused_vfe)
        self.targets_name = model_cfg.get("TARGETS", {}).get("NAME", "OccTargets3D")
        if self.targets_name not in ("OccTargets3D", "OccTargetsPillar"):
            raise KeyError(f"unknown occ TARGETS.NAME {self.targets_name!r}")
        self.head_name = head.get("NAME", "OccHead3D")
        if self.head_name not in ("OccHead3D", "OccHead2D"):
            raise KeyError(f"unknown OCC_DENSE_HEAD.NAME {self.head_name!r}")
        bb_cls = backbones_3d.OCC_BACKBONES[model_cfg.get("BACKBONE_3D", {}).get(
            "NAME", "VoxelBackBoneDeconv")]
        self.spec = T.build_grid_spec(data_cfg)
        self.grid = T.GridTables(self.spec)
        self.occ_thresh = float(p.OCC_THRESH)
        self.eval_max_occ_pnts = int(p.get("EVAL_MAX_NUM_OCC_PNTS", p.MAX_NUM_OCC_PNTS))
        self.use_absxyz = occ_d.get("USE_ABSXYZ", "original")
        self.db_proj = bool(upd.get("DB_PROJ", False))
        self.db_proj_geometry = (tuple(upd.get("DB_PROJ_EXPAND", (1.0, 5.0, 3.0))),
                                 tuple(upd.get("DB_PROJ_STRIDE", (1.0, 2.5, 1.5))))
        self.reg = bool(p.get("REG", False))
        self.res_num_dim = int(occ_d.get("RES_NUM_DIM", 3))
        self.code_num_dim = int(occ_d.get("CODE_NUM_DIM", 2))
        self.default_inten = float(occ_d.get("INTEN", 0.0) or 0.0)
        self.is_softmax = head.LOSS_CONFIG.get("CLS_LOSS_TYPE", "") == "softmax"
        self.merged_cap_extra = upd.get("MERGED_CAP_EXTRA")
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        self.det_voxel_size = tuple(float(v) for v in det_voxel_size)
        self.num_point_features = int(num_point_features)
        self.register_buffer("det_lo", torch.tensor(self.point_cloud_range[:3],
                                                       dtype=torch.float32), persistent=False)
        self.register_buffer("det_vs", torch.tensor(self.det_voxel_size, dtype=torch.float32), persistent=False)

        channels = tuple(model_cfg.get("BACKBONE_3D", {}).get("CHANNELS", (16, 32, 64)))
        # the VFE's input: absxyz + intensity, the raw voxel point (uvd +
        # intensity), or both
        vfe_channels = 7 if self.use_absxyz == "both" else 4
        self.backbone_3d = bb_cls(vfe_channels, channels)
        cls_ch = 2 if self.is_softmax else 1
        dh = nn.Module()
        if self.head_name == "OccHead2D":
            nz = self.spec.grid_size[2]
            dh.conv_cls = nn.ModuleList([_HeadConv2D(nz * channels[1], nz * cls_ch, True)])
            if self.reg:
                dh.conv_res = nn.ModuleList([_HeadConv2D(nz * channels[1],
                                                         nz * self.res_num_dim, False)])
                dh.conv_res[0].own_init = True     # std 0.001, as in the JAX package
        else:
            dh.conv_cls = nn.ModuleList([_HeadConv(channels[1], cls_ch, True)])
            if self.reg:
                dh.conv_res = nn.ModuleList([_HeadConv(channels[1], self.res_num_dim, False)])
        # the JAX package's focal prior (pi = PRIOR_PROB): the occupied logit,
        # the last channel of each z's cls_ch, starts at logit(pi)
        prior = float(head.get("PRIOR_PROB", 0.01))
        with torch.no_grad():
            dh.conv_cls[0].bias.view(-1, cls_ch)[:, -1] = float(np.log(prior / (1.0 - prior)))
        dh.conv_cls[0].prior_bias = True
        self.occ_dense_head = dh

    @torch.no_grad()
    def forward(self, batch: dict) -> dict:
        """Returns the target masks, `probs` (B, nz, ny, nx), `res_pred`,
        `occ_points` (B, K, 4) xyz + prob / `occ_points_mask` (B, K), the
        merged det table: `det_voxel_features` (B*(Nd/B+extra), 4 + code) and
        `det_occ_code`, or without `fused_vfe` the merged points `det_voxels`
        (B*(Nd/B+extra), MAX_POINTS_MERGED, 4 + code), then
        `det_voxel_coords` (b, z, y, x), `det_voxel_num_points`."""

        spec = self.spec
        nx, ny, nz = spec.grid_size
        vox = batch["occ_voxels"]
        vc = batch["occ_voxel_coords"].long()
        vn = batch["occ_voxel_num_points"]
        B = batch["gt_boxes"].shape[0]
        dev = vox.device
        zero = torch.zeros((), device=dev)
        cvalid = vc[:, 0] >= 0
        slot = (torch.arange(vox.shape[1], device=dev)[None, :] < vn[:, None]) & cvalid[:, None]
        pts_abs = coords.occ_uvd_to_absxyz(vox[..., 0], vox[..., 1], vox[..., 2],
                                           spec.coord_type)
        occ_pnts = torch.cat([pts_abs, vox[..., 3:]], dim=-1)
        out = T.make_targets(self.grid, occ_pnts, slot, vc, batch,
                             pillar=self.targets_name == "OccTargetsPillar")

        # occ VFE: plain mean over the filled slots
        if self.use_absxyz in (True, "absxyz"):
            vfe_in = occ_pnts
        elif self.use_absxyz == "both":
            vfe_in = torch.cat([pts_abs, vox], dim=-1)
        else:
            vfe_in = vox
        n = torch.where(cvalid, vn, torch.zeros_like(vn))
        fmask = torch.arange(vox.shape[1], device=dev)[None, :] < n[:, None]
        feat = torch.where(fmask[..., None], vfe_in, zero).sum(1) / n[:, None].float().clamp(min=1.0)
        ncell = nz * ny * nx
        lin = (vc[:, 1] * ny + vc[:, 2]) * nx + vc[:, 3]
        idx = torch.where(cvalid, vc[:, 0] * ncell + lin, torch.full_like(lin, B * ncell))
        dense = torch.zeros((B * ncell + 1, feat.shape[-1]), device=dev)
        dense[idx] = torch.where(cvalid[:, None], feat, zero)
        dense = dense[:-1].reshape(B, nz, ny, nx, -1).permute(0, 4, 1, 2, 3)

        x, _ = self.backbone_3d(dense, out["voxelwise_mask"])
        dh = self.occ_dense_head
        logits = self._head(dh.conv_cls[0], x, 2 if self.is_softmax else 1)
        if self.is_softmax:
            prob = torch.softmax(logits, dim=-1)[..., -1]
        else:
            prob = torch.sigmoid(logits[..., -1])
        out["probs"] = prob * out["general_cls_loss_mask"].float()
        res_pred = self._head(dh.conv_res[0], x, self.res_num_dim) if self.reg else None
        out["res_pred"] = res_pred
        self._pass_occ_vox(batch, out, out["probs"], res_pred, B, self.eval_max_occ_pnts)
        return out

    def _head(self, conv, x, ch: int):
        """A head conv's output as (B, nz, ny, nx, ch)."""
        y = conv(x)
        if self.head_name == "OccHead2D":
            B, _, H, W = y.shape
            return y.reshape(B, -1, ch, H, W).permute(0, 1, 3, 4, 2)
        return y.permute(0, 2, 3, 4, 1)

    def _pass_occ_vox(self, batch, out, masked_prob, res_pred, B, K):
        spec = self.spec
        nx, ny, nz = spec.grid_size
        dev = masked_prob.device
        rot_z = batch.get("rot_z")
        if rot_z is None:
            rot_z = torch.zeros((B,), device=dev)
        use_gate = batch.get("use_occ_prob")
        if use_gate is None:
            use_gate = torch.ones((B,), dtype=torch.bool, device=dev)
        zero = torch.zeros((), device=dev)

        flat = masked_prob.reshape(B, -1)
        sel = torch.where(flat > self.occ_thresh, flat, zero)
        K = min(K, flat.shape[1])
        # top-K with lax.top_k's order: values descending, ties by index
        top_prob, top_idx = torch.sort(sel, dim=1, descending=True, stable=True)
        top_prob, top_idx = top_prob[:, :K], top_idx[:, :K]
        valid = (top_prob > 0) & use_gate[:, None]

        zc = top_idx // (ny * nx)
        yc = (top_idx - zc * (ny * nx)) // nx
        xc = top_idx - zc * (ny * nx) - yc * nx
        pcr, vs = spec.point_cloud_range, spec.voxel_size
        cu = pcr[0] + (xc.float() + 0.5) * vs[0]
        cv = pcr[1] + (yc.float() + 0.5) * vs[1] - rot_z[:, None]   # sensor -> world azimuth
        cd = pcr[2] + (zc.float() + 0.5) * vs[2]
        xyz = coords.occ_uvd_to_absxyz(cu, cv, cd, spec.coord_type)   # (B, K, 3)
        if res_pred is not None:
            res = torch.gather(res_pred.reshape(B, -1, self.res_num_dim), 1,
                               top_idx[..., None].expand(B, K, self.res_num_dim))
            xyz = xyz + res[..., :3]
        out["occ_points"] = torch.where(valid[..., None],
                                        torch.cat([xyz, top_prob[..., None]], dim=-1), zero)
        out["occ_points_mask"] = valid

        # merge into the det voxel table, reduced by OccVFE on the fly
        det_vox = batch["det_voxels"]
        Nd, Pd, Cd = det_vox.shape
        per_frame = Nd // B
        inten = torch.full_like(top_prob[..., None], self.default_inten)
        feats = [xyz, inten] + ([torch.zeros_like(inten)] if Cd > 4 else [])
        feats.append(top_prob[..., None])
        if self.code_num_dim > 1:
            feats.append(torch.ones_like(inten))
        occ_pts6 = torch.where(valid[..., None], torch.cat(feats, dim=-1), zero)
        merge_pts, merge_valid = occ_pts6, valid
        grid_size = voxelizer.compute_grid_size(self.point_cloud_range, self.det_voxel_size)
        if self.db_proj:
            # the expansion feeds the merge only: the ConvHead's occ points
            # above are the unexpanded ones (reference pass_occ_vox.py:36-43)
            merge_pts, merge_valid = db_proj_expand(
                xyz, occ_pts6[..., 3:], valid, torch.stack([xc, yc, zc], dim=-1), rot_z,
                det_lo=self.point_cloud_range[:3], det_vs=self.det_voxel_size,
                det_grid=grid_size, occ_lo=spec.point_cloud_range[:3], occ_vs=spec.voxel_size,
                coord_type=spec.coord_type, expand=self.db_proj_geometry[0],
                stride=self.db_proj_geometry[1])
        det_vox = det_vox.reshape(B, per_frame, Pd, Cd)
        det_num = batch["det_voxel_num_points"].reshape(B, per_frame).clamp(0, Pd)
        # K // 4 new rows a frame unless MERGED_CAP_EXTRA says otherwise (set
        # it under DB_PROJ, whose candidates would overflow that)
        extra = int(self.merged_cap_extra if self.merged_cap_extra is not None else K // 4)
        merged = per_frame + extra
        det_coords = batch["det_voxel_coords"].reshape(B, per_frame, 4)
        kw = dict(grid_size=grid_size, lo=self.det_lo, vs=self.det_vs, extra=extra,
                  max_points=MAX_POINTS_MERGED)
        if self.fused_vfe:
            feat, occ_code, num, coords_zyx, row_valid = \
                voxelizer.merge_points_into_voxel_features(
                    det_vox, det_coords, det_num, merge_pts, merge_valid,
                    num_raw_features=self.num_point_features, **kw)
            rv = row_valid[..., None]
            out["det_voxel_features"] = torch.where(rv, feat, zero).reshape(B * merged, -1)
            out["det_occ_code"] = torch.where(rv, occ_code, zero).reshape(B * merged, -1)
        else:
            # det points widened to the occ points' channels (a zero occ-code
            # tail) and to the merged point slots
            C6 = occ_pts6.shape[-1]
            det_vox6 = F.pad(det_vox, (0, C6 - Cd, 0, MAX_POINTS_MERGED - Pd))
            vox, num, coords_zyx, row_valid = voxelizer.merge_points_into_voxels(
                det_vox6, det_coords, det_num, merge_pts, merge_valid, **kw)
            out["det_voxels"] = vox.reshape(B * merged, MAX_POINTS_MERGED, C6)
        b = torch.arange(B, device=dev, dtype=torch.int32)[:, None, None].expand(B, merged, 1)
        coords4 = torch.cat([b, coords_zyx], dim=-1)
        out["det_voxel_coords"] = torch.where(row_valid[..., None], coords4,
                                              torch.full_like(coords4, -1)).reshape(B * merged, 4)
        out["det_voxel_num_points"] = torch.where(row_valid, num, torch.zeros_like(num)) \
            .reshape(B * merged)
