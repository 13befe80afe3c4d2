"""Occupancy subnet (counterpart of `btcdet_tpu/models/occ/occ_subnet.py`,
reference module topology
occ_targets -> vfe -> backbone_3d -> occ_dense_head -> occ_pnt_update).

  point chain  the occ voxels' points back to cartesian, the target masks
               (`occ_targets.make_targets`; the loss maps too at train),
               the plain-mean occ VFE scattered into the dense occ grid
  backbone     `VoxelBackBoneDeconv` (dense masked conv3d on the grid)
  head         OccHead3D: 3x3x3 `conv_cls` (softmax occupancy) and
               `conv_res` (residuals); the probability is masked to
               `general_cls_loss_mask`
  PassOccVox   threshold, top-K, cell centre + residual -> occ points;
               then the fused merge + OccVFE into the det voxel table

The selection uses the TRAIN `OCC_THRESH` at eval too, with the eval
point cap: the reference's `EVAL_OCC_THRESH` quirk, kept on purpose.

In train mode the forward also returns `loss` (softmax focal on the
occupancy logits plus the residual smooth-L1, `_get_loss`); PassOccVox
takes MAX_NUM_OCC_PNTS points and, under OCC_PNT_UPDATE.PASS_GRAD False,
runs without a gradient (the JAX package's stop-gradient of the occ points
and the merged det table).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import voxelizer
from ...parallel import all_reduce_sum
from ...utils import coords, loss_utils
from .. import backbones_3d
from . import occ_targets as T

# point slots of a merged det voxel (the JAX package's `det_max_points_merged`)
MAX_POINTS_MERGED = 8


class _HeadConv(nn.Module):
    """Dense 3x3x3 conv holding `weight` in the spconv layout (kz, ky, kx,
    Cin, Cout) and an optional bias (reference `conv_cls.0`)."""

    def __init__(self, cin, cout, bias: bool):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(3, 3, 3, cin, cout))
        nn.init.normal_(self.weight, std=0.001)
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        return F.conv3d(x.float(), self.weight.permute(4, 3, 0, 1, 2), self.bias, padding=1)


class OccSubnet(nn.Module):
    """`MODEL.OCC` eval forward. The parameters sit under `backbone_3d` and
    `occ_dense_head` (reference `occ_modules.*` names)."""

    def __init__(self, model_cfg, data_cfg, point_cloud_range, det_voxel_size,
                 num_point_features: int = 4):
        super().__init__()
        occ_d = data_cfg.OCC
        p = model_cfg.PARAMS
        upd = model_cfg.OCC_PNT_UPDATE
        head = model_cfg.OCC_DENSE_HEAD
        for key, ok in (("TARGETS.NAME", model_cfg.get("TARGETS", {}).get("NAME", "OccTargets3D")
                         == "OccTargets3D"),
                        ("OCC_DENSE_HEAD.NAME", head.get("NAME", "OccHead3D") == "OccHead3D"),
                        ("BACKBONE_3D.NAME", model_cfg.get("BACKBONE_3D", {}).get(
                            "NAME", "VoxelBackBoneDeconv") == "VoxelBackBoneDeconv"),
                        ("OCC_PNT_UPDATE.DB_PROJ", not upd.get("DB_PROJ", False)),
                        ("OCC_PNT_UPDATE.FUSED_VFE False", bool(upd.get("FUSED_VFE", True))),
                        ("OCC_PNT_UPDATE.MERGE_IMPL", upd.get("MERGE_IMPL") is None),
                        ("OCC.COORD_TYPE cartesian", occ_d.COORD_TYPE != "cartesian"),
                        ("OCC.USE_ABSXYZ", occ_d.get("USE_ABSXYZ", "original") in (True, "absxyz")),
                        ("OCC.REVERSE_VIS", occ_d.get("REVERSE_VIS", "NOTHING") == "NOTHING")):
            if not ok:
                raise NotImplementedError(f"occ subnet option {key} is not ported")
        self.spec = T.build_grid_spec(data_cfg)
        self.grid = T.GridTables(self.spec)
        self.occ_thresh = float(p.OCC_THRESH)
        self.max_occ_pnts = int(p.MAX_NUM_OCC_PNTS)
        self.eval_max_occ_pnts = int(p.get("EVAL_MAX_NUM_OCC_PNTS", p.MAX_NUM_OCC_PNTS))
        # train-only options the port refuses when a train step meets them
        self.train_refusals = [k for k, on in (
            ("OCC.DROPOUT_RATE", float(occ_d.get("DROPOUT_RATE", 0.0) or 0.0) > 1e-3),
            ("PARAMS.REMAIN_PERCENTAGE", p.get("REMAIN_PERCENTAGE") is not None),
            ("OCC_PNT_UPDATE.PASS_GRAD", bool(upd.get("PASS_GRAD", False))),
            ("OCC_DENSE_HEAD.LOSS_CONFIG.CLS_LOSS_TYPE not softmax",
             head.LOSS_CONFIG.get("CLS_LOSS_TYPE", "") != "softmax")) if on]
        self.box_weight = float(occ_d.get("BOX_WEIGHT", 1.0))
        lw = head.LOSS_CONFIG.LOSS_WEIGHTS
        self.loss_weights = {k: float(v) for k, v in lw.items()
                             if not isinstance(v, (list, tuple))}
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
        self.backbone_3d = backbones_3d.VoxelBackBoneDeconv(4, channels)
        dh = nn.Module()
        dh.conv_cls = nn.ModuleList([_HeadConv(channels[1], 2 if self.is_softmax else 1, True)])
        if self.reg:
            dh.conv_res = nn.ModuleList([_HeadConv(channels[1], self.res_num_dim, False)])
        self.occ_dense_head = dh

    def forward(self, batch: dict) -> dict:
        """Returns the target masks, `probs` (B, nz, ny, nx), `res_pred`,
        `occ_points` (B, K, 4) xyz + prob / `occ_points_mask` (B, K), the
        merged det table: `det_voxel_features` (B*(Nd/B+extra), 4 + code),
        `det_occ_code`, `det_voxel_coords` (b, z, y, x), `det_voxel_num_points`;
        in train mode also the loss maps and `loss`. Eval runs without a
        gradient."""
        if self.training:
            if self.train_refusals:
                raise NotImplementedError(f"occ subnet train options not ported: "
                                          f"{self.train_refusals}")
            return self._forward(batch, train=True)
        with torch.no_grad():
            return self._forward(batch, train=False)

    def _forward(self, batch: dict, train: bool) -> dict:
        spec = self.spec
        nx, ny, nz = spec.grid_size
        vox = batch["occ_voxels"]
        vc = batch["occ_voxel_coords"].long()
        vn = batch["occ_voxel_num_points"]
        B = batch["gt_boxes"].shape[0]
        cvalid = vc[:, 0] >= 0
        slot = (torch.arange(vox.shape[1], device=vox.device)[None, :] < vn[:, None]) \
            & cvalid[:, None]
        pts_abs = coords.occ_uvd_to_absxyz(vox[..., 0], vox[..., 1], vox[..., 2],
                                           spec.coord_type)
        occ_pnts = torch.cat([pts_abs, vox[..., 3:]], dim=-1)
        out = T.make_targets(self.grid, occ_pnts, slot, vc, batch, train, self.loss_weights,
                             self.box_weight)

        # occ VFE: plain mean of the cartesian points over the filled slots
        n = torch.where(cvalid, vn, torch.zeros_like(vn))
        fmask = torch.arange(vox.shape[1], device=vox.device)[None, :] < n[:, None]
        feat = (torch.where(fmask[..., None], occ_pnts, torch.zeros((), device=vox.device)).sum(1)
                / n[:, None].float().clamp(min=1.0))
        ncell = nz * ny * nx
        lin = (vc[:, 1] * ny + vc[:, 2]) * nx + vc[:, 3]
        idx = torch.where(cvalid, vc[:, 0] * ncell + lin, torch.full_like(lin, B * ncell))
        dense = torch.zeros((B * ncell + 1, feat.shape[-1]), device=vox.device)
        dense[idx] = torch.where(cvalid[:, None], feat, torch.zeros((), device=vox.device))
        dense = dense[:-1].reshape(B, nz, ny, nx, -1).permute(0, 4, 1, 2, 3)

        x, _ = self.backbone_3d(dense, out["voxelwise_mask"])
        dh = self.occ_dense_head
        logits = dh.conv_cls[0](x).permute(0, 2, 3, 4, 1)             # (B, nz, ny, nx, 2)
        if self.is_softmax:
            prob = torch.softmax(logits, dim=-1)[..., -1]
        else:
            prob = torch.sigmoid(logits[..., -1])
        out["probs"] = prob * out["general_cls_loss_mask"].float()
        res_pred = dh.conv_res[0](x).permute(0, 2, 3, 4, 1) if self.reg else None
        out["res_pred"] = res_pred
        if train:
            out["loss"] = self._get_loss(logits, res_pred, out)
        with torch.no_grad():
            self._pass_occ_vox(batch, out, out["probs"], res_pred, B,
                               self.max_occ_pnts if train else self.eval_max_occ_pnts)
        return out

    def _get_loss(self, logits, res_pred, t):
        """Occupancy loss (JAX `OccSubnet._get_loss`): softmax focal (the
        only CLS_LOSS_TYPE the port trains) over the general cls mask weighted
        by the cls weight map, plus the residual smooth-L1 over the reg mask.
        Each normaliser is summed over the ranks of a data-parallel run."""
        w = self.loss_weights
        mask = t["general_cls_loss_mask"].float()
        wf = t["general_cls_loss_mask_float"]
        pos = t["pos_mask"].to(logits.dtype)
        el = loss_utils.softmax_focal_loss(logits, torch.stack([1.0 - pos, pos], dim=-1),
                                           alpha=1.0, gamma=2.0)
        loss = (el * wf * mask).sum() / all_reduce_sum((wf * mask).sum().detach()).clamp(min=1.0)
        loss = loss * w.get("occ_fore_cls_weight", 1.0)
        if res_pred is not None:
            rm = t["general_reg_loss_mask"].float()
            rf = t["general_reg_loss_mask_float"]
            rl = loss_utils.smooth_l1_loss(res_pred - t["res_mtrx"], beta=w.get("res_beta", 0.025))
            rl = (rl.sum(-1) * rf * rm).sum() / all_reduce_sum(
                (rf * rm).sum().detach()).clamp(min=1.0)
            loss = loss + rl * w.get("occ_fore_res_weight", 0.1)
        return loss

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

        flat = masked_prob.reshape(B, -1)
        sel = torch.where(flat > self.occ_thresh, flat, torch.zeros((), device=dev))
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
        zero = torch.zeros((), device=dev)
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
        extra = int(self.merged_cap_extra if self.merged_cap_extra is not None else K // 4)
        merged = per_frame + extra
        feat, occ_code, num, coords_zyx, row_valid = voxelizer.merge_points_into_voxel_features(
            det_vox.reshape(B, per_frame, Pd, Cd),
            batch["det_voxel_coords"].reshape(B, per_frame, 4),
            batch["det_voxel_num_points"].reshape(B, per_frame).clamp(0, Pd),
            occ_pts6, valid,
            grid_size=voxelizer.compute_grid_size(self.point_cloud_range, self.det_voxel_size),
            lo=self.det_lo, vs=self.det_vs, extra=extra, max_points=MAX_POINTS_MERGED,
            num_raw_features=self.num_point_features)
        rv = row_valid[..., None]
        out["det_voxel_features"] = torch.where(rv, feat, zero).reshape(B * merged, -1)
        out["det_occ_code"] = torch.where(rv, occ_code, zero).reshape(B * merged, -1)
        b = torch.arange(B, device=dev, dtype=torch.int32)[:, None, None].expand(B, merged, 1)
        coords4 = torch.cat([b, coords_zyx], dim=-1)
        out["det_voxel_coords"] = torch.where(rv, coords4, torch.full_like(coords4, -1)) \
            .reshape(B * merged, 4)
        out["det_voxel_num_points"] = torch.where(row_valid, num, torch.zeros_like(num)) \
            .reshape(B * merged)

