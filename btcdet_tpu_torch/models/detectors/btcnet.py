"""BtcNet detector (counterpart of `btcdet_tpu/models/detectors/btcnet.py`,
reference `btcdet/models/detectors/{btcnet.py, detector3d_template.py}`).

    [occ subnet -> PassOccVox merge + OccVFE] (MODEL.OCC)
    vfe -> backbone_3d -> map_to_bev -> backbone_2d -> dense_head
        -> proposal NMS -> roi_head -> generate_predicted_boxes

`net.eval()` runs the eval forward without a gradient; `net.train()` runs
the train forward (train caps, batch-statistics BN, RPN target
assignment, train NMS, roi sampling, dropout) and returns `loss` and
`loss_dict` with the JAX package's key names. The random draws of a train
forward come from the `torch.Generator` it is given.

The modules sit under `occ_modules` and `det_modules`, so the state dict
carries the reference BtcDet names (`occ_modules.backbone_3d.conv1.0.0.weight`,
`det_modules.backbone_3d.conv1.0.weight`, ...). Without `MODEL.OCC` (the
det-only variant, `config.det_only`) the det path reads the batch's own
voxel table through MeanVFE. With it, the det VFE is the occ subnet's fused
merge + OccVFE (VFE.NAME OccVFE, OCC_PNT_UPDATE.FUSED_VFE unset or True),
or reduces the materialized merged table: OccVFE (the occ code then feeds
the backbone's side branch) or MeanVFE (no occ code, no side branch).
DATA_CONFIG.CLAMP ("tanh", or a positive max) clamps the intensity channel
of the points and of every voxel table before anything reads them.

`bev_sharding=True` (the JAX package's `bev_sharding=NamedSharding(mesh,
P('dp', 'sp'))`) splits the BEV pyramid by rows over the run's spatial
group (`parallel.init_dist(..., sp=)`): each rank takes its row slab of
the HeightCompression map (`parallel.take_rows`), runs the row-sharded
BaseBEVBackbone on it, and the slabs of its output are gathered
(`parallel.gather_rows`) before the dense head, which, like every stage
before the BEV and after it, runs the same on each rank of the group.
Without a spatial group it changes nothing.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ...ops import iou3d, sparse
from ...ops.voxelizer import compute_grid_size
from ...parallel import gather_rows, get_sp_info, global_rows, take_rows
from ...utils.common import activation_dtype, jax_default_init_, resolve_device
from ...utils.trace import readback, stage
from .. import backbones_2d, backbones_3d, map_to_bev, vfe
from ..dense_heads import anchor_head
from ..occ import occ_subnet
from ..roi_heads import conv_head, roi_head_utils


# the occ subnet's dense masks a train forward returns, for the
# OCC_PNT_UPDATE.VIS debug views (`utils.vis_utils.collect_occ_vis_clouds`)
VIS_MASK_KEYS = (
    "general_cls_loss_mask", "fore_voxelwise_mask", "mirr_voxelwise_mask",
    "bm_voxelwise_mask", "pos_mask", "neg_mask", "occ_voxelwise_mask",
    "vcc_mask", "voxel_drop_mask", "forebox_label", "res_mtrx",
)

# stages of one eval forward + post-processing, in order
STAGES = ("occ_subnet", "backbone_3d", "bev", "dense_head", "proposal_nms", "roi_head",
          "post_processing")


def _level_caps(bb_cfg, mode: str):
    """BACKBONE_3D.LEVEL_CAPACITIES for `mode` ("train" / "test"): a flat
    list serves both; None inherits."""
    lc = bb_cfg.get("LEVEL_CAPACITIES")
    if not lc:
        return None
    if hasattr(lc, "get") and not isinstance(lc, (list, tuple)):
        lc = lc.get(mode)
    return tuple(int(c) for c in lc) if lc else None


def bev_depth(det_grid_size) -> int:
    """z extent of the 8x backbone's encoded tensor: the sparse grid pads z
    by +1 (reference `sparse_shape = grid_size[::-1] + [1, 0, 0]`), then
    three stride-2 convs and conv_out's (3,1,1)/(2,1,1)."""
    nz = int(det_grid_size[2]) + 1
    for k, s, p in ((3, 2, 1), (3, 2, 1), (3, 2, 0), (3, 2, 0)):
        nz = (nz + 2 * p - k) // s + 1
    return nz


def compute_dtype(section) -> torch.dtype:
    """A config section's COMPUTE_DTYPE: float32 for "f32" / "fp32" /
    "float32", else (and unset) the port's activation dtype."""
    name = str(section.get("COMPUTE_DTYPE", "bf16"))
    return torch.float32 if name in ("f32", "fp32", "float32") else activation_dtype()


class BtcNet(nn.Module):
    def __init__(self, model_cfg, data_cfg, class_names, det_grid_size, point_cloud_range,
                 det_voxel_size, num_point_features: int = 4, bev_sharding: bool = False):
        super().__init__()
        mc = model_cfg
        self.use_occ = mc.get("OCC") is not None
        if mc.VFE.NAME not in ("OccVFE", "MeanVFE"):
            raise KeyError(f"unknown VFE.NAME {mc.VFE.NAME!r}")
        if mc.VFE.NAME == "OccVFE" and not self.use_occ:
            raise NotImplementedError("VFE OccVFE needs MODEL.OCC: it reduces the merged table")
        clamp = data_cfg.get("CLAMP")
        self.clamp = clamp if clamp is not None and (clamp == "tanh" or float(clamp) > 0) else None
        bb = mc.BACKBONE_3D
        self.det_grid_size = tuple(int(v) for v in det_grid_size)
        self.class_names = tuple(class_names)
        self.vfe = (vfe.OccVFE(num_point_features) if mc.VFE.NAME == "OccVFE"
                    else vfe.MeanVFE())
        self.map_to_bev = map_to_bev.HeightCompression()
        input_channels, occ_code_num = num_point_features, 0
        if self.use_occ:
            # parameters under the reference names occ_modules.backbone_3d /
            # occ_modules.occ_dense_head; the merge + OccVFE fuse unless
            # OCC_PNT_UPDATE.FUSED_VFE is False or the det VFE is MeanVFE
            fused = (mc.VFE.NAME == "OccVFE"
                     and bool(mc.OCC.OCC_PNT_UPDATE.get("FUSED_VFE", True)))
            self.occ_modules = occ_subnet.OccSubnet(mc.OCC, data_cfg, point_cloud_range,
                                                    det_voxel_size, num_point_features, fused)
            # the merged points carry the occ code; only OccVFE passes it on
            # to the backbone's side branch (MeanVFE averages it in)
            input_channels += int(data_cfg.OCC.get("CODE_NUM_DIM", 2))
            if mc.VFE.NAME == "OccVFE":
                occ_code_num = input_channels - num_point_features

        det = nn.Module()
        channels = tuple(bb.get("CHANNELS", (16, 32, 64, 64, 128)))
        out_feat_type = tuple(bb.get("OUT_FEAT_TYPE", ["None"] * 4 + ["big_bev_combine"]))
        det.backbone_3d = backbones_3d.VoxelBackBone8xOcc(
            input_channels=input_channels, channels=channels,
            out_feat_type=out_feat_type,
            level_caps={m: _level_caps(bb, m) for m in ("train", "test")},
            occ_code_num=occ_code_num,
            occ_conv_type=tuple(bb.get("OCC_CONV_TYPE", [])) if occ_code_num else (),
            occ_conv_exec=tuple(bb.get("OCC_CONV_EXECUTE", [])) if occ_code_num else (),
            out_att=tuple(bb.get("OCC_ATT", [])))
        nz_bev = bev_depth(self.det_grid_size)
        b2 = mc.BACKBONE_2D
        self.bev_sharding = bool(bev_sharding)
        det.backbone_2d = backbones_2d.BaseBEVBackbone(
            channels[4] * nz_bev, b2.LAYER_NUMS, b2.LAYER_STRIDES, b2.NUM_FILTERS,
            b2.UPSAMPLE_STRIDES, b2.NUM_UPSAMPLE_FILTERS, row_sharded=self.bev_sharding)
        if self.bev_sharding:
            det.backbone_2d.check_rows(self._bev_rows(), get_sp_info()[1])
        c2d = sum(b2.NUM_UPSAMPLE_FILTERS)
        dh = mc.DENSE_HEAD
        anchors, anchor_class, per_loc = anchor_head.generate_anchors(
            point_cloud_range, self.det_grid_size, dh.ANCHOR_GENERATOR_CONFIG)
        lw = dh.LOSS_CONFIG.LOSS_WEIGHTS
        det.dense_head = anchor_head.AnchorHeadSingle(
            c2d, len(class_names), anchors, per_loc,
            use_direction_classifier=dh.get("USE_DIRECTION_CLASSIFIER", True),
            dir_offset=dh.get("DIR_OFFSET", 0.78539),
            dir_limit_offset=dh.get("DIR_LIMIT_OFFSET", 0.0),
            num_dir_bins=dh.get("NUM_DIR_BINS", 2), anchor_class=anchor_class,
            matched_thresholds=[c["matched_threshold"] for c in dh.ANCHOR_GENERATOR_CONFIG],
            unmatched_thresholds=[c["unmatched_threshold"] for c in dh.ANCHOR_GENERATOR_CONFIG],
            cls_weight=lw["cls_weight"], loc_weight=lw["loc_weight"],
            dir_weight=lw["dir_weight"], code_weights=lw["code_weights"],
            match_height=bool(dh.TARGET_ASSIGNER_CONFIG.get("MATCH_HEIGHT", False)))
        rh = mc.ROI_HEAD
        cg = rh.CONV_GRID_POOL
        xc = cg.CONV_LAYER.get("x_combine")
        raw = cg.CONV_LAYER.get("raw_points")
        occp = cg.CONV_LAYER.get("occ_points")
        if "occ_points" in cg.FEATURES_SOURCE and not self.use_occ:
            raise NotImplementedError("ConvHead occ_points without MODEL.OCC")
        if not rh.get("CLASS_AGNOSTIC", True) and len(class_names) > 1:
            # the JAX package's ConvHead.get_loss takes the BCE of (R, classes)
            # logits against (R,) labels and fails to broadcast, so no model
            # of it trains this; a class-agnostic head is what the yamls set
            raise NotImplementedError(
                "ROI_HEAD.CLASS_AGNOSTIC False with several classes: the JAX package's rcnn "
                "loss cannot broadcast per-class logits against its per-roi labels")
        cd = compute_dtype(rh)
        det.roi_head = conv_head.ConvHead(
            num_class=1 if rh.get("CLASS_AGNOSTIC", True) else len(class_names),
            input_channels_xc=channels[3] * 2 if out_feat_type[4] != "None" else None,
            grid_size=tuple(cg.GRID_SIZE), dim_times=cg.get("DIM_TIMES", 1.0),
            point_rot=cg.get("POINT_ROT", False), features_source=tuple(cg.FEATURES_SOURCE),
            raw_mlps=tuple(tuple(m) for m in raw.MLPS), raw_radii=tuple(raw.POOL_RADIUS),
            raw_nsamples=tuple(raw.NSAMPLE), raw_feat_dim=num_point_features - 3,
            **({} if occp is None else dict(
                occ_mlps=tuple(tuple(m) for m in occp.MLPS), occ_radii=tuple(occp.POOL_RADIUS),
                occ_nsamples=tuple(occp.NSAMPLE))),
            xc_part_scene=tuple(xc.PART_SCENE_SIZE), xc_ker_size=tuple(xc.KER_SIZE),
            xc_kernels=tuple(tuple(k) for k in xc.KERNEL),
            xc_paddings=tuple(tuple(p) for p in xc.PADDING),
            xc_strides=tuple(tuple(s) for s in xc.STRIDE), xc_channels=tuple(xc.CHANNEL),
            xc_downsample=tuple(xc.DOWNSAMPLE_FACTOR), xc_scene_times=xc.get("SCENE_TIMES", 1.0),
            shared_fc=tuple(rh.SHARED_FC), cls_fc=tuple(rh.CLS_FC), reg_fc=tuple(rh.REG_FC),
            dp_ratio=rh.get("DP_RATIO", 0.0), point_cloud_range=tuple(point_cloud_range),
            det_voxel_size=tuple(det_voxel_size), compute_dtype=cd,
            rcnn_cls_weight=rh.LOSS_CONFIG.LOSS_WEIGHTS["rcnn_cls_weight"],
            rcnn_reg_weight=rh.LOSS_CONFIG.LOSS_WEIGHTS["rcnn_reg_weight"],
            rcnn_corner_weight=rh.LOSS_CONFIG.LOSS_WEIGHTS["rcnn_corner_weight"],
            code_weights=tuple(rh.LOSS_CONFIG.LOSS_WEIGHTS["code_weights"]),
            corner_loss=bool(rh.LOSS_CONFIG.get("CORNER_LOSS_REGULARIZATION", True)),
            approx_query=bool(rh.get("APPROX_QUERY", True)))
        self.nms_cfg_train = rh.NMS_CONFIG.TRAIN
        self.nms_cfg_test = rh.NMS_CONFIG.TEST
        tc = rh.TARGET_CONFIG
        self.target_cfg = dict(
            roi_per_image=int(tc.ROI_PER_IMAGE), fg_ratio=float(tc.FG_RATIO),
            reg_fg_thresh=float(tc.REG_FG_THRESH), cls_fg_thresh=float(tc.CLS_FG_THRESH),
            cls_bg_thresh=float(tc.CLS_BG_THRESH), cls_bg_thresh_lo=float(tc.CLS_BG_THRESH_LO),
            hard_bg_ratio=float(tc.HARD_BG_RATIO))
        # per-frame gate on using the occ points at train (reference
        # `btcnet.py:37-41`), drawn when the batch lacks `use_occ_prob`
        occ_data = data_cfg.get("OCC")
        self.useocc_percentage = float(occ_data.get("USEOCC_PERCENTAGE", 1.0)) if occ_data else 1.0
        self.det_modules = det
        # the JAX package's init laws, drawn over the layers' own draws
        jax_default_init_(self)

    def _bev_rows(self):
        """H of the BEV map: the grid's ny after the three stride-2 convs
        of the sparse backbone (conv_out strides z only)."""
        ny = self.det_grid_size[1]
        for _ in range(3):
            ny = (ny + 2 - 3) // 2 + 1
        return ny

    def forward(self, batch: dict, generator: torch.Generator | None = None) -> dict:
        """batch: points (B, P, 4), points_mask (B, P), and the det voxel
        table voxels (NV, mp, 4) / voxel_coords (NV, 4) (b, z, y, x) /
        voxel_num_points (NV,) -- under `det_*` with MODEL.OCC, which also
        reads occ_voxels / occ_voxel_coords / occ_voxel_num_points,
        gt_boxes, box_mirr_flag, rot_z, use_occ_prob and bm_points(_mask).
        Eval mode returns the JAX package's eval keys and layouts, without
        a gradient. Train mode returns `loss`, `loss_dict` and the train
        intermediates (with MODEL.OCC the occ masks of VIS_MASK_KEYS); `generator` draws its random numbers. Each stage
        runs in `trace.stage(name)` (STAGES)."""
        if self.training:
            if generator is None:
                raise ValueError("a train forward needs a torch.Generator")
            return self._forward(batch, generator, train=True)
        with torch.no_grad():
            return self._forward(batch, None, train=False)

    def _forward(self, batch, generator, train: bool) -> dict:
        det = self.det_modules
        out = {}
        B = int(batch["points"].shape[0])
        nx, ny, nz = self.det_grid_size
        occ_pts = occ_mask = occ_code = None
        if self.clamp is not None:
            batch = clamp_intensity(batch, self.clamp)
        if self.use_occ and train and "use_occ_prob" not in batch:
            rows, lo = global_rows(B)   # this rank's frames of the global draw
            batch = dict(batch, use_occ_prob=(draw_use_occ_prob(generator, rows)[lo:lo + B].to(
                batch["points"].device) <= self.useocc_percentage))
        if self.use_occ:
            with stage("occ_subnet"):
                occ_out = self.occ_modules(batch, generator)
            occ_pts, occ_mask = occ_out["occ_points"], occ_out["occ_points_mask"]
            out["occ_probs"] = occ_out["probs"]
            out["occ_points"], out["occ_points_mask"] = occ_pts, occ_mask
            if train:
                out["occ_loss"] = occ_out["loss"]
                out.update({k: occ_out[k] for k in VIS_MASK_KEYS if occ_out.get(k) is not None})
            else:
                out["occ_pos_mask"] = occ_out["pos_mask"]
                out["occ_cls_mask"] = occ_out["general_cls_loss_mask"]
        with stage("backbone_3d"):
            if self.use_occ and "det_voxel_features" in occ_out:
                voxel_features, occ_code = occ_out["det_voxel_features"], occ_out["det_occ_code"]
                coords = occ_out["det_voxel_coords"]
            else:
                vox, num, coords = ((occ_out["det_voxels"], occ_out["det_voxel_num_points"],
                                     occ_out["det_voxel_coords"]) if self.use_occ else
                                    (batch["voxels"], batch["voxel_num_points"],
                                     batch["voxel_coords"]))
                voxel_features = self.vfe(vox, num)
                if isinstance(self.vfe, vfe.OccVFE):
                    voxel_features, occ_code = voxel_features
            if occ_code is not None:
                # the occ code rides the sort permutation as a per-row side table
                st, occ_code = sparse.from_coords(voxel_features, coords, (nz + 1, ny, nx), B,
                                                  aux=occ_code)
            else:
                st = sparse.from_coords(voxel_features, coords, (nz + 1, ny, nx), B)
            bb_out = det.backbone_3d(st, occ_code)
        out["encoded_features"] = bb_out["encoded"].features
        with readback("nnz"):
            out["nnz"] = {k: int(v.nnz) for k, v in bb_out.items() if v is not None}
        with stage("bev"):
            bev, out["spatial_features"] = self.map_to_bev(bb_out["encoded"])
            if self.bev_sharding:
                spatial_2d = gather_rows(det.backbone_2d(take_rows(bev)))
            else:
                spatial_2d = det.backbone_2d(bev)
        out["spatial_features_2d"] = spatial_2d.permute(0, 2, 3, 1)
        with stage("dense_head"):
            head = det.dense_head(spatial_2d)
            if train:
                head.update(det.dense_head.assign_targets(batch["gt_boxes"]))
        out["rpn_cls_preds"] = head["cls_preds"]
        out["rpn_box_preds"] = head["batch_box_preds"]
        nms = self.nms_cfg_train if train else self.nms_cfg_test
        with stage("proposal_nms"):
            props = roi_head_utils.proposal_layer(
                head["batch_box_preds"], head["cls_preds"],
                nms_pre=int(nms["NMS_PRE_MAXSIZE"]), nms_post=int(nms["NMS_POST_MAXSIZE"]),
                nms_thresh=float(nms["NMS_THRESH"]))
            rois, roi_valid = props.rois, props.roi_valid
            if train:
                targets = roi_head_utils.assign_targets(generator, props, batch["gt_boxes"],
                                                        **self.target_cfg)
                rois, roi_valid = targets["rois"], targets["roi_valid"]
        pts = batch["points"]
        with stage("roi_head"):
            rcnn_cls, rcnn_reg = det.roi_head(
                rois, roi_valid, pts[..., :3], pts[..., 3:], batch["points_mask"],
                bb_out["x_combine"],
                occ_xyz=None if occ_pts is None else occ_pts[..., :3],
                occ_feat=None if occ_pts is None else occ_pts[..., 3:4], occ_mask=occ_mask,
                generator=generator)
            if not train:
                out["batch_cls_preds"], out["batch_box_preds"] = \
                    det.roi_head.generate_predicted_boxes(rois, rcnn_cls, rcnn_reg)
        out["rois"], out["roi_valid"] = rois, roi_valid
        out["rcnn_cls"], out["rcnn_reg"] = rcnn_cls, rcnn_reg
        if not train:
            out["roi_labels"] = props.roi_labels
            return out
        out["rcnn_targets"] = targets
        # the JAX package's `get_training_loss`: rpn + rcnn (+ occ)
        total, losses = det.dense_head.get_loss(head)
        rcnn_loss, rcnn_losses = det.roi_head.get_loss(rcnn_cls, rcnn_reg, targets)
        total = total + rcnn_loss
        losses.update(rcnn_losses)
        if self.use_occ:
            total = total + out["occ_loss"]
            losses["occ_loss"] = out["occ_loss"]
        out["loss"], out["loss_dict"] = total, losses
        return out


def clamp_intensity(batch: dict, clamp) -> dict:
    """The intensity channel (3) of `points` and of every voxel table
    (`voxels`, `occ_voxels`, `det_voxels`) through tanh (`clamp` "tanh") or
    clamped to [0, clamp] (reference `BtcNet.clamp`, `btcnet.py:16-30`)."""
    def f(x):
        return torch.tanh(x) if clamp == "tanh" else x.clamp(0.0, float(clamp))

    batch = dict(batch)
    for k in ("points", "voxels", "occ_voxels", "det_voxels"):
        if k in batch:
            v = batch[k]
            batch[k] = torch.cat([v[..., :3], f(v[..., 3:4]), v[..., 4:]], dim=-1)
    return batch


def draw_use_occ_prob(generator: torch.Generator, B: int) -> torch.Tensor:
    """(B,) uniforms in [0, 0.9999) of the train-time occ-point gate."""
    return torch.rand((B,), generator=generator, device=generator.device) * 0.9999


@torch.no_grad()
def post_processing(out: dict, post_cfg, num_class: int = 1, device=None) -> dict:
    """Final per-frame rotated NMS over the refined boxes (reference
    `detector3d_template.post_processing:363`), class-agnostic. Returns
    (B, post_max) pred_boxes / pred_scores / pred_labels / pred_valid."""
    with stage("post_processing"):
        return _post_processing(out, post_cfg, resolve_device(device))


def _post_processing(out, post_cfg, dev):
    nms_cfg = post_cfg.NMS_CONFIG
    cls_preds = out["batch_cls_preds"].to(dev)
    box_preds = out["batch_box_preds"].to(dev)
    scores = torch.sigmoid(cls_preds.max(dim=-1).values)
    labels = out["roi_labels"].to(dev) if "roi_labels" in out else cls_preds.argmax(-1) + 1
    valid = scores >= float(post_cfg.SCORE_THRESH)
    if "roi_valid" in out:
        valid = valid & out["roi_valid"].to(dev)
    idx, keep = iou3d.nms_rotated_batched(
        box_preds, scores, valid, thresh=float(nms_cfg.NMS_THRESH),
        pre_max_size=int(nms_cfg.NMS_PRE_MAXSIZE), post_max_size=int(nms_cfg.NMS_POST_MAXSIZE))
    boxes = torch.gather(box_preds, 1, idx[..., None].expand(-1, -1, box_preds.shape[-1]))
    kept_scores, kept_labels = torch.gather(scores, 1, idx), torch.gather(labels, 1, idx)
    return {"pred_boxes": torch.where(keep[..., None], boxes, torch.zeros_like(boxes)),
            "pred_scores": torch.where(keep, kept_scores, torch.zeros_like(kept_scores)),
            "pred_labels": torch.where(keep, kept_labels, torch.zeros_like(kept_labels)),
            "pred_valid": keep}


def build_network(model_cfg, data_cfg, class_names, device=None,
                  bev_sharding: bool = False) -> BtcNet:
    """BtcNet from reference-schema configs, in eval mode on `device`
    (CUDA unless the caller passes another); `.train()` switches it to
    the train forward. `bev_sharding` splits the BEV pyramid by rows over
    the spatial group of the run (`parallel.init_dist(..., sp=)`); a
    split the pyramid cannot run is refused here."""
    dev = resolve_device(device)
    pcr = tuple(data_cfg.POINT_CLOUD_RANGE)
    det_vox = None
    for proc in data_cfg.DATA_PROCESSOR:
        if proc.NAME in ("det_transform_points_to_voxels", "transform_points_to_voxels"):
            det_vox = tuple(proc.VOXEL_SIZE)
    assert det_vox is not None, "no det voxelization in DATA_PROCESSOR"
    net = BtcNet(model_cfg, data_cfg, class_names, compute_grid_size(pcr, det_vox), pcr,
                 det_vox, len(data_cfg.POINT_FEATURE_ENCODING["used_feature_list"]),
                 bev_sharding=bev_sharding)
    return net.to(dev).eval()
