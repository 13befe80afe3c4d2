"""PV-RCNN detector (reference OpenPCDet `detectors/pv_rcnn.py` and the
`Detector3DTemplate` module topology; Shi et al., CVPR 2020), eval forward.

    vfe (MeanVFE) -> backbone_3d -> map_to_bev_module -> pfe (VSA)
        -> backbone_2d -> dense_head -> point_head -> proposal NMS
        -> roi_head (RoI-grid pool, FCs, decode)

Each stage runs in `trace.stage(name)`, in the order of `STAGES`; the
final NMS is `btcnet.post_processing` with the rois' labels. The modules
carry OpenPCDet's PVRCNN names (`backbone_3d`, `pfe`, `backbone_2d`,
`dense_head`, `point_head`, `roi_head`; `vfe` and `map_to_bev_module` hold
no parameters). OpenPCDet's VoxelBackBone8x is the port's
`VoxelBackBone8xOcc` with no occ code and no fused output (its
`conv_input` / `conv1` are `conv1` / `conv1_combine` there). The VSA
takes OpenPCDet's layout (`pfe.VoxelSetAbstraction(openpcdet=True)`) and
the C-major HeightCompression map OpenPCDet's `spatial_features` is.

Only the eval forward exists: `.train()` mode raises NotImplementedError,
since PV-RCNN's training waits for a train runner. `ROI_HEAD.CLASS_AGNOSTIC`
False is refused, as BtcNet refuses it.

The compute dtype of the VSA's MLPs and fusion linear, the point head's
hidden linears and the roi head's grid-pool MLPs and hidden FCs is each
section's COMPUTE_DTYPE ("bf16": the port's `activation_dtype()`, the
default; "f32"); the BNs, the output projections and the box decodes run
in float32.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ...ops import sparse
from ...ops.voxelizer import compute_grid_size
from ...utils.common import jax_default_init_, resolve_device
from ...utils.trace import stage
from .. import backbones_2d, backbones_3d, map_to_bev, pfe, vfe
from ..dense_heads import anchor_head, point_head_simple
from ..roi_heads import pvrcnn_head, roi_head_utils
from .btcnet import _level_caps, bev_depth, compute_dtype

# stages of one eval forward + post-processing, in order
STAGES = ("backbone_3d", "vsa", "bev", "dense_head", "point_head", "proposal_nms",
          "roi_grid_pool", "roi_head", "post_processing")
LEVELS = ("x_conv1", "x_conv2", "x_conv3", "x_conv4")


class PVRCNN(nn.Module):
    def __init__(self, model_cfg, class_names, det_grid_size, point_cloud_range, voxel_size,
                 num_point_features: int = 4):
        super().__init__()
        mc = model_cfg
        if mc.VFE.NAME != "MeanVFE":
            raise KeyError(f"PV-RCNN VFE.NAME {mc.VFE.NAME!r}: MeanVFE only")
        self.det_grid_size = tuple(int(v) for v in det_grid_size)
        self.class_names = tuple(class_names)
        self.vfe = vfe.MeanVFE()
        bb = mc.BACKBONE_3D
        channels = tuple(bb.get("CHANNELS", (16, 32, 64, 64, 128)))
        out_feat_type = tuple(bb.get("OUT_FEAT_TYPE", ["None"] * 5))
        if out_feat_type[4] != "None":
            raise NotImplementedError("PV-RCNN's backbone makes no fused x_combine output")
        self.backbone_3d = backbones_3d.VoxelBackBone8xOcc(
            input_channels=num_point_features, channels=channels, out_feat_type=out_feat_type,
            level_caps={m: _level_caps(bb, m) for m in ("train", "test")})
        self.map_to_bev_module = map_to_bev.HeightCompression()
        bev_channels = channels[4] * bev_depth(self.det_grid_size)

        pc = mc.PFE
        sources = tuple(pc.FEATURES_SOURCE)
        sa = pc.SA_LAYER
        levels = [n for n in sources if n not in ("bev", "raw_points")]
        for name in levels:
            want = int(sa[name].get("DOWNSAMPLE_FACTOR", pfe.level_stride(name)))
            if want != pfe.level_stride(name):
                raise NotImplementedError(f"PFE {name} DOWNSAMPLE_FACTOR {want}")
        # the VSA's SA settings in its order: the raw points first, then the levels
        order = ["raw_points"] * ("raw_points" in sources) + levels
        self.pfe = pfe.VoxelSetAbstraction(
            {n: channels[LEVELS.index(n)] for n in sources if n in LEVELS},
            raw_channels=num_point_features - 3, bev_channels=bev_channels,
            num_keypoints=int(pc.NUM_KEYPOINTS), features_source=sources,
            sa_radii=[tuple(sa[n].POOL_RADIUS) for n in order],
            sa_nsamples=[tuple(sa[n].NSAMPLE) for n in order],
            sa_mlps=[tuple(tuple(m) for m in sa[n].MLPS) for n in order],
            bev_stride=8, point_cloud_range=point_cloud_range, voxel_size=voxel_size,
            num_out_features=int(pc.NUM_OUTPUT_FEATURES), openpcdet=True,
            dtype=compute_dtype(pc))

        b2 = mc.BACKBONE_2D
        self.backbone_2d = backbones_2d.BaseBEVBackbone(
            bev_channels, b2.LAYER_NUMS, b2.LAYER_STRIDES, b2.NUM_FILTERS,
            b2.UPSAMPLE_STRIDES, b2.NUM_UPSAMPLE_FILTERS)
        dh = mc.DENSE_HEAD
        anchors, anchor_class, per_loc = anchor_head.generate_anchors(
            point_cloud_range, self.det_grid_size, dh.ANCHOR_GENERATOR_CONFIG)
        lw = dh.LOSS_CONFIG.LOSS_WEIGHTS
        self.dense_head = anchor_head.AnchorHeadSingle(
            sum(b2.NUM_UPSAMPLE_FILTERS), len(class_names), anchors, per_loc,
            use_direction_classifier=dh.get("USE_DIRECTION_CLASSIFIER", True),
            dir_offset=dh.get("DIR_OFFSET", 0.78539),
            dir_limit_offset=dh.get("DIR_LIMIT_OFFSET", 0.0),
            num_dir_bins=dh.get("NUM_DIR_BINS", 2), anchor_class=anchor_class,
            matched_thresholds=[c["matched_threshold"] for c in dh.ANCHOR_GENERATOR_CONFIG],
            unmatched_thresholds=[c["unmatched_threshold"] for c in dh.ANCHOR_GENERATOR_CONFIG],
            cls_weight=lw["cls_weight"], loc_weight=lw["loc_weight"],
            dir_weight=lw["dir_weight"], code_weights=lw["code_weights"],
            match_height=bool(dh.TARGET_ASSIGNER_CONFIG.get("MATCH_HEIGHT", False)))

        ph = mc.POINT_HEAD
        self.point_head_before_fusion = bool(ph.get("USE_POINT_FEATURES_BEFORE_FUSION", False))
        self.point_head = point_head_simple.PointHeadSimple(
            1 if ph.get("CLASS_AGNOSTIC", False) else len(class_names),
            (self.pfe.num_features_before_fusion if self.point_head_before_fusion
             else int(pc.NUM_OUTPUT_FEATURES)),
            cls_fc=tuple(ph.CLS_FC), compute_dtype=compute_dtype(ph))

        rh = mc.ROI_HEAD
        if not rh.get("CLASS_AGNOSTIC", True):
            raise NotImplementedError("PV-RCNN ROI_HEAD.CLASS_AGNOSTIC False")
        gp = rh.ROI_GRID_POOL
        self.roi_head = pvrcnn_head.PVRCNNHead(
            1, int(pc.NUM_OUTPUT_FEATURES), grid_size=int(gp.GRID_SIZE),
            mlps=tuple(tuple(m) for m in gp.MLPS), radii=tuple(gp.POOL_RADIUS),
            nsamples=tuple(gp.NSAMPLE), pool_method=gp.get("POOL_METHOD", "max_pool"),
            shared_fc=tuple(rh.SHARED_FC), cls_fc=tuple(rh.CLS_FC), reg_fc=tuple(rh.REG_FC),
            dp_ratio=rh.get("DP_RATIO", 0.0), compute_dtype=compute_dtype(rh))
        self.nms_cfg_test = rh.NMS_CONFIG.TEST
        # the JAX package's init laws, as BtcNet draws them
        jax_default_init_(self)

    def train(self, mode: bool = True):
        if mode:
            raise NotImplementedError("PV-RCNN runs its eval forward only: its training waits "
                                      "for the train runner (ROADMAP B.1)")
        return super().train(False)

    def forward(self, batch: dict) -> dict:
        """batch: points (B, P, 4), points_mask (B, P), and the voxel table
        voxels (NV, mp, 4) / voxel_coords (NV, 4) (b, z, y, x) /
        voxel_num_points (NV,). Returns, without a gradient: the keypoints
        (`keypoints`, `keypoint_mask`), their features (`point_features`,
        `point_features_before_fusion`), the point head's logits and scores
        (`point_cls_preds`, `point_cls_scores`), the RPN's (`rpn_cls_preds`,
        `rpn_box_preds`), the proposals (`rois`, `roi_valid`, `roi_labels`),
        the roi head's raw outputs (`rcnn_cls`, `rcnn_reg`) and decoded
        boxes (`batch_cls_preds`, `batch_box_preds`)."""
        with torch.no_grad():
            return self._forward(batch)

    def _forward(self, batch) -> dict:
        out = {}
        B = int(batch["points"].shape[0])
        nx, ny, nz = self.det_grid_size
        with stage("backbone_3d"):
            st = sparse.from_coords(self.vfe(batch["voxels"], batch["voxel_num_points"]),
                                    batch["voxel_coords"], (nz + 1, ny, nx), B)
            levels = self.backbone_3d(st)
            bev, _ = self.map_to_bev_module(levels["encoded"])       # C-major (B, C, H, W)
        pts = batch["points"]
        with stage("vsa"):
            kp, before, kp_mask = self.pfe.sample(pts[..., :3], batch["points_mask"],
                                                  pts[..., 3:], levels, bev.permute(0, 2, 3, 1))
            kp_feat = self.pfe.fuse(before, kp_mask)
        out.update(keypoints=kp, keypoint_mask=kp_mask, point_features=kp_feat,
                   point_features_before_fusion=before)
        with stage("bev"):
            spatial_2d = self.backbone_2d(bev)
        with stage("dense_head"):
            head = self.dense_head(spatial_2d)
        out["rpn_cls_preds"], out["rpn_box_preds"] = head["cls_preds"], head["batch_box_preds"]
        with stage("point_head"):
            out["point_cls_preds"], out["point_cls_scores"] = self.point_head(
                before if self.point_head_before_fusion else kp_feat)
        nms = self.nms_cfg_test
        with stage("proposal_nms"):
            props = roi_head_utils.proposal_layer(
                head["batch_box_preds"], head["cls_preds"],
                nms_pre=int(nms["NMS_PRE_MAXSIZE"]), nms_post=int(nms["NMS_POST_MAXSIZE"]),
                nms_thresh=float(nms["NMS_THRESH"]))
        rois, roi_valid = props.rois, props.roi_valid
        with stage("roi_grid_pool"):
            pooled = self.roi_head.roi_grid_pool(rois, roi_valid, kp, kp_mask, kp_feat,
                                                 out["point_cls_scores"])
        with stage("roi_head"):
            rcnn_cls, rcnn_reg = self.roi_head(pooled, roi_valid)
            out["batch_cls_preds"], out["batch_box_preds"] = \
                self.roi_head.generate_predicted_boxes(rois, rcnn_cls, rcnn_reg)
        out.update(rois=rois, roi_valid=roi_valid, roi_labels=props.roi_labels,
                   rcnn_cls=rcnn_cls, rcnn_reg=rcnn_reg)
        return out


def build_network(model_cfg, data_cfg, class_names, device=None,
                  bev_sharding: bool = False) -> PVRCNN:
    """PVRCNN from reference-schema configs, in eval mode on `device`
    (CUDA unless the caller passes another). BEV row sharding is BtcNet's
    only."""
    if bev_sharding:
        raise NotImplementedError("bev_sharding: BtcNet only")
    dev = resolve_device(device)
    pcr = tuple(data_cfg.POINT_CLOUD_RANGE)
    vox = None
    for proc in data_cfg.DATA_PROCESSOR:
        if proc.NAME in ("det_transform_points_to_voxels", "transform_points_to_voxels"):
            vox = tuple(proc.VOXEL_SIZE)
    assert vox is not None, "no voxelization in DATA_PROCESSOR"
    net = PVRCNN(model_cfg, class_names, compute_grid_size(pcr, vox), pcr, vox,
                 len(data_cfg.POINT_FEATURE_ENCODING["used_feature_list"]))
    return net.to(dev).eval()
