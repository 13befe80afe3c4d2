"""The reference's side of the comparison that decides `correct` in a
PV-RCNN eval cell: each stage of the eval forward recomputed in float32 by
`pvref`, from what the program handed it, so its discrete choices (the
keypoints' picks aside, which are checked on their own) are the program's:

    backbone, backbone_sites  MeanVFE and the sparse backbone on the batch's
                              voxel table: x_conv1-4 and the encoded tensor
    keypoints                 furthest point sampling of the batch's points
    vsa                       the VSA at the program's keypoints over its
                              levels and BEV map: features before and after
                              the fusion
    point_head                the point head on the program's features
                              before the fusion: its logits (its scores
                              feed the reference's `rcnn`)
    rpn, rpn_boxes            the BEV pyramid and anchor head on the
                              program's BEV map; the RPN's decode of its
                              raw predictions
    proposals                 the proposal layer on its RPN boxes
    rcnn                      the RoI-grid pool and FCs on its rois,
                              keypoints and fused features, weighted by
                              the reference point head's scores

The numbers' kinds, the decodes and the final NMS are `reference.stages`'.
"""

from __future__ import annotations

import torch

from .. import stages as S
from ..btcref.models.roi_heads import roi_head_utils
from ..btcref.ops import sparse as rsparse

KINDS = {
    "backbone": "rel", "backbone_sites": "count", "keypoints": "count", "vsa": "rel",
    "point_head": "rel", "rpn": "rel", "rpn_boxes": "box", "proposals": "count",
    "rcnn": "rel",
}
# the backbone outputs the later stages read
LEVELS = ("x_conv1", "x_conv2", "x_conv3", "x_conv4", "encoded")


def program_stages(bb: dict, head: dict, out: dict) -> dict:
    """The program's stage outputs of one batch: `bb` its backbone's levels
    (as `stages.sparse_fields`), `head` its dense head's dict, `out` the
    forward's."""
    return {
        "backbone": [bb[k]["features"] for k in LEVELS],
        "backbone_sites": [bb[k]["coords"] for k in LEVELS],
        "keypoints": [out["keypoints"], out["keypoint_mask"]],
        "vsa": [out["point_features_before_fusion"], out["point_features"]],
        "point_head": [out["point_cls_preds"]],
        "rpn": S._rpn_preds(head),
        "rpn_boxes": [head["batch_box_preds"]],
        "proposals": [out["rois"], out["roi_valid"], out["roi_labels"]],
        "rcnn": [out["rcnn_cls"], out["rcnn_reg"]],
    }


@torch.no_grad()
def ref_stages(ref, batch: dict, bb: dict, head: dict, out: dict, nms_cfg,
               decode_dtype=torch.float32) -> dict:
    """The reference's stage outputs under `program_stages`' keys; `ref` a
    `pvref` PVRCNN in eval mode holding the benchmark's weights, `nms_cfg`
    the roi head's test NMS, `decode_dtype` the RPN decode's precision."""
    r = {}
    B = int(batch["points"].shape[0])
    nx, ny, nz = ref.det_grid_size
    st = rsparse.from_coords(ref.vfe(batch["voxels"], batch["voxel_num_points"]),
                             batch["voxel_coords"], (nz + 1, ny, nx), B)
    lv = ref.backbone_3d(st, None)
    r["backbone"] = [lv[k].features for k in LEVELS]
    r["backbone_sites"] = [lv[k].coords for k in LEVELS]
    del lv, st
    pts, pmask = batch["points"], batch["points_mask"]
    idx = ref.pfe.sample(pts[..., :3], pmask)
    r["keypoints"] = [torch.gather(pts[..., :3], 1, idx[..., None].expand(-1, -1, 3)),
                      torch.gather(pmask.bool(), 1, idx)]
    levels = {k: S._st(bb[k]) for k in LEVELS}
    bev, _ = ref.map_to_bev_module(levels["encoded"])
    r["vsa"] = list(ref.pfe.features(pts[..., :3], pmask, pts[..., 3:], levels,
                                     bev.permute(0, 2, 3, 1), out["keypoints"],
                                     out["keypoint_mask"]))
    logits, scores = ref.point_head(out["point_features_before_fusion"])
    r["point_head"] = [logits]
    head_ref = ref.dense_head(ref.backbone_2d(bev))
    r["rpn"] = S._rpn_preds(head_ref)
    del bev, head_ref, levels
    r["rpn_boxes"] = [S.decode_rpn(ref.dense_head, head["box_preds"], head.get("dir_preds"),
                                   decode_dtype)]
    props = roi_head_utils.proposal_layer(
        head["batch_box_preds"], head["cls_preds"], nms_pre=int(nms_cfg["NMS_PRE_MAXSIZE"]),
        nms_post=int(nms_cfg["NMS_POST_MAXSIZE"]), nms_thresh=float(nms_cfg["NMS_THRESH"]))
    r["proposals"] = [props.rois, props.roi_valid, props.roi_labels]
    pooled = ref.roi_head.roi_grid_pool(out["rois"], out["roi_valid"], out["keypoints"],
                                        out["keypoint_mask"], out["point_features"], scores)
    r["rcnn"] = list(ref.roi_head(pooled, out["roi_valid"]))
    return r


def gaps(prog: dict, ref: dict) -> dict:
    """{name: number} for every stage both sides hold."""
    fns = {"rel": S._rel, "box": S.box_gap, "count": S._count}
    return {k: fns[kind](prog[k], ref[k]) for k, kind in KINDS.items()
            if k in prog and k in ref}
