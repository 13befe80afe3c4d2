"""The reference's side of the comparison that decides `correct` in an
eval cell: each stage of the BtcNet eval forward and its post-processing,
recomputed in float32 by the frozen plain copy (`btcref`).

The first stage starts from the benchmark's own batch: the occupancy
subnet's dense network, or without one (`occ` None) the VFE and the det
backbone on the batch's own voxel table. Each later stage starts from
what the program handed to it: its discrete choices (the occupancy top-K, the proposal
NMS's keeps, the ball queries, the final NMS's keeps) are then the
program's own, so a flip of a near tie cannot set apart two sound runs,
while every stage's own arithmetic is worked out again here. Nothing of
the program is imported: its outputs arrive as plain tensors.

The two box decodes (the RPN's anchors with the direction classifier's
bin, ConvHead's residuals in the roi frame) are worked out again from the
program's raw predictions, in float32 as the configuration decodes; the
control decodes in bfloat16.

`ref_stages` returns the reference's outputs under the keys
`program_stages` gives the program's; `gaps` compares the two.
"""

from __future__ import annotations

import math

import torch

from .btcref.ops import sparse as rsparse
from .btcref.models.detectors import btcnet as rbtcnet
from .btcref.models.roi_heads import roi_head_utils

# the reading of a comparison that cannot be made (shapes differ, NaN): a
# finite number far above any limit, so that the result line stays JSON
UNCOMPARABLE = 1e30

# numbers compared and how: "rel" is the largest difference over the
# largest magnitude of the reference's tensors; "box" the same for each
# coordinate of a box apart, the heading's difference taken modulo 2 pi
# and over pi; "count" the number of entries that differ at all
KINDS = {
    "occ_subnet": "rel", "occ_rows": "count",
    "backbone": "rel", "backbone_sites": "count", "rpn": "rel", "rpn_boxes": "box",
    "proposals": "count", "rcnn": "rel", "rcnn_boxes": "box", "final": "count",
}
BOX_DIM = 7


def _st(fields: dict):
    """A reference SparseTensor from a program sparse tensor's fields."""
    return rsparse.SparseTensor(fields["features"].float(), fields["coords"], fields["keys"],
                                fields["nnz"], tuple(fields["spatial_shape"]),
                                int(fields["batch_size"]))


def sparse_fields(st) -> dict:
    """The plain fields of a sparse tensor (the program's or the reference's)."""
    return dict(features=st.features, coords=st.coords, keys=st.keys, nnz=st.nnz,
                spatial_shape=tuple(st.spatial_shape), batch_size=int(st.batch_size))


def program_stages(occ: dict | None, bb: dict, head: dict, out: dict) -> dict:
    """The program's stage outputs of one batch, from what its modules
    returned: `occ` the occupancy subnet's dict (None without one), `bb`
    the det backbone's (sparse tensors as `sparse_fields`), `head` the
    dense head's, `out` the forward's."""
    r = {} if occ is None else {
        "occ_subnet": [occ["probs"], occ["det_voxel_features"], occ["det_occ_code"],
                       occ["occ_points"]],
        "occ_rows": [occ["det_voxel_coords"], occ["det_voxel_num_points"],
                     occ["occ_points_mask"]],
    }
    return r | {
        "backbone": [bb["encoded"]["features"], bb["x_combine"]["features"]],
        "backbone_sites": [bb["encoded"]["coords"], bb["x_combine"]["coords"]],
        "rpn": _rpn_preds(head),
        "rpn_boxes": [head["batch_box_preds"]],
        "proposals": [out["rois"], out["roi_valid"], out["roi_labels"]],
        "rcnn": [out["rcnn_cls"], out["rcnn_reg"]],
    }


def _rpn_preds(head: dict) -> list:
    keys = ("cls_preds", "box_preds", "dir_preds")
    return [head[k] for k in keys if head.get(k) is not None]


def decode_rpn(dense_head, box_preds, dir_preds, dtype=torch.float32):
    """The RPN's decoded boxes of raw `box_preds` and `dir_preds`, every
    operand (the anchors too) in `dtype`, returned in float32."""
    anchors = dense_head.anchors
    try:
        dense_head.anchors = anchors.to(dtype)
        boxes = dense_head._decode(box_preds.to(dtype),
                                   None if dir_preds is None else dir_preds.to(dtype))
    finally:
        dense_head.anchors = anchors
    return boxes.float()


def decode_rcnn(roi_head, rois, rcnn_cls, rcnn_reg, dtype=torch.float32) -> list:
    """ConvHead's [scores, boxes] of its raw outputs on `rois`, computed in
    `dtype`, returned in float32."""
    cls, boxes = roi_head.generate_predicted_boxes(rois.to(dtype), rcnn_cls.to(dtype),
                                                   rcnn_reg.to(dtype))
    return [cls.float(), boxes.float()]


@torch.no_grad()
def ref_stages(ref, batch: dict, occ: dict | None, bb: dict, head: dict, out: dict, nms_cfg,
               decode_dtype=torch.float32) -> dict:
    """The reference's stage outputs, each stage fed what the program fed
    it (see the module docstring). `ref` is a `btcref` BtcNet in eval mode
    holding the benchmark's weights; `occ` None for one without the
    occupancy subnet; `nms_cfg` the ROI head's test NMS; `decode_dtype`
    the precision of the RPN's box decode."""
    if occ is None:
        r = _ref_det_input(ref, batch)
    else:
        r = _ref_occ(ref, batch, occ)
    _ref_from_bev(ref, r, batch, occ, bb, head, out, nms_cfg, decode_dtype)
    return r


def _ref_det_input(ref, batch: dict) -> dict:
    """Without the occupancy subnet: the reference's VFE and det backbone
    on the batch's own voxel table, as its forward runs them."""
    B = int(batch["points"].shape[0])
    nx, ny, nz = ref.det_grid_size
    st = rsparse.from_coords(ref.vfe(batch["voxels"], batch["voxel_num_points"]),
                             batch["voxel_coords"], (nz + 1, ny, nx), B)
    bb_ref = ref.det_modules.backbone_3d(st, None)
    return {"backbone": [bb_ref["encoded"].features, bb_ref["x_combine"].features],
            "backbone_sites": [bb_ref["encoded"].coords, bb_ref["x_combine"].coords]}


def _ref_occ(ref, batch: dict, occ: dict) -> dict:
    """The occupancy subnet from the batch, PassOccVox on the program's
    probabilities, and the det backbone on the program's merged det table."""
    B = int(batch["points"].shape[0])
    r = {}
    occ_ref = ref.occ_modules(batch)
    probs = occ_ref["probs"]
    del occ_ref
    # PassOccVox on the program's probabilities and residuals
    merged = {}
    sub = ref.occ_modules
    sub._pass_occ_vox(batch, merged, occ["probs"].float(),
                      None if occ.get("res_pred") is None else occ["res_pred"].float(), B,
                      sub.eval_max_occ_pnts)
    r["occ_subnet"] = [probs, merged["det_voxel_features"], merged["det_occ_code"],
                       merged["occ_points"]]
    r["occ_rows"] = [merged["det_voxel_coords"], merged["det_voxel_num_points"],
                     merged["occ_points_mask"]]
    del merged
    # the det backbone on the program's merged det table
    nx, ny, nz = ref.det_grid_size
    st, code = rsparse.from_coords(occ["det_voxel_features"].float(), occ["det_voxel_coords"],
                                   (nz + 1, ny, nx), B, aux=occ["det_occ_code"].float())
    bb_ref = ref.det_modules.backbone_3d(st, code)
    r["backbone"] = [bb_ref["encoded"].features, bb_ref["x_combine"].features]
    r["backbone_sites"] = [bb_ref["encoded"].coords, bb_ref["x_combine"].coords]
    return r


def _ref_from_bev(ref, r: dict, batch: dict, occ: dict | None, bb: dict, head: dict,
                  out: dict, nms_cfg, decode_dtype):
    """The stages from the BEV on, each on what the program handed it, into `r`."""
    # BEV + dense head on the program's encoded tensor
    bev, _ = ref.map_to_bev(_st(bb["encoded"]))
    head_ref = ref.det_modules.dense_head(ref.det_modules.backbone_2d(bev))
    r["rpn"] = _rpn_preds(head_ref)
    del bev, head_ref
    # the RPN's box decode of the program's raw predictions
    r["rpn_boxes"] = [decode_rpn(ref.det_modules.dense_head, head["box_preds"],
                                 head.get("dir_preds"), decode_dtype)]
    # proposal NMS on the program's RPN boxes and scores
    props = roi_head_utils.proposal_layer(
        head["batch_box_preds"], head["cls_preds"], nms_pre=int(nms_cfg["NMS_PRE_MAXSIZE"]),
        nms_post=int(nms_cfg["NMS_POST_MAXSIZE"]), nms_thresh=float(nms_cfg["NMS_THRESH"]))
    r["proposals"] = [props.rois, props.roi_valid, props.roi_labels]
    # ConvHead on the program's proposals, points, occupancy points and x_combine
    pts = batch["points"]
    if occ is None:
        occ_kw = {}
    else:
        occ_pts = occ["occ_points"]
        occ_kw = dict(occ_xyz=occ_pts[..., :3], occ_feat=occ_pts[..., 3:4],
                      occ_mask=occ["occ_points_mask"])
    cls, reg = ref.det_modules.roi_head(
        out["rois"], out["roi_valid"], pts[..., :3], pts[..., 3:], batch["points_mask"],
        _st(bb["x_combine"]), **occ_kw)
    r["rcnn"] = [cls, reg]


@torch.no_grad()
def ref_final(ref, batch_out: dict, post_cfg, device) -> dict:
    """The final NMS of one batch, on the program's refined boxes and
    scores (`batch_cls_preds`, `batch_box_preds`, `roi_labels`, `roi_valid`)."""
    return rbtcnet.post_processing(batch_out, post_cfg, 1, device)


def _rel(p: list, r: list) -> float:
    worst = 0.0
    for a, b in zip(p, r):
        a, b = a.float(), b.float()
        if a.shape != b.shape:
            return UNCOMPARABLE
        if a.numel() == 0:
            continue
        scale = b.abs().max().item()
        diff = (a - b).abs().max().item()
        if diff != diff:   # NaN
            return UNCOMPARABLE
        worst = max(worst, diff / max(scale, 1e-30))
    return worst


def box_gap(p: list, r: list) -> float:
    """"rel" for each coordinate of boxes (last axis `BOX_DIM`) apart, the
    heading as its difference modulo 2 pi over pi; other tensors as "rel".
    Entries equal on both sides (infinities too) differ by 0."""
    worst = 0.0
    for a, b in zip(p, r):
        a, b = a.float(), b.to(a.device).float()
        if a.shape != b.shape:
            return UNCOMPARABLE
        if a.numel() == 0:
            continue
        if a.shape[-1] != BOX_DIM:
            v = _rel([a], [b])
        else:
            a, b = a.reshape(-1, BOX_DIM), b.reshape(-1, BOX_DIM)
            d = torch.where(a == b, torch.zeros_like(a), (a - b).abs())
            turn = torch.remainder(a[:, 6] - b[:, 6] + math.pi, 2 * math.pi) - math.pi
            d[:, 6] = torch.where(a[:, 6] == b[:, 6], torch.zeros_like(turn), turn.abs())
            mag = torch.where(torch.isfinite(b), b.abs(), torch.zeros_like(b)).amax(0)
            mag[6] = math.pi
            v = (d.amax(0) / mag.clamp_min(1e-30)).max().item()
        if v != v:   # NaN
            return UNCOMPARABLE
        worst = max(worst, v)
    return worst


def _count(p: list, r: list) -> float:
    n = 0
    for a, b in zip(p, r):
        if a.shape != b.shape:
            return UNCOMPARABLE
        a, b = a.to(b.device), b
        if a.dtype.is_floating_point or b.dtype.is_floating_point:
            same = (a.float() == b.float()) | (torch.isnan(a.float()) & torch.isnan(b.float()))
        else:
            same = a.long() == b.long()
        n += int((~same).sum().item())
    return float(n)


def gaps(prog: dict, ref: dict) -> dict:
    """{name: number} for every stage that both sides hold."""
    out = {}
    for k, kind in KINDS.items():
        if k in prog and k in ref:
            out[k] = {"rel": _rel, "box": box_gap, "count": _count}[kind](prog[k], ref[k])
    return out


def final_mismatch(prog_dets: list, ref_dets: list) -> float:
    """Entries of the final detections that differ, over sampled batches
    (each a dict pred_boxes / pred_scores / pred_labels / pred_valid)."""
    n = 0.0
    for p, r in zip(prog_dets, ref_dets):
        keys = ("pred_boxes", "pred_scores", "pred_labels", "pred_valid")
        n += _count([p[k] for k in keys], [r[k].cpu() for k in keys])
    return n
