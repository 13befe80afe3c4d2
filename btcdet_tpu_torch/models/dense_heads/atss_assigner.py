"""ATSS target assigner (counterpart of
`btcdet_tpu/models/dense_heads/atss_assigner.py`; reference
`target_assigner/atss_target_assigner.py`; no config names it).

Adaptive Training Sample Selection: per gt, the top-k anchors by BEV
centre distance, an adaptive IoU threshold (mean + population std of
their IoUs with the gt), and the candidates at or above it whose centres
lie inside the gt are positive; each positive anchor takes its max-IoU gt.
"""

from __future__ import annotations

import torch

from ...utils import box_utils
from ...utils.box_coder import ResidualCoder
from .anchor_head import anchor_iou3d


def atss_assign(anchors, gt_boxes, gt_valid, gt_classes, *, topk: int = 9, box_coder=None,
                match_height: bool = True):
    """anchors (A, 7), gt_boxes (G, 7), gt_valid (G,), gt_classes (G,).
    Returns (labels (A,) int32, reg_targets (A, 7), positive (A,) bool).
    `match_height`: the rotated 3-D IoU (chunked over anchors, each pair's
    value as the full matrix gives it), else the nearest-BEV IoU. Ties of
    the top-k and of the gt assignment go to the lower index."""
    box_coder = box_coder or ResidualCoder()
    A, G = anchors.shape[0], gt_boxes.shape[0]
    if match_height:
        iou = anchor_iou3d(anchors, torch.ones(A, dtype=torch.bool, device=anchors.device),
                           gt_boxes)
    else:
        iou = box_utils.boxes3d_nearest_bev_iou(anchors, gt_boxes)
    iou = torch.where(gt_valid[None, :], iou, torch.full_like(iou, -1.0))
    d = anchors[:, None, :2] - gt_boxes[None, :, :2]
    dist = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])             # (A, G)
    dist = torch.where(gt_valid[None, :], dist, torch.full_like(dist, float("inf")))
    k = min(topk, A)
    cand_idx = torch.sort(dist.T, dim=1, stable=True).indices[:, :k]             # (G, k)
    cand_iou = torch.gather(iou.T, 1, cand_idx)
    thr = cand_iou.mean(dim=1) + cand_iou.std(dim=1, correction=0)               # (G,)

    centers3 = torch.cat([anchors[:, :2], torch.zeros_like(anchors[:, :1])], dim=1)
    gt_flat = torch.cat([gt_boxes[:, :2], torch.zeros_like(gt_boxes[:, :1]), gt_boxes[:, 3:5],
                         torch.full_like(gt_boxes[:, :1], 100.0), gt_boxes[:, 6:7]], dim=1)
    inside = box_utils.points_in_boxes_mask(centers3, gt_flat)                    # (A, G)
    is_cand = torch.zeros((G, A), dtype=torch.bool, device=anchors.device)
    is_cand.scatter_(1, cand_idx, True)
    pos_ga = is_cand & (iou.T >= thr[:, None]) & inside.T & gt_valid[:, None]
    pos = pos_ga.any(dim=0)
    gt_assign = torch.where(pos_ga.T, iou, torch.full_like(iou, -1.0)).argmax(dim=1)
    labels = torch.where(pos, gt_classes.long()[gt_assign], torch.zeros_like(gt_assign))
    reg = box_coder.encode(gt_boxes[gt_assign], anchors)
    reg = torch.where(pos[:, None], reg, torch.zeros_like(reg))
    return labels.to(torch.int32), reg, pos
