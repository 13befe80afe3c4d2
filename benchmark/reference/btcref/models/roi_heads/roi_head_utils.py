"""ROI head plumbing (counterpart of `btcdet_tpu/models/roi_heads/roi_head_utils.py`):

proposal_layer: per-frame rotated NMS of the RPN boxes into a fixed-size
roi set with validity masks (reference `roi_head_template.py:45`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...ops import iou3d


class Proposals(NamedTuple):
    rois: torch.Tensor        # (B, N, 7)
    roi_scores: torch.Tensor  # (B, N)
    roi_labels: torch.Tensor  # (B, N) int64, 1-based
    roi_valid: torch.Tensor   # (B, N) bool


@torch.no_grad()
def proposal_layer(batch_box_preds, batch_cls_preds, batch_valid=None, *,
                   nms_pre: int, nms_post: int, nms_thresh: float) -> Proposals:
    """batch_box_preds (B, A, 7), batch_cls_preds (B, A, C) raw logits."""
    B, A, _ = batch_cls_preds.shape
    if batch_valid is None:
        batch_valid = torch.ones((B, A), dtype=torch.bool, device=batch_cls_preds.device)
    scores_all = batch_cls_preds.max(dim=-1).values
    labels_all = batch_cls_preds.argmax(dim=-1) + 1
    rois, scores, labels, valid = [], [], [], []
    for b in range(B):
        idx, keep = iou3d.nms_rotated(batch_box_preds[b], scores_all[b], batch_valid[b],
                                      thresh=nms_thresh, pre_max_size=nms_pre,
                                      post_max_size=nms_post)
        rois.append(batch_box_preds[b][idx])
        scores.append(scores_all[b][idx])
        labels.append(labels_all[b][idx])
        valid.append(keep)
    rois, scores, labels, valid = (torch.stack(x) for x in (rois, scores, labels, valid))
    rois = torch.where(valid[..., None], rois, torch.zeros_like(rois))
    return Proposals(rois, torch.where(valid, scores, torch.zeros_like(scores)), labels, valid)
