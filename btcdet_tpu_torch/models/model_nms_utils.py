"""NMS functions of the reference's `model_nms_utils.py` surface
(counterpart of `btcdet_tpu/models/model_nms_utils.py`) over the port's
rotated NMS (`iou3d.nms_rotated`). Every yaml sets MULTI_CLASSES_NMS
False; post-processing calls `iou3d.nms_rotated_batched` itself."""

from __future__ import annotations

import torch

from ..ops import iou3d


def class_agnostic_nms(box_scores, box_preds, nms_config, score_thresh=None):
    """box_scores (N,), box_preds (N, 7) -> (selected idx (post,), valid
    (post,)): the boxes at or above `score_thresh` (all when None) through
    rotated NMS with the config's NMS_THRESH, NMS_PRE_MAXSIZE and
    NMS_POST_MAXSIZE."""
    valid = torch.ones_like(box_scores, dtype=torch.bool)
    if score_thresh is not None:
        valid = box_scores >= score_thresh
    return iou3d.nms_rotated(box_preds, box_scores, valid, thresh=float(nms_config.NMS_THRESH),
                             pre_max_size=int(nms_config.NMS_PRE_MAXSIZE),
                             post_max_size=int(nms_config.NMS_POST_MAXSIZE))


def multi_classes_nms(cls_scores, box_preds, nms_config, score_thresh=None):
    """Per-class NMS (reference `model_nms_utils.py:33-65`): cls_scores
    (N, C) -> a list over the classes of (idx, valid, label), label the
    class id c + 1 beside every index."""
    out = []
    for c in range(cls_scores.shape[1]):
        idx, v = class_agnostic_nms(cls_scores[:, c], box_preds, nms_config, score_thresh)
        out.append((idx, v, torch.full_like(idx, c + 1)))
    return out
