"""ROI head plumbing (counterpart of `btcdet_tpu/models/roi_heads/roi_head_utils.py`):

- proposal_layer: per-frame rotated NMS of the RPN boxes into a
  fixed-size roi set with validity masks (reference `roi_head_template.py:45`);
- assign_targets (train): same-class max-IoU roi <-> gt matching, fg / bg
  subsampling at a fixed ROI_PER_IMAGE with hard / easy bg mixing
  (reference `proposal_target_layer.py:8-228`) and canonical-frame
  regression targets with the heading flip (`roi_head_template.py:102-133`).

Every random number of the sampling comes from `draw_roi_sampling_uniforms`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...ops import iou3d
from ...parallel import global_rows
from ...utils import common


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


def max_iou_with_same_class(rois, roi_labels, gt_boxes, gt_labels, gt_valid):
    """(N, 7) rois vs (G, 7) gts, IoU counted for same-class pairs only
    (reference `get_max_iou_with_same_class:195`). Returns (max_iou (N,),
    gt_assignment (N,))."""
    iou = iou3d.boxes_iou3d(rois, gt_boxes)
    same = (roi_labels[:, None] == gt_labels[None, :]) & gt_valid[None, :]
    iou = torch.where(same, iou, torch.full_like(iou, -1.0))
    return iou.max(dim=1).values.clamp(min=0.0), iou.argmax(dim=1)


def draw_roi_sampling_uniforms(generator: torch.Generator, B: int, N: int, R: int):
    """The uniforms [0, 1) of `assign_targets`, per frame: the ranking
    draws of the fg, hard-bg and easy-bg candidates ((B, N) each) and the
    with-replacement picks of hard and easy bg ((B, R) each)."""
    def u(*shape):
        return torch.rand(shape, generator=generator, device=generator.device)
    return u(B, N), u(B, N), u(B, N), u(B, R), u(B, R)


def _ranked(mask, u):
    """Candidates first, in random order: (indices (N,), count)."""
    score = mask.float() * 2.0 + u
    return torch.sort(score, descending=True, stable=True).indices, mask.sum()


def _pick_with_replacement(u, cand_rank_idx, cand_count):
    pos = torch.floor(u * cand_count.clamp(min=1).to(u.dtype)).long()
    return cand_rank_idx[pos.clamp(0, cand_rank_idx.shape[0] - 1)]


def subsample_rois(draws, max_overlaps, roi_valid, *, roi_per_image: int, fg_ratio: float,
                   reg_fg_thresh: float, cls_fg_thresh: float, cls_bg_thresh: float,
                   cls_bg_thresh_lo: float, hard_bg_ratio: float):
    """Reference `ProposalTargetLayer.subsample_rois` for one frame; `draws`
    are the frame's five uniforms. Returns (sampled (R,), is_fg (R,))."""
    u_fg, u_hard, u_easy, u_pick_hard, u_pick_easy = draws
    fg_thresh = min(reg_fg_thresh, cls_fg_thresh)
    fg_mask = (max_overlaps >= fg_thresh) & roi_valid
    easy_mask = (max_overlaps < cls_bg_thresh_lo) & roi_valid
    hard_mask = (max_overlaps < fg_thresh) & (max_overlaps >= cls_bg_thresh_lo) & roi_valid
    fg_idx, fg_cnt = _ranked(fg_mask, u_fg)
    hard_idx, hard_cnt = _ranked(hard_mask, u_hard)
    easy_idx, easy_cnt = _ranked(easy_mask, u_easy)

    R = roi_per_image
    fg_num = torch.clamp(fg_cnt, max=int(round(fg_ratio * R)))
    bg_cnt = hard_cnt + easy_cnt
    # no bg at all: every slot fg (with replacement); no fg: every slot bg
    fg_num = torch.where(bg_cnt == 0, fg_cnt.clamp(min=1).clamp(max=R), fg_num)
    fg_num = torch.where(fg_cnt == 0, torch.zeros_like(fg_num), fg_num)
    bg_num = R - fg_num

    slot = torch.arange(R, device=max_overlaps.device)
    fg_pos = torch.where(fg_cnt > 0, slot % fg_cnt.clamp(min=1), torch.zeros_like(slot))
    fg_pick = fg_idx[fg_pos]
    hard_quota = torch.where(
        (hard_cnt > 0) & (easy_cnt > 0),
        torch.minimum((bg_num * hard_bg_ratio).long(), hard_cnt),
        torch.where(hard_cnt > 0, bg_num, torch.zeros_like(bg_num)))
    hard_pick = _pick_with_replacement(u_pick_hard, hard_idx, hard_cnt)
    easy_pick = _pick_with_replacement(u_pick_easy, easy_idx, easy_cnt)
    is_fg = slot < fg_num
    bg_j = (slot - fg_num).clamp(min=0)
    bg_pick = torch.where(bg_j < hard_quota, hard_pick[bg_j], easy_pick[bg_j])
    return torch.where(is_fg, fg_pick, bg_pick), is_fg


def canonical_reg_targets(rois, gt_of_rois):
    """Matched gts in each roi's canonical frame: translated to the roi
    centre, rotated by -heading, heading flipped into [-pi/2, pi/2]."""
    center = common.rotate_points_along_z((gt_of_rois[..., 0:3] - rois[..., 0:3])[:, None, :],
                                          -rois[:, 6])[:, 0]
    heading = torch.remainder(gt_of_rois[..., 6] - rois[..., 6], 2 * np.pi)
    opposite = (heading > np.pi * 0.5) & (heading < np.pi * 1.5)
    heading = torch.where(opposite, torch.remainder(heading + np.pi, 2 * np.pi), heading)
    heading = torch.where(heading > np.pi, heading - 2 * np.pi, heading)
    heading = heading.clamp(-np.pi / 2, np.pi / 2)
    return torch.cat([center, gt_of_rois[..., 3:6], heading[..., None]], dim=-1)


@torch.no_grad()
def assign_targets(generator, proposals: Proposals, gt_boxes, *, roi_per_image: int,
                   fg_ratio: float, reg_fg_thresh: float, cls_fg_thresh: float,
                   cls_bg_thresh: float, cls_bg_thresh_lo: float, hard_bg_ratio: float):
    """Batch roi sampling and targets. gt_boxes (B, G, 8) (7 + class id).
    Returns rois (B, R, 7), roi_labels, roi_ious, rcnn_cls_labels (IoU
    interpolated), reg_valid_mask, gt_of_rois (canonical), gt_of_rois_src
    (global frame), roi_valid. The uniforms are drawn for the global
    batch; a rank of a data-parallel run keeps its frames' rows."""
    B, N, _ = proposals.rois.shape
    rows, lo = global_rows(B)
    draws = [d[lo:lo + B].to(gt_boxes.device)
             for d in draw_roi_sampling_uniforms(generator, rows, N, roi_per_image)]
    keys = ("rois", "roi_labels", "roi_ious", "rcnn_cls_labels", "reg_valid_mask",
            "gt_of_rois", "gt_of_rois_src", "roi_valid")
    out = {k: [] for k in keys}
    for b in range(B):
        rois, labels, valid = proposals.rois[b], proposals.roi_labels[b], proposals.roi_valid[b]
        gt7, gtc = gt_boxes[b, :, :7], gt_boxes[b, :, 7].long()
        max_iou, gt_assign = max_iou_with_same_class(rois, labels, gt7, gtc, gtc > 0)
        sampled, _ = subsample_rois(
            [d[b] for d in draws], max_iou, valid, roi_per_image=roi_per_image,
            fg_ratio=fg_ratio, reg_fg_thresh=reg_fg_thresh, cls_fg_thresh=cls_fg_thresh,
            cls_bg_thresh=cls_bg_thresh, cls_bg_thresh_lo=cls_bg_thresh_lo,
            hard_bg_ratio=hard_bg_ratio)
        s_rois, s_iou, s_valid = rois[sampled], max_iou[sampled], valid[sampled]
        s_gt = gt7[gt_assign[sampled]]
        cls_label = ((s_iou - cls_bg_thresh) / (cls_fg_thresh - cls_bg_thresh)).clamp(0.0, 1.0)
        cls_label = torch.where(s_iou >= cls_fg_thresh, torch.ones_like(cls_label), cls_label)
        cls_label = torch.where(s_iou <= cls_bg_thresh, torch.zeros_like(cls_label), cls_label)
        for k, v in zip(keys, (s_rois, labels[sampled], s_iou, cls_label,
                               (s_iou >= reg_fg_thresh) & s_valid,
                               canonical_reg_targets(s_rois, s_gt), s_gt, s_valid)):
            out[k].append(v)
    return {k: torch.stack(v) for k, v in out.items()}
