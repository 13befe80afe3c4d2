"""RPN anchor head (counterpart of `btcdet_tpu/models/dense_heads/anchor_head.py`):
anchor generation, the 1x1 conv heads and the ResidualCoder decode with
direction bins; at train, the axis-aligned target assignment (nearest-BEV
IoU, or with MATCH_HEIGHT the rotated 3-D IoU) and the focal cls /
sin-difference smooth-L1 / direction-bin losses."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import iou3d
from ...parallel import global_rows
from ...utils import box_utils, common, loss_utils
from ...utils.box_coder import ResidualCoder


def generate_anchors(anchor_range, grid_size, anchor_configs):
    """Dense anchors (reference `anchor_generator.py`), laid out
    [y, x, class, size, rot] to match the conv output. grid_size: (nx, ny)
    of the full det grid. Returns (anchors (A, 7) float32, anchor_class
    (A,) int32, anchors per location)."""
    per_class_loc = []
    strides = {cfg["feature_map_stride"] for cfg in anchor_configs}
    assert len(strides) == 1, "mixed feature_map_stride unsupported"
    num_per_loc = 0
    for cfg in anchor_configs:
        stride = cfg["feature_map_stride"]
        gx, gy = int(grid_size[0] // stride), int(grid_size[1] // stride)
        sizes = np.array(cfg["anchor_sizes"], np.float32)
        rots = np.array(cfg["anchor_rotations"], np.float32)
        heights = np.array(cfg["anchor_bottom_heights"], np.float32)
        if cfg.get("align_center", False):
            x_stride = (anchor_range[3] - anchor_range[0]) / gx
            y_stride = (anchor_range[4] - anchor_range[1]) / gy
            x_off, y_off = x_stride / 2, y_stride / 2
        else:
            x_stride = (anchor_range[3] - anchor_range[0]) / (gx - 1)
            y_stride = (anchor_range[4] - anchor_range[1]) / (gy - 1)
            x_off, y_off = 0.0, 0.0
        xs = anchor_range[0] + x_off + x_stride * np.arange(gx, dtype=np.float32)
        ys = anchor_range[1] + y_off + y_stride * np.arange(gy, dtype=np.float32)
        Z, S, R = len(heights), len(sizes), len(rots)
        a = np.zeros((Z, gy, gx, S, R, 7), np.float32)
        a[..., 0] = xs[None, None, :, None, None]
        a[..., 1] = ys[None, :, None, None, None]
        a[..., 2] = heights[:, None, None, None, None]
        a[..., 3:6] = sizes[None, None, None, :, None, :]
        a[..., 6] = rots[None, None, None, None, :]
        a[..., 2] += a[..., 5] / 2  # bottom -> center z
        per_class_loc.append(a.transpose(1, 2, 0, 3, 4, 5).reshape(gy, gx, -1, 7))
        num_per_loc += S * R * Z
    stacked = np.concatenate(per_class_loc, axis=2)
    anchor_class = np.concatenate([
        np.full((arr.shape[2],), ci, np.int32) for ci, arr in enumerate(per_class_loc)
    ])
    gy, gx = stacked.shape[:2]
    anchor_class = np.tile(anchor_class[None, None], (gy, gx, 1)).reshape(-1)
    return stacked.reshape(-1, 7), anchor_class, num_per_loc


# anchor-gt pairs of one rotated 3-D IoU call: the clipping keeps a few
# (pairs, 64, 2) float tensors alive, about 0.5 KiB a pair each
IOU3D_CHUNK_PAIRS = 1 << 18


def anchor_iou3d(anchors, anchor_sel, gt_boxes):
    """(A, G) rotated 3-D IoU of the selected anchors with the gts, -1 for
    the others, computed over chunks of anchors (IOU3D_CHUNK_PAIRS pairs at
    most): each pair's IoU is elementwise, so a chunk gives the same bits
    as the whole matrix."""
    A, G = anchors.shape[0], gt_boxes.shape[0]
    iou = torch.full((A, G), -1.0, dtype=anchors.dtype, device=anchors.device)
    idx = anchor_sel.nonzero()[:, 0]
    rows = max(IOU3D_CHUNK_PAIRS // max(G, 1), 1)
    for lo in range(0, idx.numel(), rows):
        part = idx[lo:lo + rows]
        iou[part] = iou3d.boxes_iou3d(anchors[part], gt_boxes)
    return iou


def assign_targets_single_class(anchors, anchor_sel, gt_boxes, gt_valid, gt_class_id: int,
                                matched_threshold: float, unmatched_threshold: float,
                                box_coder, match_height: bool = False):
    """AxisAlignedTargetAssigner for one class (reference
    `axis_aligned_target_assigner.py:131-213`): nearest-BEV IoU, or the
    rotated 3-D IoU with `match_height` (MATCH_HEIGHT). anchors (A, 7),
    anchor_sel (A,) marks this class's anchors, gt_boxes (G, 7), gt_valid
    (G,). Returns (labels (A,) in {-1, 0, class id}, reg_targets (A, 7),
    reg_mask (A,))."""
    iou = (anchor_iou3d(anchors, anchor_sel, gt_boxes) if match_height
           else box_utils.boxes3d_nearest_bev_iou(anchors, gt_boxes))
    iou = torch.where(gt_valid[None, :] & anchor_sel[:, None], iou, torch.full_like(iou, -1.0))
    a2g_max, a2g_arg = iou.max(dim=1)
    g2a_max = iou.max(dim=0).values
    # empty gts (max iou 0) never force a match
    g_force = gt_valid & (g2a_max > 0)
    force = ((iou == g2a_max[None, :]) & g_force[None, :]).any(dim=1) & anchor_sel
    labels = torch.full(anchors.shape[:1], -1, dtype=torch.int64, device=anchors.device)
    labels = torch.where(a2g_max < unmatched_threshold, torch.zeros_like(labels), labels)
    pos = (a2g_max >= matched_threshold) & anchor_sel
    reg_mask = pos | force
    labels = torch.where(reg_mask, torch.full_like(labels, gt_class_id), labels)
    reg_targets = box_coder.encode(gt_boxes[a2g_arg], anchors)
    reg_targets = torch.where(reg_mask[:, None], reg_targets, torch.zeros_like(reg_targets))
    return labels, reg_targets, reg_mask


def get_direction_target(anchors, reg_targets, dir_offset: float, num_dir_bins: int):
    """Direction-bin targets (reference `anchor_head_template.py:148-163`)."""
    rot_gt = reg_targets[..., 6] + anchors[..., 6]
    offset_rot = common.limit_period(rot_gt - dir_offset, 0, 2 * np.pi)
    return torch.floor(offset_rot / (2 * np.pi / num_dir_bins)).long().clamp(0, num_dir_bins - 1)


class AnchorHeadSingle(nn.Module):
    """1x1-conv RPN head over the BEV map (reference `anchor_head_single.py`
    names: conv_cls, conv_box, conv_dir_cls)."""

    def __init__(self, input_channels, num_class, anchors, num_anchors_per_location,
                 use_direction_classifier=True, dir_offset=0.78539, dir_limit_offset=0.0,
                 num_dir_bins=2, anchor_class=None, matched_thresholds=(0.6,),
                 unmatched_thresholds=(0.45,), cls_weight=1.0,
                 loc_weight=2.0, dir_weight=0.2, code_weights=(1.0,) * 7,
                 match_height: bool = False):
        super().__init__()
        self.match_height = match_height
        self.num_class = num_class
        if anchor_class is None:
            anchor_class = np.zeros((np.asarray(anchors).shape[0],), np.int32)
        self.register_buffer("anchor_class", torch.as_tensor(anchor_class).long(),
                             persistent=False)
        self.matched_thresholds = tuple(float(v) for v in matched_thresholds)
        self.unmatched_thresholds = tuple(float(v) for v in unmatched_thresholds)
        self.cls_weight, self.loc_weight, self.dir_weight = cls_weight, loc_weight, dir_weight
        self.code_weights = tuple(float(v) for v in code_weights)
        self.box_coder = ResidualCoder()
        na = num_anchors_per_location
        self.conv_cls = nn.Conv2d(input_channels, na * num_class, 1)
        self.conv_box = nn.Conv2d(input_channels, na * self.box_coder.code_size, 1)
        self.conv_dir_cls = (nn.Conv2d(input_channels, na * num_dir_bins, 1)
                             if use_direction_classifier else None)
        # the JAX package's init: focal prior on the cls bias, small box weights
        nn.init.constant_(self.conv_cls.bias, -float(np.log((1 - 0.01) / 0.01)))
        nn.init.normal_(self.conv_box.weight, std=0.001)
        self.register_buffer("anchors", torch.as_tensor(anchors), persistent=False)
        self.dir_offset, self.dir_limit_offset = dir_offset, dir_limit_offset
        self.num_dir_bins = num_dir_bins

    @staticmethod
    def _flat(x, n):
        """(B, na*n, H, W) -> (B, H*W*na, n): anchor index = (y*W + x)*na + a."""
        B = x.shape[0]
        return x.permute(0, 2, 3, 1).reshape(B, -1, n)

    def forward(self, x):
        """x (B, C, H, W) -> dict cls_preds (B, A, nc), box_preds (B, A, 7),
        dir_preds, batch_box_preds (decoded)."""
        x = x.float()
        out = {"cls_preds": self._flat(self.conv_cls(x), self.num_class),
               "box_preds": self._flat(self.conv_box(x), self.box_coder.code_size)}
        if self.conv_dir_cls is not None:
            out["dir_preds"] = self._flat(self.conv_dir_cls(x), self.num_dir_bins)
        out["batch_box_preds"] = self._decode(out["box_preds"], out.get("dir_preds"))
        return out

    def _decode(self, box_preds, dir_preds):
        boxes = self.box_coder.decode(box_preds, self.anchors[None])
        if dir_preds is not None:
            # snap the heading into the bin the direction classifier picks
            dir_labels = torch.argmax(dir_preds, dim=-1)
            period = 2 * np.pi / self.num_dir_bins
            dir_rot = common.limit_period(boxes[..., 6] - self.dir_offset,
                                          self.dir_limit_offset, period)
            heading = dir_rot + self.dir_offset + period * dir_labels.to(boxes.dtype)
            boxes = torch.cat([boxes[..., :6], heading[..., None], boxes[..., 7:]], dim=-1)
        return boxes

    def assign_targets(self, gt_boxes):
        """gt_boxes (B, G, 8), class id (1-based, 0 pads) last. Returns
        box_cls_labels (B, A), box_reg_targets (B, A, 7), box_reg_mask."""
        A = self.anchors.shape[0]
        labels_b, reg_b, mask_b = [], [], []
        for gt in gt_boxes:
            gt7, gt_cls = gt[:, :7], gt[:, 7].long()
            labels = torch.full((A,), -1, dtype=torch.int64, device=gt.device)
            reg = torch.zeros((A, self.box_coder.code_size), device=gt.device)
            mask = torch.zeros((A,), dtype=torch.bool, device=gt.device)
            for ci in range(self.num_class):
                sel = self.anchor_class == ci
                lab, regt, regm = assign_targets_single_class(
                    self.anchors, sel, gt7, (gt_cls > 0) & (gt_cls == ci + 1), ci + 1,
                    self.matched_thresholds[ci], self.unmatched_thresholds[ci],
                    self.box_coder, self.match_height)
                labels = torch.where(sel, lab, labels)
                reg = torch.where(sel[:, None], regt, reg)
                mask = torch.where(sel, regm, mask)
            labels_b.append(labels)
            reg_b.append(reg)
            mask_b.append(mask)
        return {"box_cls_labels": torch.stack(labels_b), "box_reg_targets": torch.stack(reg_b),
                "box_reg_mask": torch.stack(mask_b)}

    def get_loss(self, out):
        """Reference `anchor_head_template.get_cls_layer_loss` /
        `get_box_reg_layer_loss`; `out` holds the forward's predictions and
        `assign_targets`'. Returns (total, {rpn_loss_cls, rpn_loss_loc,
        rpn_loss_dir, rpn_loss}); the terms are per frame of the global
        batch (all ranks' frames in a data-parallel run)."""
        cls_preds, box_preds = out["cls_preds"], out["box_preds"]
        labels, reg_targets = out["box_cls_labels"], out["box_reg_targets"]
        B = global_rows(cls_preds.shape[0])[0]
        positives, negatives = labels > 0, labels == 0
        pos_norm = positives.sum(dim=1, keepdim=True).float().clamp(min=1.0)
        cls_weights = (negatives.float() + positives.float()) / pos_norm
        reg_weights = positives.float() / pos_norm
        cls_targets = torch.where(labels >= 0, labels, torch.zeros_like(labels))
        one_hot = F.one_hot(cls_targets, self.num_class + 1).to(cls_preds.dtype)[..., 1:]
        cls_loss = loss_utils.sigmoid_focal_loss(cls_preds, one_hot).sum(-1)
        cls_loss = (cls_loss * cls_weights).sum() / B * self.cls_weight
        # sin-difference heading encoding (reference `add_sin_difference`)
        pr, tr = box_preds[..., 6], reg_targets[..., 6]
        box_p = torch.cat([box_preds[..., :6], (torch.sin(pr) * torch.cos(tr))[..., None],
                           box_preds[..., 7:]], -1)
        box_t = torch.cat([reg_targets[..., :6], (torch.cos(pr) * torch.sin(tr))[..., None],
                           reg_targets[..., 7:]], -1)
        loc_loss = loss_utils.weighted_smooth_l1_loss(
            box_p, box_t, weights=reg_weights, code_weights=self.code_weights).sum() / B
        loc_loss = loc_loss * self.loc_weight
        losses = {"rpn_loss_cls": cls_loss, "rpn_loss_loc": loc_loss}
        total = cls_loss + loc_loss
        if self.conv_dir_cls is not None and "dir_preds" in out:
            dir_targets = get_direction_target(self.anchors[None], reg_targets, self.dir_offset,
                                               self.num_dir_bins)
            dir_onehot = F.one_hot(dir_targets, self.num_dir_bins).to(cls_preds.dtype)
            dir_loss = loss_utils.weighted_cross_entropy(out["dir_preds"], dir_onehot,
                                                         weights=reg_weights).sum() / B
            losses["rpn_loss_dir"] = dir_loss * self.dir_weight
            total = total + losses["rpn_loss_dir"]
        losses["rpn_loss"] = total
        return total, losses
