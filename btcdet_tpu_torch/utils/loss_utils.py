"""Loss functions (counterpart of `btcdet_tpu/utils/loss_utils.py`,
reference `btcdet/utils/loss_utils.py`).

Each returns the per-element loss (the caller weights and normalises):
sigmoid focal (gamma 2, alpha 0.25), the occ head's softmax focal,
smooth-L1 with per-dim code weights (nan targets ignored), weighted cross
entropy, BCE with logits and the heading-flip corner loss.
"""

from __future__ import annotations

import numpy as np
import torch

from . import box_utils


def binary_cross_entropy_with_logits(logits, targets):
    # max(x, 0) as `torch.maximum`, whose gradient at x == 0 is 1/2, as that
    # of the JAX package's `jnp.clip` (`clamp`'s is 1): the occ head's
    # logits sit at exactly 0 off the occ backbone's active sites when the
    # bias is 0
    zero = torch.zeros((), dtype=logits.dtype, device=logits.device)
    return torch.maximum(logits, zero) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def sigmoid_focal_loss(logits, targets, gamma: float = 2.0, alpha: float = 0.25):
    """logits, targets (..., C); targets one-hot {0, 1} floats."""
    p = torch.sigmoid(logits)
    alpha_weight = targets * alpha + (1 - targets) * (1 - alpha)
    pt = targets * (1.0 - p) + (1.0 - targets) * p
    return alpha_weight * torch.pow(pt, gamma) * binary_cross_entropy_with_logits(logits, targets)


def softmax_focal_loss(logits, targets_onehot, alpha: float = 0.5, gamma: float = 2.0):
    """Softmax focal loss over the last axis (occ head)."""
    logp = torch.log_softmax(logits, dim=-1)
    focal = alpha * torch.pow(1.0 - torch.exp(logp), gamma)
    return -(targets_onehot * focal * logp).sum(dim=-1)


def smooth_l1_loss(diff, beta: float = 1.0 / 9.0):
    if beta < 1e-5:
        return diff.abs()
    n = diff.abs()
    return torch.where(n < beta, 0.5 * n * n / beta, n - 0.5 * beta)


def weighted_smooth_l1_loss(preds, targets, weights=None, beta: float = 1.0 / 9.0,
                            code_weights=None):
    """preds / targets (B, N, C), weights (B, N) -> (B, N, C)."""
    targets = torch.where(torch.isnan(targets), preds, targets)
    diff = preds - targets
    if code_weights is not None:
        diff = diff * torch.as_tensor(code_weights, dtype=diff.dtype, device=diff.device)
    loss = smooth_l1_loss(diff, beta)
    if weights is not None:
        loss = loss * weights[..., None]
    return loss


def weighted_cross_entropy(logits, targets_onehot, weights=None):
    """(B, N, C) logits vs one-hot -> (B, N)."""
    loss = -(targets_onehot * torch.log_softmax(logits, dim=-1)).sum(dim=-1)
    return loss if weights is None else loss * weights


def get_corner_loss_lidar(pred_boxes, gt_boxes, beta: float = 1.0):
    """Corner distance with the heading-flip minimum: (N, 7) x (N, 7) -> (N,)."""
    pred_c = box_utils.boxes_to_corners_3d(pred_boxes)
    gt_c = box_utils.boxes_to_corners_3d(gt_boxes)
    flip = torch.cat([gt_boxes[:, 0:6], gt_boxes[:, 6:7] + np.pi, gt_boxes[:, 7:]], dim=-1)
    gt_cf = box_utils.boxes_to_corners_3d(flip)
    dist = torch.minimum(torch.linalg.norm(pred_c - gt_c, dim=-1),
                         torch.linalg.norm(pred_c - gt_cf, dim=-1))
    return smooth_l1_loss(dist, beta=beta).mean(dim=1)
