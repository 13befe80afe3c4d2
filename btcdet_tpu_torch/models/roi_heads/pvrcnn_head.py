"""PVRCNNHead (reference OpenPCDet `roi_heads/pvrcnn_head.py` and
`roi_head_template.py`): PV-RCNN's RoI-grid head, eval forward.

Each roi's GRID_SIZE^3 grid points (`conv_head.global_roi_grid_points`,
ordered x-major as OpenPCDet's `get_dense_grid_points` lists them) pool
the keypoints' VSA features, weighted by the point head's scores, through
one multi-scale SA module (`roi_grid_pool_layer`: the exact ball query at
each radius, MLPs, max pool; an empty ball pools the MLP of zeros, as
OpenPCDet's stack SA does). The pooled grid is flattened C-major into the
shared FCs, then the cls and reg FCs (`conv_head._fc_trunk` layout:
[Conv1d, BN1d, ReLU] a layer, dropout at DP_RATIO in train mode, a biased
output Conv1d). The residuals decode in the roi frame as ConvHead's do.

The grid pool's MLPs and the hidden FCs run in `compute_dtype`, the BNs,
the output projections and the decode in float32. Ball tallies a frame
`roi_grid.balls` / `roi_grid.balls_empty` (one call a radius).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ...ops import group_ops
from ...utils.box_coder import ResidualCoder
from . import conv_head


class PVRCNNHead(nn.Module):
    def __init__(self, num_class: int, input_channels: int, grid_size: int = 6,
                 mlps=((64, 64), (64, 64)), radii=(0.8, 1.6), nsamples=(16, 16),
                 pool_method: str = "max_pool", shared_fc=(256, 256), cls_fc=(256, 256),
                 reg_fc=(256, 256), dp_ratio: float = 0.3, compute_dtype=None):
        super().__init__()
        self.grid_size = int(grid_size)
        self.compute_dtype = compute_dtype
        self.box_coder = ResidualCoder()
        self.roi_grid_pool_layer = group_ops.PointSAModuleMSG(
            radii, nsamples, [[int(input_channels) + 3, *m] for m in mlps], dtype=compute_dtype,
            pool_method=pool_method, tally="roi_grid")
        c_pool = sum(m[-1] for m in mlps)
        self.shared_fc_layer = nn.Module()
        n_shared = len(shared_fc)
        c = conv_head._fc_trunk(self.shared_fc_layer, shared_fc, c_pool * self.grid_size ** 3,
                                dp_ratio, lambda i: i != n_shared - 1)
        self.cls_layers = nn.Module()
        conv_head._fc_trunk(self.cls_layers, cls_fc, c, dp_ratio, lambda i: i == 0, num_class)
        self.reg_layers = nn.Module()
        conv_head._fc_trunk(self.reg_layers, reg_fc, c, dp_ratio, lambda i: i == 0,
                            self.box_coder.code_size * num_class)

    def grid_points(self, rois):
        """(B, N, 7) -> (B, N, G^3, 3) global grid points, x-major."""
        g = self.grid_size
        pts = conv_head.global_roi_grid_points(rois, (g, g, g))       # z-major
        B, N = rois.shape[:2]
        return pts.reshape(B, N, g, g, g, 3).permute(0, 1, 4, 3, 2, 5).reshape(B, N, g ** 3, 3)

    def roi_grid_pool(self, rois, roi_valid, keypoints, kp_mask, point_features, point_scores):
        """The keypoint features (B, K, C), weighted by the point scores (B,
        K), pooled at every roi's grid points: (B, N * G^3, C_pool)."""
        B, N = rois.shape[:2]
        G = self.grid_size ** 3
        new_xyz = self.grid_points(rois).reshape(B, N * G, 3)
        new_mask = roi_valid[:, :, None].expand(B, N, G).reshape(B, N * G)
        feats = point_features.float() * point_scores[..., None].float()
        return self.roi_grid_pool_layer(keypoints, kp_mask, new_xyz, new_mask, features=feats)

    def forward(self, pooled, roi_valid):
        """pooled (B, N * G^3, C) of `roi_grid_pool` -> (rcnn_cls (B * N,
        num_class), rcnn_reg (B * N, 7)), float32."""
        B, N = roi_valid.shape
        G = self.grid_size ** 3
        C = pooled.shape[-1]
        flat = pooled.reshape(B * N, G, C).permute(0, 2, 1).reshape(B * N, C * G)
        mask = roi_valid.reshape(B * N)
        cd = self.compute_dtype or flat.dtype
        h = conv_head._run_trunk(self.shared_fc_layer, flat, mask, cd)
        return (conv_head._run_trunk(self.cls_layers, h, mask, cd),
                conv_head._run_trunk(self.reg_layers, h, mask, cd))

    # ConvHead's decode of the residuals in the roi frame
    _to_global = conv_head.ConvHead._to_global
    generate_predicted_boxes = conv_head.ConvHead.generate_predicted_boxes
