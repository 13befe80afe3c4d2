"""PointHeadSimple (reference OpenPCDet `dense_heads/point_head_simple.py`,
`point_head_template.make_fc_layers`): PV-RCNN's keypoint segmentation
head, eval forward.

    cls_layers = [Linear(bias=False), BatchNorm1d, ReLU] * len(CLS_FC)
                 + [Linear(num_class, bias=True)]

over the keypoint features (before the VSA fusion under
USE_POINT_FEATURES_BEFORE_FUSION), and the keypoint scores the RoI-grid
pool weighs its features by: the sigmoid of the logits, the largest over
the classes. The hidden linears run in `compute_dtype`, the BNs, the
logits and the sigmoid in float32.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class PointHeadSimple(nn.Module):
    def __init__(self, num_class: int, input_channels: int, cls_fc=(256, 256),
                 compute_dtype=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        layers, c = [], int(input_channels)
        for width in cls_fc:
            layers += [nn.Linear(c, int(width), bias=False), nn.BatchNorm1d(int(width)),
                       nn.ReLU()]
            c = int(width)
        layers.append(nn.Linear(c, int(num_class), bias=True))
        self.cls_layers = nn.Sequential(*layers)

    def forward(self, point_features):
        """point_features (..., C) -> (logits (..., num_class) float32,
        scores (...) float32)."""
        layers = list(self.cls_layers)
        shp = point_features.shape
        h = point_features.reshape(-1, shp[-1])
        dt = self.compute_dtype or h.dtype
        for i in range(0, len(layers) - 1, 3):
            h = F.linear(h.to(dt), layers[i].weight.to(dt)).float()
            h = torch.relu(layers[i + 1](h))
        final = layers[-1]
        logits = F.linear(h.float(), final.weight, final.bias).reshape(*shp[:-1], -1)
        return logits, torch.sigmoid(logits).max(dim=-1).values
