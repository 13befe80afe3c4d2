"""Dense BEV 2D backbone (counterpart of `btcdet_tpu/models/backbones_2d.py`,
reference `base_bev_backbone.py`): conv pyramid with per-block stride,
transposed-conv upsampling and channel concat, in the reference module
layout (`blocks.{i}` = ZeroPad2d, then [Conv2d, BN, ReLU] * (n+1);
`deblocks.{i}` = [ConvTranspose2d, BN, ReLU]). A fractional
UPSAMPLE_STRIDES entry s < 1 downsamples instead, as the JAX package builds
it: a 1x1 Conv2d of stride round(1 / s) (the anchors' `feature_map_stride`
must then follow the coarser map). NCHW inside.

The reference runs it in eval mode on one device only."""

from __future__ import annotations

import torch
import torch.nn as nn

from ..utils.common import activation_dtype


class BaseBEVBackbone(nn.Module):
    def __init__(self, input_channels, layer_nums, layer_strides, num_filters,
                 upsample_strides, num_upsample_filters):
        super().__init__()
        self.blocks = nn.ModuleList()
        self.deblocks = nn.ModuleList()
        c_in = input_channels
        for i, n in enumerate(layer_nums):
            layers = [nn.ZeroPad2d(1),
                      nn.Conv2d(c_in, num_filters[i], 3, layer_strides[i], padding=0, bias=False),
                      nn.BatchNorm2d(num_filters[i], eps=1e-3, momentum=0.01), nn.ReLU()]
            for _ in range(n):
                layers += [nn.Conv2d(num_filters[i], num_filters[i], 3, padding=1, bias=False),
                           nn.BatchNorm2d(num_filters[i], eps=1e-3, momentum=0.01), nn.ReLU()]
            self.blocks.append(nn.Sequential(*layers))
            if i < len(upsample_strides):
                s = upsample_strides[i]
                up = (nn.ConvTranspose2d(num_filters[i], num_upsample_filters[i], int(s),
                                         stride=int(s), bias=False) if s >= 1 else
                      nn.Conv2d(num_filters[i], num_upsample_filters[i], 1,
                                stride=int(round(1 / s)), bias=False))
                self.deblocks.append(nn.Sequential(
                    up,
                    nn.BatchNorm2d(num_upsample_filters[i], eps=1e-3, momentum=0.01),
                    nn.ReLU()))
            c_in = num_filters[i]

    def _run(self, seq, x):
        """Convs in the activation dtype, BN and ReLU in float32."""
        dt = activation_dtype()
        for m in seq:
            if isinstance(m, nn.Conv2d):
                x = m._conv_forward(x.to(dt), m.weight.to(dt), None)
            elif isinstance(m, nn.ConvTranspose2d):
                x = nn.functional.conv_transpose2d(x.to(dt), m.weight.to(dt), None, m.stride)
            elif isinstance(m, nn.BatchNorm2d):
                x = m(x.float())
            else:
                x = m(x)
        return x

    def forward(self, x):
        """x (B, C, H, W) -> (B, sum(num_upsample_filters), H, W) float32."""
        ups = []
        for i, block in enumerate(self.blocks):
            x = self._run(block, x)
            if i < len(self.deblocks):
                ups.append(self._run(self.deblocks[i], x))
        if len(ups) > 1:
            return torch.cat(ups, dim=1)
        return ups[0] if ups else x
