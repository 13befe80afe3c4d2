"""Dense BEV 2D backbone (counterpart of `btcdet_tpu/models/backbones_2d.py`,
reference `base_bev_backbone.py`): conv pyramid with per-block stride,
transposed-conv upsampling and channel concat, in the reference module
layout (`blocks.{i}` = ZeroPad2d, then [Conv2d, BN, ReLU] * (n+1);
`deblocks.{i}` = [ConvTranspose2d, BN, ReLU]). A fractional
UPSAMPLE_STRIDES entry s < 1 downsamples instead, as the JAX package builds
it: a 1x1 Conv2d of stride round(1 / s) (the anchors' `feature_map_stride`
must then follow the coarser map). NCHW inside."""

from __future__ import annotations

import torch
import torch.nn as nn

from ..parallel import all_reduce_sum
from ..utils.common import activation_dtype


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d whose train mode moves the running variance towards the
    BIASED batch variance, as flax's `nn.BatchNorm` (the JAX package's
    `backbones_2d._BN`) does; torch's own BatchNorm2d uses the unbiased one.
    The statistics are the global batch's: the count and the sums, then
    the squared deviations, summed over the ranks of a data-parallel run
    through the differentiable all-reduce, in float64 and rounded to
    float32 once (the same bits however the frames are split, as
    `ops.sparse.MaskedBatchNorm`). Eval mode is torch's."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        xf = x.float()
        n = xf.shape[0] * xf.shape[2] * xf.shape[3]
        stats = all_reduce_sum(torch.cat([xf.double().sum(dim=(0, 2, 3)),
                                          torch.full((1,), n, dtype=torch.float64,
                                                     device=x.device)]), differentiable=True)
        cnt = stats[-1].detach()
        mean = (stats[:-1] / cnt).float()
        var = (all_reduce_sum(((xf - mean[:, None, None]) ** 2).double().sum(dim=(0, 2, 3)),
                              differentiable=True) / cnt).float()
        with torch.no_grad():
            mom = self.momentum
            self.running_mean.mul_(1 - mom).add_(mom * mean.detach())
            self.running_var.mul_(1 - mom).add_(mom * var.detach())
            self.num_batches_tracked += 1
        y = (xf - mean[:, None, None]) * torch.rsqrt(var + self.eps)[:, None, None]
        return y * self.weight[:, None, None] + self.bias[:, None, None]


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
                      BatchNorm2d(num_filters[i], eps=1e-3, momentum=0.01), nn.ReLU()]
            for _ in range(n):
                layers += [nn.Conv2d(num_filters[i], num_filters[i], 3, padding=1, bias=False),
                           BatchNorm2d(num_filters[i], eps=1e-3, momentum=0.01), nn.ReLU()]
            self.blocks.append(nn.Sequential(*layers))
            if i < len(upsample_strides):
                s = upsample_strides[i]
                up = (nn.ConvTranspose2d(num_filters[i], num_upsample_filters[i], int(s),
                                         stride=int(s), bias=False) if s >= 1 else
                      nn.Conv2d(num_filters[i], num_upsample_filters[i], 1,
                                stride=int(round(1 / s)), bias=False))
                self.deblocks.append(nn.Sequential(
                    up,
                    BatchNorm2d(num_upsample_filters[i], eps=1e-3, momentum=0.01),
                    nn.ReLU()))
            c_in = num_filters[i]

    @staticmethod
    def _run(seq, x):
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
