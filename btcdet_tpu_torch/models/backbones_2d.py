"""Dense BEV 2D backbone (counterpart of `btcdet_tpu/models/backbones_2d.py`,
reference `base_bev_backbone.py`): conv pyramid with per-block stride,
transposed-conv upsampling and channel concat, in the reference module
layout (`blocks.{i}` = ZeroPad2d, then [Conv2d, BN, ReLU] * (n+1);
`deblocks.{i}` = [ConvTranspose2d, BN, ReLU]). A fractional
UPSAMPLE_STRIDES entry s < 1 downsamples instead, as the JAX package builds
it: a 1x1 Conv2d of stride round(1 / s) (the anchors' `feature_map_stride`
must then follow the coarser map). NCHW inside.

`row_sharded=True` runs the pyramid on this rank's row slab of the map
(`parallel.spatial`, the JAX package's `bev_sharding`): every 3x3 conv
reads one halo row from each neighbouring slab (`halo_rows`; zero at the
map's edges, as ZeroPad2d) and pads W itself; a stride-2 conv reads only
the row above; the deblocks (ConvTranspose2d with k = stride, or the 1x1
strided conv) need no halo; the BNs sum over every rank of the run
(`over="dp_sp"`). The module and parameter names do not change."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel import all_reduce_sum, halo_rows
from ..utils.common import activation_dtype


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d whose train mode moves the running variance towards the
    BIASED batch variance, as flax's `nn.BatchNorm` (the JAX package's
    `backbones_2d._BN`) does; torch's own BatchNorm2d uses the unbiased one.
    The statistics are the global batch's: the count and the sums, then
    the squared deviations, summed over the ranks of a data-parallel run
    through the differentiable all-reduce, in float64 and rounded to
    float32 once (the same bits however the frames are split, as
    `ops.sparse.MaskedBatchNorm`). `over` names the ranks the sums run
    over: "dp" (the frames), or "dp_sp" when each rank holds a row slab.
    Eval mode is torch's."""

    over = "dp"

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        xf = x.float()
        n = xf.shape[0] * xf.shape[2] * xf.shape[3]
        stats = all_reduce_sum(torch.cat([xf.double().sum(dim=(0, 2, 3)),
                                          torch.full((1,), n, dtype=torch.float64,
                                                     device=x.device)]),
                               differentiable=True, over=self.over)
        cnt = stats[-1].detach()
        mean = (stats[:-1] / cnt).float()
        var = (all_reduce_sum(((xf - mean[:, None, None]) ** 2).double().sum(dim=(0, 2, 3)),
                              differentiable=True, over=self.over) / cnt).float()
        with torch.no_grad():
            mom = self.momentum
            self.running_mean.mul_(1 - mom).add_(mom * mean.detach())
            self.running_var.mul_(1 - mom).add_(mom * var.detach())
            self.num_batches_tracked += 1
        y = (xf - mean[:, None, None]) * torch.rsqrt(var + self.eps)[:, None, None]
        return y * self.weight[:, None, None] + self.bias[:, None, None]


class BaseBEVBackbone(nn.Module):
    def __init__(self, input_channels, layer_nums, layer_strides, num_filters,
                 upsample_strides, num_upsample_filters, row_sharded: bool = False):
        super().__init__()
        self.row_sharded = bool(row_sharded)
        self.layer_strides = tuple(int(s) for s in layer_strides[:len(layer_nums)])
        self.upsample_strides = tuple(upsample_strides)
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
        if self.row_sharded:
            for m in self.modules():
                if isinstance(m, BatchNorm2d):
                    m.over = "dp_sp"

    def check_rows(self, H: int, sp: int):
        """Refuse, by level, a split of an H-row map over `sp` row slabs
        that the pyramid cannot run: each level's rows must divide by sp,
        and each slab by the stride of the conv that reads it (a
        stride-2 conv then needs only the row above; the strided 1x1
        deblock reads rows at multiples of its stride)."""
        for i, s in enumerate(self.layer_strides):
            if H % sp:
                raise ValueError(f"BEV row sharding: level {i} has {H} rows, which do not "
                                 f"split over sp={sp} ranks")
            slab = H // sp
            if slab % s:
                raise ValueError(f"BEV row sharding: level {i}'s slab of {slab} rows does not "
                                 f"divide by its conv's stride {s}")
            H //= s
            if i < len(self.upsample_strides) and self.upsample_strides[i] < 1:
                r = int(round(1 / self.upsample_strides[i]))
                if (H // sp) % r:
                    raise ValueError(f"BEV row sharding: deblock {i}'s slab of {H // sp} rows "
                                     f"does not divide by its stride {r}")

    def _run(self, seq, x):
        """Convs in the activation dtype, BN and ReLU in float32. On a row
        slab each 3x3 conv reads its halo rows and pads W itself."""
        dt = activation_dtype()
        for m in seq:
            if isinstance(m, nn.ZeroPad2d) and self.row_sharded:
                continue                   # the conv after it reads its halo
            if isinstance(m, nn.Conv2d) and self.row_sharded and m.kernel_size[0] == 3:
                # the halo in float32: its backward adds the neighbour's
                # part of a halo row's gradient before one rounding
                x = F.conv2d(F.pad(halo_rows(x.float()), (1, 1, 0, 0)).to(dt),
                             m.weight.to(dt), None, m.stride)
            elif isinstance(m, nn.Conv2d):
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
