"""RPN anchor head (counterpart of `btcdet_tpu/models/dense_heads/anchor_head.py`):
anchor generation, the 1x1 conv heads and the ResidualCoder decode with
direction bins."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from ...utils import common
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


class AnchorHeadSingle(nn.Module):
    """1x1-conv RPN head over the BEV map (reference `anchor_head_single.py`
    names: conv_cls, conv_box, conv_dir_cls)."""

    def __init__(self, input_channels, num_class, anchors, num_anchors_per_location,
                 use_direction_classifier=True, dir_offset=0.78539, dir_limit_offset=0.0,
                 num_dir_bins=2):
        super().__init__()
        self.num_class = num_class
        self.box_coder = ResidualCoder()
        na = num_anchors_per_location
        self.conv_cls = nn.Conv2d(input_channels, na * num_class, 1)
        self.conv_box = nn.Conv2d(input_channels, na * self.box_coder.code_size, 1)
        self.conv_dir_cls = (nn.Conv2d(input_channels, na * num_dir_bins, 1)
                             if use_direction_classifier else None)
        # the JAX package's init: focal prior on the cls bias, small box
        # weights and a zero box bias (the kernels of cls and dir take its
        # default law in `common.jax_default_init_`)
        nn.init.constant_(self.conv_cls.bias, -float(np.log((1 - 0.01) / 0.01)))
        nn.init.normal_(self.conv_box.weight, std=0.001)
        nn.init.zeros_(self.conv_box.bias)
        self.conv_cls.prior_bias = self.conv_box.own_init = True
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
