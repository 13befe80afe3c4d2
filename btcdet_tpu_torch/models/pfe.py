"""Point-feature abstraction (counterpart of `btcdet_tpu/models/pfe.py`;
reference `pfe/voxel_set_abstraction.py`, the PV-RCNN VoxelSetAbstraction;
no config names it).

FPS keypoints from the raw cloud, then multi-scale grouping: the raw
points, each sparse level named in `features_source` (voxel centres as
support points, the level's whole table with a per-frame mask), and the
bilinear BEV features, concatenated per keypoint in that order, then one
bias-free linear layer and ReLU.

Names follow the reference: `SA_rawpoints.mlps.{i}.{3j}.weight`,
`SA_layers.{l}.mlps...` (one per sparse level, in `features_source`
order), `vsa_point_feature_fusion.0.weight` (the reference adds a BN
after it, the JAX package does not).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops import group_ops
from ..utils import common

DEFAULT_SOURCES = ("bev", "x_conv3", "x_conv4", "raw_points")
DEFAULT_RADII = ((0.4, 0.8), (1.2, 2.4), (2.4, 4.8))
DEFAULT_NSAMPLES = ((16, 16), (16, 32), (16, 32))
DEFAULT_MLPS = (((16, 16), (16, 16)), ((64, 64), (64, 64)), ((64, 64), (64, 64)))


class VoxelSetAbstraction(nn.Module):
    """level_channels: {level name: its feature width} for the sparse
    levels in `features_source` (`x_conv1`..`x_conv4`; another name is
    read at stride 8); raw_channels: the raw points' feature width (0:
    xyz only); bev_channels: the BEV map's width (when `bev` is a
    source). Each SA takes the radii, nsamples and MLPs at index
    min(si, len - 1), si counting the raw SA first, then the levels."""

    def __init__(self, level_channels: dict, raw_channels: int = 0, bev_channels: int = 0,
                 num_keypoints: int = 2048, features_source=DEFAULT_SOURCES,
                 sa_radii=DEFAULT_RADII, sa_nsamples=DEFAULT_NSAMPLES, sa_mlps=DEFAULT_MLPS,
                 bev_stride: int = 8, point_cloud_range=(0, -40, -3, 70.4, 40, 1),
                 voxel_size=(0.05, 0.05, 0.1), num_out_features: int = 128):
        super().__init__()
        self.num_keypoints = int(num_keypoints)
        self.features_source = tuple(features_source)
        self.bev_stride = int(bev_stride)
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        self.voxel_size = tuple(float(v) for v in voxel_size)

        def pick(seq, si):
            return seq[min(si, len(seq) - 1)]

        def sa(si, cin):
            return group_ops.PointSAModuleMSG(
                pick(sa_radii, si), pick(sa_nsamples, si),
                [[cin + 3, *m] for m in pick(sa_mlps, si)])

        si, c_out = 0, 0
        if "raw_points" in self.features_source:
            self.SA_rawpoints = sa(si, raw_channels)
            c_out += sum(m[-1] for m in pick(sa_mlps, si))
            si += 1
        self.levels = [n for n in self.features_source if n not in ("bev", "raw_points")]
        layers = []
        for name in self.levels:
            layers.append(sa(si, int(level_channels[name])))
            c_out += sum(m[-1] for m in pick(sa_mlps, si))
            si += 1
        self.SA_layers = nn.ModuleList(layers)
        self.use_bev = "bev" in self.features_source
        c_out += int(bev_channels) if self.use_bev else 0
        self.vsa_point_feature_fusion = nn.Sequential(
            nn.Linear(c_out, int(num_out_features), bias=False), nn.ReLU())

    def forward(self, points_xyz, points_mask, points_feat=None, multi_scale=None,
                bev_features=None):
        """points_xyz (B, N, 3), points_mask (B, N), points_feat (B, N, C)
        or None; multi_scale {level name: SparseTensor} (a backbone's
        output); bev_features (B, H, W, C) channels-last. Returns
        (keypoints (B, K, 3), features (B, K, num_out_features), 0 on
        masked keypoints, keypoint mask (B, K))."""
        B = points_xyz.shape[0]
        kp_idx = group_ops.furthest_point_sample(points_xyz, points_mask, self.num_keypoints)
        keypoints = group_ops.gather_points(points_xyz, kp_idx)
        kp_mask = torch.gather(points_mask.bool(), 1, kp_idx)
        feats = []
        if hasattr(self, "SA_rawpoints"):
            feats.append(self.SA_rawpoints(points_xyz, points_mask.bool(), keypoints, kp_mask,
                                           features=points_feat))
        for name, sa in zip(self.levels, self.SA_layers):
            st = multi_scale[name]
            level = int(name[-1]) if name.startswith("x_conv") else 4
            centers = common.get_voxel_centers(st.coords[:, 1:4], 2 ** (level - 1),
                                               self.voxel_size, self.point_cloud_range)
            frames = torch.arange(B, device=st.coords.device)[:, None]
            sup_mask = (st.coords[None, :, 0] == frames) & st.valid[None, :]
            feats.append(sa(centers[None].expand(B, -1, -1), sup_mask, keypoints, kp_mask,
                            features=st.features[None].expand(B, -1, -1)))
        if self.use_bev and bev_features is not None:
            lo = torch.tensor(self.point_cloud_range[:2], dtype=torch.float32,
                              device=keypoints.device)
            vs = torch.tensor(self.voxel_size[:2], dtype=torch.float32,
                              device=keypoints.device) * self.bev_stride
            xi = (keypoints[..., 0] - lo[0]) / vs[0] - 0.5
            yi = (keypoints[..., 1] - lo[1]) / vs[1] - 0.5
            feats.append(torch.stack([common.bilinear_interpolate(bev_features[b], xi[b], yi[b])
                                      for b in range(B)]))
        out = self.vsa_point_feature_fusion(torch.cat([f.float() for f in feats], dim=-1))
        return keypoints, torch.where(kp_mask[..., None], out, torch.zeros_like(out)), kp_mask
