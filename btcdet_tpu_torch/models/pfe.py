"""Point-feature abstraction (counterpart of `btcdet_tpu/models/pfe.py`;
reference `pfe/voxel_set_abstraction.py`, the PV-RCNN VoxelSetAbstraction,
which PV-RCNN's `PFE` builds).

FPS keypoints from the raw cloud, then multi-scale grouping: the raw
points, each sparse level named in `features_source` (voxel centres as
support points) and the bilinear BEV features, concatenated per keypoint,
then one bias-free linear layer and ReLU.

Each level is grouped frame by frame: its rows, which the sparse table
keeps sorted by frame, are gathered into per-frame slots (B, P, ...), P
the most rows a frame (one read-back for all levels, `sync.vsa.level_rows`),
so a frame's keypoints query its own rows only. This picks what a query of
the whole table with a per-frame mask picks, at 1 / B of the work.

Two layouts, both under the reference's names (`SA_rawpoints.mlps.{i}.{3j}.weight`,
`SA_layers.{l}.mlps...` (one per sparse level, in `features_source`
order), `vsa_point_feature_fusion.0.weight`):
- the JAX package's (the default): raw | levels | BEV, no BN after the
  fusion linear, the BEV sampled half a cell down (`xi = (x - lo) / cell - 0.5`);
- OpenPCDet's (`openpcdet=True`, PV-RCNN): BEV | raw | levels (its
  `point_features_list` order), a BatchNorm1d after the fusion linear
  (`vsa_point_feature_fusion.1`), the BEV sampled at `((x - lo) / voxel) /
  stride` as `interpolate_from_bev_features` does. Its bilinear weights
  come from the unclamped corners (`common.bilinear_interpolate`), which
  differs from OpenPCDet's clamped-corner weights only within a cell of the
  map's far edges.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import group_ops
from ..utils import common, trace

DEFAULT_SOURCES = ("bev", "x_conv3", "x_conv4", "raw_points")
DEFAULT_RADII = ((0.4, 0.8), (1.2, 2.4), (2.4, 4.8))
DEFAULT_NSAMPLES = ((16, 16), (16, 32), (16, 32))
DEFAULT_MLPS = (((16, 16), (16, 16)), ((64, 64), (64, 64)), ((64, 64), (64, 64)))


def level_stride(name: str) -> int:
    """The voxel stride of sparse level `name` (`x_conv<l>`: 2^(l-1);
    another name: 8)."""
    return 2 ** (int(name[-1]) - 1) if name.startswith("x_conv") else 8


def frame_slots(st, B: int):
    """Where each frame's rows of sparse tensor `st` lie in its table, kept
    sorted by (frame, key): (first row (B,), rows (B,)), no read-back."""
    nz, ny, nx = st.spatial_shape
    bounds = torch.arange(B + 1, device=st.keys.device, dtype=torch.int64) * (nz * ny * nx)
    ends = torch.searchsorted(st.keys.long(), bounds)
    return ends[:-1], ends[1:] - ends[:-1]


def per_frame(table, first, rows, P: int):
    """Rows of `table` (N, ...) in per-frame slots (B, P, ...): slot s of
    frame b holds row first[b] + s where s < rows[b] (else row 0), and the
    slots' mask (B, P)."""
    s = torch.arange(P, device=table.device)
    mask = s[None, :] < rows[:, None]
    src = torch.where(mask, first[:, None] + s[None, :], torch.zeros_like(mask, dtype=torch.long))
    return table[src], mask


class VoxelSetAbstraction(nn.Module):
    """level_channels: {level name: its feature width} for the sparse
    levels in `features_source` (`x_conv1`..`x_conv4`; another name is
    read at stride 8); raw_channels: the raw points' feature width (0:
    xyz only); bev_channels: the BEV map's width (when `bev` is a
    source). Each SA takes the radii, nsamples and MLPs at index
    min(si, len - 1), si counting the raw SA first, then the levels.
    `openpcdet` picks OpenPCDet's layout (module docstring); `dtype` is the
    compute dtype of the SA MLPs and the fusion linear (None: the input's).
    The valid keypoints a frame are the tally `vsa.keypoints_valid`."""

    def __init__(self, level_channels: dict, raw_channels: int = 0, bev_channels: int = 0,
                 num_keypoints: int = 2048, features_source=DEFAULT_SOURCES,
                 sa_radii=DEFAULT_RADII, sa_nsamples=DEFAULT_NSAMPLES, sa_mlps=DEFAULT_MLPS,
                 bev_stride: int = 8, point_cloud_range=(0, -40, -3, 70.4, 40, 1),
                 voxel_size=(0.05, 0.05, 0.1), num_out_features: int = 128,
                 openpcdet: bool = False, dtype=None):
        super().__init__()
        self.num_keypoints = int(num_keypoints)
        self.features_source = tuple(features_source)
        self.bev_stride = int(bev_stride)
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.openpcdet = bool(openpcdet)
        self.compute_dtype = dtype

        def pick(seq, si):
            return seq[min(si, len(seq) - 1)]

        def sa(si, cin):
            return group_ops.PointSAModuleMSG(
                pick(sa_radii, si), pick(sa_nsamples, si),
                [[cin + 3, *m] for m in pick(sa_mlps, si)], dtype=dtype)

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
        self.num_features_before_fusion = c_out
        fusion = [nn.Linear(c_out, int(num_out_features), bias=False)]
        if self.openpcdet:
            fusion.append(nn.BatchNorm1d(int(num_out_features)))
        self.vsa_point_feature_fusion = nn.Sequential(*fusion, nn.ReLU())

    def forward(self, points_xyz, points_mask, points_feat=None, multi_scale=None,
                bev_features=None):
        """points_xyz (B, N, 3), points_mask (B, N), points_feat (B, N, C)
        or None; multi_scale {level name: SparseTensor} (a backbone's
        output); bev_features (B, H, W, C) channels-last. Returns
        (keypoints (B, K, 3), features (B, K, num_out_features), 0 on
        masked keypoints, keypoint mask (B, K)): `fuse` of `sample`."""
        keypoints, before, kp_mask = self.sample(points_xyz, points_mask, points_feat,
                                                 multi_scale, bev_features)
        return keypoints, self.fuse(before, kp_mask), kp_mask

    def sample(self, points_xyz, points_mask, points_feat=None, multi_scale=None,
               bev_features=None):
        """`forward` up to the fusion: (keypoints (B, K, 3), the
        concatenated features before the fusion (B, K,
        num_features_before_fusion) float32, keypoint mask (B, K))."""
        B = points_xyz.shape[0]
        kp_idx = group_ops.furthest_point_sample(points_xyz, points_mask, self.num_keypoints)
        keypoints = group_ops.gather_points(points_xyz, kp_idx)
        kp_mask = torch.gather(points_mask.bool(), 1, kp_idx)
        trace.tally("vsa.keypoints_valid", lambda: kp_mask.sum(1))
        raw = []
        if hasattr(self, "SA_rawpoints"):
            raw.append(self.SA_rawpoints(points_xyz, points_mask.bool(), keypoints, kp_mask,
                                         features=points_feat))
        levels = [sa(xyz, mask, keypoints, kp_mask, features=feats)
                  for sa, (xyz, feats, mask) in zip(self.SA_layers,
                                                    self._level_tables(multi_scale, B))]
        bev = []
        if self.use_bev and bev_features is not None:
            bev.append(self._bev(bev_features, keypoints))
        feats = bev + raw + levels if self.openpcdet else raw + levels + bev
        return keypoints, torch.cat([f.float() for f in feats], dim=-1), kp_mask

    def fuse(self, before, kp_mask):
        """The fusion linear (in the compute dtype), [BN,] ReLU, in float32,
        0 on masked keypoints."""
        layers = list(self.vsa_point_feature_fusion)
        dt = self.compute_dtype or before.dtype
        h = F.linear(before.to(dt), layers[0].weight.to(dt)).float()
        if self.openpcdet:
            shp = h.shape
            h = layers[1](h.reshape(-1, shp[-1])).reshape(shp)
        h = torch.relu(h)
        return torch.where(kp_mask[..., None], h, torch.zeros_like(h))

    def _level_tables(self, multi_scale, B: int) -> list:
        """Each level's (centres, features, mask) in per-frame slots (B, P, ...)."""
        if not self.levels:
            return []
        sts = [multi_scale[name] for name in self.levels]
        slots = [frame_slots(st, B) for st in sts]
        with trace.readback("vsa.level_rows"):
            most = torch.stack([rows.max() for _, rows in slots]).tolist()
        out = []
        for name, sa, st, (first, rows), m in zip(self.levels, self.SA_layers, sts, slots, most):
            # a ball query takes its nsample from at least that many slots
            P = max(int(m), max(int(k) for k in sa.nsamples))
            centers = common.get_voxel_centers(st.coords[:, 1:4], level_stride(name),
                                               self.voxel_size, self.point_cloud_range)
            xyz, mask = per_frame(centers, first, rows, P)
            feats, _ = per_frame(st.features, first, rows, P)
            out.append((xyz, feats, mask))
        return out

    def _bev(self, bev_features, keypoints):
        """The BEV map sampled bilinearly at the keypoints, every frame in one call."""
        lo = self.point_cloud_range[:2]
        if self.openpcdet:
            xi = (keypoints[..., 0] - lo[0]) / self.voxel_size[0] / self.bev_stride
            yi = (keypoints[..., 1] - lo[1]) / self.voxel_size[1] / self.bev_stride
        else:
            vs = torch.tensor(self.voxel_size[:2], dtype=torch.float32,
                              device=keypoints.device) * self.bev_stride
            xi = (keypoints[..., 0] - lo[0]) / vs[0] - 0.5
            yi = (keypoints[..., 1] - lo[1]) / vs[1] - 0.5
        return common.bilinear_interpolate_batched(bev_features, xi, yi)
