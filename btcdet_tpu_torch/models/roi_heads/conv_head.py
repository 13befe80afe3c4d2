"""ConvHead (counterpart of `btcdet_tpu/models/roi_heads/conv_head.py`,
reference `btcdet/models/roi_heads/conv_head.py`).

Per roi, a grid of points inside the rotated box pools up to three
feature sources (the flagship's `FEATURES_SOURCE`):
  raw_points  multi-radius ball query + PointNet SA over the raw cloud,
              grouped offsets rotated into the roi frame: the JAX
              package's roi-grouped approximate query (`approx_query`,
              ROI_HEAD.APPROX_QUERY unset or True: each roi's 512 points
              nearest its centre are the candidates of its grid points'
              balls) or the reference's exact one;
  occ_points  the same SA over the occ subnet's points, feature = prob;
  x_combine   a local mini-grid around each roi grid point samples the
              dense stride-8 `x_combine` volume with the trilinear
              sampler (kernel K4 on CUDA) and a small dense conv stack
              with sparse-site semantics reduces it to one vector.
With OUT_FEAT_TYPE `None` the backbone makes no x_combine and the head
pools the other sources only. The sources are concatenated raw | occ |
x_combine per grid point, and
the pooled grid is flattened C-major (the reference layout its first FC
weights expect) and run through the shared / cls / reg FC trunks. In
train mode the trunks' BNs use batch statistics, dropout at DP_RATIO
draws its masks through `draw_dropout_keep`, and `get_loss` gives the
BCE cls, smooth-L1 reg and (CORNER_LOSS_REGULARIZATION, on unless set
False) corner losses (reference `roi_head_template.py:134-198`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import cuda_interp, group_ops
from ...ops.sparse import MaskedBatchNorm, SparseTensor
from ...parallel import all_reduce_sum, global_rows
from ...utils import common, loss_utils
from ...utils.box_coder import ResidualCoder

# the occ points' pooled feature: the occupancy probability
OCC_FEAT_DIM = 1


def get_dense_grid_points(rois, grid_size, dim_times: float = 1.0):
    """(..., 7) rois -> (..., prod(grid), 3) local grid points in the
    unrotated roi frame (reference `get_dense_grid_points:408`)."""
    gz, gy, gx = grid_size
    idx = np.stack(np.meshgrid(np.arange(gz), np.arange(gy), np.arange(gx), indexing="ij"),
                   axis=-1).reshape(-1, 3).astype(np.float32)
    idx_xyz = torch.from_numpy(idx[:, ::-1].copy()).to(rois.device)
    denom = torch.tensor([gx, gy, gz], dtype=torch.float32, device=rois.device)
    dims = rois[..., 3:6] * dim_times
    return (idx_xyz + 0.5) * dims[..., None, :] / denom - dims[..., None, :] / 2


def global_roi_grid_points(rois, grid_size, dim_times: float = 1.0):
    """(..., N, 7) -> (..., N, G, 3) grid points in the global frame."""
    local = get_dense_grid_points(rois, grid_size, dim_times)
    shp = local.shape
    rotated = common.rotate_points_along_z(local.reshape(-1, shp[-2], 3),
                                           rois[..., 6].reshape(-1)).reshape(shp)
    return rotated + rois[..., None, 0:3]


class SpconvLayoutConv3d(nn.Module):
    """Dense 3D conv holding its weight in the reference spconv layout
    (kz, ky, kx, Cin, Cout); no bias."""

    def __init__(self, cin, cout, kernel_size, stride, padding):
        super().__init__()
        self.stride, self.padding = tuple(stride), tuple(padding)
        self.weight = nn.Parameter(torch.empty(*kernel_size, cin, cout))
        nn.init.normal_(self.weight, std=0.01)

    def forward(self, x, dtype):
        w = self.weight.permute(4, 3, 0, 1, 2).to(dtype)
        return F.conv3d(x.to(dtype), w, stride=self.stride, padding=self.padding)


def _fc_trunk(module: nn.Module, fcs, cin, dp_ratio, dropout_after, out_dim=None):
    """Fill `module` with the reference Sequential layout: per layer
    [Conv1d, BN1d, ReLU] (+ Dropout where `dropout_after(i)`), then an
    optional final biased Conv1d. Returns the module's output width."""
    n = 0
    for i, c in enumerate(fcs):
        module.add_module(str(n), nn.Conv1d(cin, c, 1, bias=False))
        module.add_module(str(n + 1), MaskedBatchNorm(c, eps=1e-5, momentum=0.1))
        module.add_module(str(n + 2), nn.ReLU())
        n += 3
        if dp_ratio > 0 and dropout_after(i):
            module.add_module(str(n), nn.Dropout(dp_ratio))
            n += 1
        cin = c
    if out_dim is not None:
        final = nn.Conv1d(cin, out_dim, 1, bias=True)
        # the JAX package's init of the output projections
        nn.init.normal_(final.weight, std=0.001)
        nn.init.zeros_(final.bias)
        module.add_module(str(n), final)
        cin = out_dim
    return cin


def draw_dropout_keep(generator: torch.Generator, shape, keep_prob: float) -> torch.Tensor:
    """Bernoulli(keep_prob) keep mask of a dropout layer."""
    return torch.rand(shape, generator=generator, device=generator.device) < keep_prob


def _run_trunk(module: nn.Module, x, mask, dtype, generator=None):
    """x (R, C) through a `_fc_trunk` module: hidden layers in `dtype`
    (BN in f32, masked by roi validity), the final projection in f32;
    dropout in train mode only, its masks drawn from `generator` for the
    rows of the global batch (this rank's rows kept in a data-parallel run)."""
    children = list(module.children())
    for i, m in enumerate(children):
        if isinstance(m, nn.Conv1d):
            if i == len(children) - 1 and m.bias is not None:
                x = F.linear(x.float(), m.weight[:, :, 0], m.bias)
            else:
                x = F.linear(x.to(dtype), m.weight[:, :, 0].to(dtype))
        elif isinstance(m, MaskedBatchNorm):
            x = m(x, mask)
        elif isinstance(m, nn.ReLU):
            x = torch.relu(x)
        elif isinstance(m, nn.Dropout) and m.training:
            if generator is None:
                raise ValueError("ConvHead dropout at train needs a torch.Generator")
            rows, lo = global_rows(x.shape[0])
            keep = draw_dropout_keep(generator, (rows,) + tuple(x.shape[1:]), 1.0 - m.p)
            keep = keep[lo:lo + x.shape[0]].to(x.device)
            x = torch.where(keep, x / (1.0 - m.p), torch.zeros((), dtype=x.dtype,
                                                               device=x.device))
    return x


class ConvHead(nn.Module):
    def __init__(self, num_class, input_channels_xc, grid_size=(3, 3, 3), dim_times=1.0,
                 point_rot=True, features_source=("x_combine", "raw_points"),
                 raw_mlps=((16, 16),) * 4, raw_radii=(0.4, 0.8, 1.2, 2.4),
                 raw_nsamples=(16, 16, 32, 64), raw_feat_dim=1,
                 occ_mlps=((16, 16),) * 3, occ_radii=(0.8, 1.2, 2.4), occ_nsamples=(16, 16, 32),
                 xc_part_scene=(-0.8, -0.8, -2.4, 0.8, 0.8, 2.4), xc_ker_size=(0.8, 0.4, 0.4),
                 xc_kernels=((3, 3, 3), (3, 3, 3), (2, 2, 3)),
                 xc_paddings=((1, 1, 1), (1, 1, 1), (0, 0, 0)),
                 xc_strides=((1, 1, 2), (1, 2, 2), (2, 2, 3)),
                 xc_channels=(128, 128, 128, 128), xc_downsample=(8, 8, 8), xc_scene_times=1.0,
                 shared_fc=(256, 128), cls_fc=(128, 64), reg_fc=(128, 64), dp_ratio=0.3,
                 point_cloud_range=(0, -40, -3, 70.4, 40, 1),
                 det_voxel_size=(0.05, 0.05, 0.1), compute_dtype=None, rcnn_cls_weight=1.0,
                 rcnn_reg_weight=1.0, rcnn_corner_weight=1.0, code_weights=(1.0,) * 7,
                 corner_loss: bool = True, approx_query: bool = True):
        """input_channels_xc: the x_combine volume's channels, None where the
        backbone makes no x_combine (the branch is then left out)."""
        super().__init__()
        self.corner_loss = corner_loss
        self.loss_weights = (float(rcnn_cls_weight), float(rcnn_reg_weight),
                             float(rcnn_corner_weight))
        self.code_weights = tuple(float(v) for v in code_weights)
        unknown = set(features_source) - {"x_combine", "raw_points", "occ_points"}
        if unknown:
            raise NotImplementedError(f"ConvHead feature sources {sorted(unknown)}")
        self.features_source = tuple(features_source)
        self.grid_size, self.dim_times, self.point_rot = tuple(grid_size), dim_times, point_rot
        self.compute_dtype = compute_dtype
        self.box_coder = ResidualCoder()
        self.point_cloud_range = tuple(point_cloud_range)
        self.det_voxel_size = tuple(det_voxel_size)
        self.xc_downsample, self.xc_scene_times = tuple(xc_downsample), xc_scene_times
        ps = np.asarray(xc_part_scene, np.float32)
        ker = np.asarray(xc_ker_size, np.float32)
        self.xc_local_grid = tuple(np.around((ps[3:] - ps[:3]) / ker).astype(int).tolist())
        self.grid_num = int(np.prod(self.grid_size))

        c_pool = 0
        if "raw_points" in self.features_source:
            self.SA_rawpoints = group_ops.PointSAModuleMSG(
                radii=raw_radii, nsamples=raw_nsamples,
                mlps=[[raw_feat_dim + 3, *m] for m in raw_mlps], dtype=compute_dtype,
                approx_query=approx_query)
            c_pool += sum(m[-1] for m in raw_mlps)
        if "occ_points" in self.features_source:
            self.SA_occpoints = group_ops.PointSAModuleMSG(
                radii=occ_radii, nsamples=occ_nsamples,
                mlps=[[OCC_FEAT_DIM + 3, *m] for m in occ_mlps], dtype=compute_dtype,
                approx_query=approx_query)
            c_pool += sum(m[-1] for m in occ_mlps)
        self.use_x_combine = "x_combine" in self.features_source and input_channels_xc is not None
        if self.use_x_combine:
            self.xc_params = list(zip(xc_kernels, xc_strides, xc_paddings))
            layers = nn.ModuleList()
            cin = input_channels_xc
            for i, (k, s, p) in enumerate(self.xc_params):
                blk = nn.Module()
                blk.add_module("0", SpconvLayoutConv3d(cin, xc_channels[i + 1], k, s, p))
                blk.add_module("1", MaskedBatchNorm(xc_channels[i + 1]))
                layers.append(blk)
                cin = xc_channels[i + 1]
            self.conv_layers = nn.ModuleList([layers])
            c_pool += cin

        self.shared_fc_layer = nn.Module()
        n_shared = len(shared_fc)
        c = _fc_trunk(self.shared_fc_layer, shared_fc, c_pool * self.grid_num, dp_ratio,
                      lambda i: i != n_shared - 1)
        self.cls_layers = nn.Module()
        _fc_trunk(self.cls_layers, cls_fc, c, dp_ratio, lambda i: i == 0, num_class)
        self.reg_layers = nn.Module()
        _fc_trunk(self.reg_layers, reg_fc, c, dp_ratio, lambda i: i == 0,
                  self.box_coder.code_size * num_class)

    def forward(self, rois, roi_valid, points_xyz, points_feat, points_mask,
                x_combine: SparseTensor | None, occ_xyz=None, occ_feat=None, occ_mask=None,
                generator=None):
        """occ_*: the occ subnet's points (B, Q, 3), probs (B, Q, 1) and mask
        (B, Q), pooled when `occ_points` is a feature source; `generator`
        draws the dropout masks in train mode. Returns (rcnn_cls (B*N,
        num_class), rcnn_reg (B*N, 7))."""
        B, N, _ = rois.shape
        G = self.grid_num
        cd = self.compute_dtype
        grid_pts = global_roi_grid_points(rois, self.grid_size, self.dim_times)  # (B, N, G, 3)
        new_xyz = grid_pts.reshape(B, N * G, 3)
        new_mask = roi_valid[:, :, None].expand(B, N, G).reshape(B, N * G)
        rot = None
        if self.point_rot:
            # reference rotateMatrix = R(-yaw) in the standard convention,
            # which is rotation_matrix_z(+yaw) in our transposed one
            rot = common.rotation_matrix_z(rois[..., 6])
            rot = rot[:, :, None].expand(B, N, G, 3, 3).reshape(B, N * G, 3, 3)
        feats = []
        # the roi-grouped query's candidates gather around the roi centres
        group = dict(group_centers=rois[..., :3], group_size=G)
        if "raw_points" in self.features_source:
            feats.append(self.SA_rawpoints(points_xyz, points_mask, new_xyz, new_mask,
                                           features=points_feat, rotate_matrix=rot, **group))
        if "occ_points" in self.features_source:
            feats.append(self.SA_occpoints(occ_xyz, occ_mask, new_xyz, new_mask,
                                           features=occ_feat, rotate_matrix=rot, **group))
        if self.use_x_combine:
            feats.append(self._x_combine_pool(rois, roi_valid, grid_pts, x_combine))
        pooled = torch.cat([f.to(cd) for f in feats], dim=-1)             # (B, N*G, C)
        C = pooled.shape[-1]
        # reference flatten: C-major (channel c of grid point g at c*G + g)
        flat = pooled.reshape(B * N, G, C).permute(0, 2, 1).reshape(B * N, C * G)
        mask = roi_valid.reshape(B * N)
        h = _run_trunk(self.shared_fc_layer, flat, mask, cd, generator)
        rcnn_cls = _run_trunk(self.cls_layers, h, mask, cd, generator)
        rcnn_reg = _run_trunk(self.reg_layers, h, mask, cd, generator)
        return rcnn_cls, rcnn_reg

    def _conv_stack(self, g, m):
        """Dense conv stack with sparse-site semantics: cells whose sampled
        feature is exactly 0 are inactive, each layer's active set is the
        dilation of its input's, BN runs over active cells and inactive
        cells stay 0. g (R', C, lz, ly, lx); m (R',) roi validity."""
        cd = self.compute_dtype
        act = ((g.abs() > 0).any(dim=1, keepdim=True) & m[:, None, None, None, None]).float()
        for blk, (k, s, p) in zip(self.conv_layers[0], self.xc_params):
            g = getattr(blk, "0")(g, cd)
            ones = torch.ones((1, 1, *k), dtype=torch.float32, device=g.device)
            act = F.conv3d(act, ones, stride=tuple(s), padding=tuple(p)) > 0.5
            Rr, Co, dz, dy, dx = g.shape
            rows = g.permute(0, 2, 3, 4, 1).reshape(-1, Co)
            mrows = act.permute(0, 2, 3, 4, 1).reshape(-1)
            y = torch.relu(getattr(blk, "1")(rows, mrows))
            y = y.reshape(Rr, dz, dy, dx, Co).permute(0, 4, 1, 2, 3)
            g = torch.where(act, y, torch.zeros_like(y))
            act = act.float()
        return g

    def _x_combine_pool(self, rois, roi_valid, grid_pts, x_combine: SparseTensor):
        B, N, G, _ = grid_pts.shape
        lz, ly, lx = self.xc_local_grid
        L = lz * ly * lx
        R, S = B * N, G * L
        local_rois = torch.cat([
            grid_pts.reshape(B, N * G, 3),
            (rois[:, :, None, 3:6] * self.xc_scene_times).expand(B, N, G, 3).reshape(B, N * G, 3),
            rois[:, :, None, 6:7].expand(B, N, G, 1).reshape(B, N * G, 1),
        ], dim=-1)
        sample_pts = global_roi_grid_points(local_rois, (lz, ly, lx), 1.0)   # (B, N*G, L, 3)
        dev = rois.device
        lo = torch.tensor(self.point_cloud_range[:3], dtype=torch.float32, device=dev)
        vs = (torch.tensor(self.det_voxel_size, dtype=torch.float32, device=dev)
              * torch.tensor(self.xc_downsample, dtype=torch.float32, device=dev))
        tgt = (sample_pts.reshape(R, S, 3) - lo) / vs - 0.5
        zyx = torch.stack([tgt[..., 2], tgt[..., 1], tgt[..., 0]], dim=-1).contiguous()
        roi_b = torch.arange(B, device=dev).repeat_interleave(N)
        val = roi_valid.reshape(R)[:, None].expand(R, S)
        # (B, D, H, W, C) in the compute dtype: a permuted view of the
        # scatter-native (B, H, D, W, C) table, which the sampler reads in place
        volume = x_combine.replace(features=x_combine.features.to(self.compute_dtype)).dense()
        sampled = cuda_interp.TrilinearPoolFunction.apply(volume, zyx, roi_b, val)  # (R, S, C)
        C = sampled.shape[-1]
        g = sampled.reshape(R * G, lz, ly, lx, C).permute(0, 4, 1, 2, 3)
        m = roi_valid.reshape(R)[:, None].expand(R, G).reshape(-1)
        g = self._conv_stack(g, m)
        return g.permute(0, 2, 3, 4, 1).reshape(B, N * G, -1)

    def _to_global(self, rois, reg):
        """Decode (N, 7) residuals in the roi frame back to global boxes."""
        zeros = torch.zeros_like(rois[..., :1])
        local_anchor = torch.cat([zeros, zeros, zeros, rois[..., 3:6], zeros], dim=-1)
        flat = self.box_coder.decode(reg, local_anchor)
        ry = rois[:, 6]
        xyz = common.rotate_points_along_z(flat[:, None, 0:3], ry)[:, 0]
        return torch.cat([xyz + rois[:, 0:3], flat[:, 3:6], (flat[:, 6] + ry)[:, None]], dim=-1)

    def get_loss(self, rcnn_cls, rcnn_reg, targets):
        """rcnn_cls (B*R, 1), rcnn_reg (B*R, 7); targets of
        `roi_head_utils.assign_targets`. Returns (total, {rcnn_loss_cls,
        rcnn_loss_reg, [rcnn_loss_corner,] rcnn_loss}); the valid and the
        foreground counts are summed over the ranks of a data-parallel run."""
        w_cls, w_reg, w_corner = self.loss_weights
        valid = targets["roi_valid"].reshape(-1).float()
        reg_mask = targets["reg_valid_mask"].reshape(-1).float()
        valid_norm, fg_norm = all_reduce_sum(torch.stack([valid.sum(), reg_mask.sum()])
                                             ).clamp(min=1.0)
        bce = loss_utils.binary_cross_entropy_with_logits(
            rcnn_cls.reshape(-1), targets["rcnn_cls_labels"].reshape(-1))
        cls_loss = (bce * valid).sum() / valid_norm * w_cls
        rois = targets["rois"].reshape(-1, 7)
        zeros = torch.zeros_like(rois[:, :1])
        local_anchor = torch.cat([zeros, zeros, zeros, rois[:, 3:6], zeros], dim=-1)
        reg_targets = self.box_coder.encode(targets["gt_of_rois"].reshape(-1, 7), local_anchor)
        reg_el = loss_utils.weighted_smooth_l1_loss(rcnn_reg[None], reg_targets[None],
                                                    code_weights=self.code_weights)[0]
        reg_loss = (reg_el.sum(-1) * reg_mask).sum() / fg_norm * w_reg
        losses = {"rcnn_loss_cls": cls_loss, "rcnn_loss_reg": reg_loss}
        total = cls_loss + reg_loss
        if self.corner_loss:
            corner = loss_utils.get_corner_loss_lidar(
                self._to_global(rois, rcnn_reg), targets["gt_of_rois_src"].reshape(-1, 7))
            losses["rcnn_loss_corner"] = (corner * reg_mask).sum() / fg_norm * w_corner
            total = total + losses["rcnn_loss_corner"]
        losses["rcnn_loss"] = total
        return total, losses

    def generate_predicted_boxes(self, rois, rcnn_cls, rcnn_reg):
        """Decode rcnn_reg in the roi frame back to global boxes
        (reference `conv_head.generate_predicted_boxes:427`)."""
        B, N, _ = rois.shape
        boxes = self._to_global(rois.reshape(-1, 7), rcnn_reg.reshape(B * N, -1))
        return rcnn_cls.reshape(B, N, -1), boxes.reshape(B, N, 7)
