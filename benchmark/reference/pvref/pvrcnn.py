"""PV-RCNN's eval path (OpenPCDet `detectors/pv_rcnn.py`; Shi et al., CVPR
2020) in plain float32 PyTorch, under the port's state-dict names:

    vfe (MeanVFE) -> backbone_3d -> map_to_bev_module -> pfe (VSA)
        -> backbone_2d -> dense_head -> point_head -> proposal layer
        -> roi_head (RoI-grid pool, FCs, decode)

The stages are run one by one by `pvref.stages`, each from what the
program handed it; this module holds the modules.

- VSA (`VoxelSetAbstraction`): keypoints by the plain furthest point
  sampling loop (`btcref.ops.group_ops.furthest_point_sample`, looked up
  at each call); features in OpenPCDet's order, BEV | raw points |
  x_conv1-4: the BEV map sampled bilinearly at ((x - lo) / voxel) / 8, each
  source pooled by a multi-scale SA module (the exact first-in-order ball
  query of `btcref`, in blocks of 512 keypoints, each frame's keypoints
  against that frame's rows of a level, gathered into slots as wide as the
  largest frame), then Linear, BatchNorm1d, ReLU.
- `PointHeadSimple`: [Linear, BN, ReLU] x 2, a biased Linear; the scores
  are the sigmoid's largest over the classes.
- `PVRCNNHead`: each roi's 6^3 grid points (x-major), the keypoint
  features weighted by the point scores pooled at two radii (an empty ball
  pools the MLP of zeros), flattened C-major, the shared and the cls / reg
  FCs, the residuals decoded in the roi frame (`btcref` ConvHead's decode).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..btcref.models import backbones_2d, backbones_3d, map_to_bev, vfe
from ..btcref.models.dense_heads import anchor_head
from ..btcref.models.detectors.btcnet import _level_caps
from ..btcref.models.roi_heads import conv_head
from ..btcref.ops import group_ops
from ..btcref.ops.voxelizer import compute_grid_size
from ..btcref.utils.box_coder import ResidualCoder

LEVELS = ("x_conv1", "x_conv2", "x_conv3", "x_conv4")


def voxel_centers(zyx, stride: int, voxel_size, pcr):
    """(..., 3) int (z, y, x) -> (..., 3) float32 centres."""
    dev = zyx.device
    vs = (torch.tensor(voxel_size, dtype=torch.float32, device=dev)
          * torch.tensor(stride, dtype=torch.float32, device=dev))
    return (zyx.flip(-1).float() + 0.5) * vs + torch.tensor(pcr[:3], dtype=torch.float32,
                                                            device=dev)


def bilinear(im, x, y):
    """im (B, H, W, C); x, y (B, N) float pixels -> (B, N, C): the four
    corners clamped into the map, weighed by the unclamped ones."""
    B, H, W, C = im.shape
    flat = im.reshape(B * H * W, C)
    base = (torch.arange(B, device=im.device) * (H * W))[:, None]
    x0, y0 = torch.floor(x).long(), torch.floor(y).long()
    x1, y1 = x0 + 1, y0 + 1

    def at(yy, xx):
        return flat[base + yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)]

    return (at(y0, x0) * ((x1 - x) * (y1 - y))[..., None]
            + at(y1, x0) * ((x1 - x) * (y - y0))[..., None]
            + at(y0, x1) * ((x - x0) * (y1 - y))[..., None]
            + at(y1, x1) * ((x - x0) * (y - y0))[..., None])


def frame_rows(st, B: int, width: int):
    """A level's rows (kept sorted by frame) in per-frame slots: (centres
    source rows (B, P), mask (B, P)), P the most rows of a frame (at least
    `width`)."""
    nz, ny, nx = st.spatial_shape
    bounds = torch.arange(B + 1, device=st.keys.device, dtype=torch.int64) * (nz * ny * nx)
    ends = torch.searchsorted(st.keys.long(), bounds)
    first, rows = ends[:-1], ends[1:] - ends[:-1]
    P = max(int(rows.max()), width)
    s = torch.arange(P, device=st.keys.device)
    mask = s[None, :] < rows[:, None]
    return torch.where(mask, first[:, None] + s[None, :], torch.zeros_like(s)[None, :]), mask


class VoxelSetAbstraction(nn.Module):
    def __init__(self, pfe_cfg, level_channels: dict, raw_channels: int, bev_channels: int,
                 point_cloud_range, voxel_size, bev_stride: int = 8):
        super().__init__()
        sources = tuple(pfe_cfg["FEATURES_SOURCE"])
        sa = pfe_cfg["SA_LAYER"]
        self.num_keypoints = int(pfe_cfg["NUM_KEYPOINTS"])
        self.pcr = tuple(float(v) for v in point_cloud_range)
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.bev_stride = int(bev_stride)
        self.use_bev = "bev" in sources

        def module(name, cin):
            c = sa[name]
            return group_ops.PointSAModuleMSG(tuple(c["POOL_RADIUS"]), tuple(c["NSAMPLE"]),
                                              [[cin + 3, *m] for m in c["MLPS"]])

        def width(name):
            return sum(m[-1] for m in sa[name]["MLPS"])

        c_out = bev_channels if self.use_bev else 0
        if "raw_points" in sources:
            self.SA_rawpoints = module("raw_points", raw_channels)
            c_out += width("raw_points")
        self.levels = [n for n in sources if n not in ("bev", "raw_points")]
        self.SA_layers = nn.ModuleList([module(n, level_channels[n]) for n in self.levels])
        c_out += sum(width(n) for n in self.levels)
        num_out = int(pfe_cfg["NUM_OUTPUT_FEATURES"])
        self.vsa_point_feature_fusion = nn.Sequential(
            nn.Linear(c_out, num_out, bias=False), nn.BatchNorm1d(num_out), nn.ReLU())

    def sample(self, points_xyz, points_mask):
        """The keypoints' indices (B, K) by furthest point sampling."""
        return group_ops.furthest_point_sample(points_xyz, points_mask, self.num_keypoints)

    def features(self, points_xyz, points_mask, points_feat, levels: dict, bev, keypoints,
                 kp_mask):
        """(before the fusion (B, K, C0), after it (B, K, C1), 0 on masked
        keypoints) at `keypoints` (B, K, 3); levels {name: SparseTensor},
        bev (B, H, W, C)."""
        B = keypoints.shape[0]
        feats = []
        if self.use_bev:
            xi = (keypoints[..., 0] - self.pcr[0]) / self.voxel_size[0] / self.bev_stride
            yi = (keypoints[..., 1] - self.pcr[1]) / self.voxel_size[1] / self.bev_stride
            feats.append(bilinear(bev.float(), xi, yi))
        if hasattr(self, "SA_rawpoints"):
            feats.append(self.SA_rawpoints(points_xyz, points_mask.bool(), keypoints, kp_mask,
                                           features=points_feat))
        for name, sa in zip(self.levels, self.SA_layers):
            st = levels[name]
            src, mask = frame_rows(st, B, max(int(k) for k in sa.nsamples))
            centers = voxel_centers(st.coords[:, 1:4], 2 ** (int(name[-1]) - 1),
                                    self.voxel_size, self.pcr)
            feats.append(sa(centers[src], mask, keypoints, kp_mask,
                            features=st.features.float()[src]))
        before = torch.cat([f.float() for f in feats], -1)
        lin, bn, _ = self.vsa_point_feature_fusion
        after = torch.relu(bn(F.linear(before, lin.weight).reshape(-1, lin.weight.shape[0])))
        after = after.reshape(*before.shape[:-1], -1)
        return before, torch.where(kp_mask[..., None], after, torch.zeros_like(after))


class PointHeadSimple(nn.Module):
    def __init__(self, num_class: int, input_channels: int, cls_fc):
        super().__init__()
        layers, c = [], int(input_channels)
        for w in cls_fc:
            layers += [nn.Linear(c, int(w), bias=False), nn.BatchNorm1d(int(w)), nn.ReLU()]
            c = int(w)
        layers.append(nn.Linear(c, num_class, bias=True))
        self.cls_layers = nn.Sequential(*layers)

    def forward(self, x):
        """x (..., C) -> (logits (..., num_class), scores (...))."""
        shp = x.shape
        logits = self.cls_layers(x.reshape(-1, shp[-1]).float()).reshape(*shp[:-1], -1)
        return logits, torch.sigmoid(logits).max(-1).values


class PVRCNNHead(nn.Module):
    def __init__(self, roi_cfg, input_channels: int):
        super().__init__()
        gp = roi_cfg["ROI_GRID_POOL"]
        self.grid_size = int(gp["GRID_SIZE"])
        self.box_coder = ResidualCoder()
        mlps = [tuple(m) for m in gp["MLPS"]]
        self.roi_grid_pool_layer = group_ops.PointSAModuleMSG(
            tuple(gp["POOL_RADIUS"]), tuple(gp["NSAMPLE"]),
            [[int(input_channels) + 3, *m] for m in mlps],
            pool_method=gp.get("POOL_METHOD", "max_pool"))
        dp = float(roi_cfg.get("DP_RATIO", 0.0))
        self.shared_fc_layer = nn.Module()
        n = len(roi_cfg["SHARED_FC"])
        c = conv_head._fc_trunk(self.shared_fc_layer, roi_cfg["SHARED_FC"],
                                sum(m[-1] for m in mlps) * self.grid_size ** 3, dp,
                                lambda i: i != n - 1)
        self.cls_layers = nn.Module()
        conv_head._fc_trunk(self.cls_layers, roi_cfg["CLS_FC"], c, dp, lambda i: i == 0, 1)
        self.reg_layers = nn.Module()
        conv_head._fc_trunk(self.reg_layers, roi_cfg["REG_FC"], c, dp, lambda i: i == 0,
                            self.box_coder.code_size)

    def roi_grid_pool(self, rois, roi_valid, keypoints, kp_mask, point_features, point_scores):
        B, N = rois.shape[:2]
        g = self.grid_size
        G = g ** 3
        pts = conv_head.global_roi_grid_points(rois, (g, g, g))
        pts = pts.reshape(B, N, g, g, g, 3).permute(0, 1, 4, 3, 2, 5).reshape(B, N * G, 3)
        mask = roi_valid[:, :, None].expand(B, N, G).reshape(B, N * G)
        feats = point_features.float() * point_scores[..., None].float()
        return self.roi_grid_pool_layer(keypoints, kp_mask, pts, mask, features=feats)

    def forward(self, pooled, roi_valid):
        B, N = roi_valid.shape
        G = self.grid_size ** 3
        C = pooled.shape[-1]
        flat = pooled.reshape(B * N, G, C).permute(0, 2, 1).reshape(B * N, C * G)
        m = roi_valid.reshape(B * N)
        h = conv_head._run_trunk(self.shared_fc_layer, flat, m, torch.float32)
        return (conv_head._run_trunk(self.cls_layers, h, m, torch.float32),
                conv_head._run_trunk(self.reg_layers, h, m, torch.float32))

    _to_global = conv_head.ConvHead._to_global
    generate_predicted_boxes = conv_head.ConvHead.generate_predicted_boxes


class PVRCNN(nn.Module):
    def __init__(self, model_cfg, class_names, det_grid_size, point_cloud_range, voxel_size,
                 num_point_features: int = 4):
        super().__init__()
        mc = model_cfg
        self.det_grid_size = tuple(int(v) for v in det_grid_size)
        self.vfe = vfe.MeanVFE()
        bb = mc["BACKBONE_3D"]
        ch = tuple(bb.get("CHANNELS", (16, 32, 64, 64, 128)))
        self.backbone_3d = backbones_3d.VoxelBackBone8xOcc(
            input_channels=num_point_features, channels=ch,
            out_feat_type=tuple(bb.get("OUT_FEAT_TYPE", ["None"] * 5)),
            level_caps={m: _level_caps(bb, m) for m in ("train", "test")})
        self.map_to_bev_module = map_to_bev.HeightCompression()
        nz = self.det_grid_size[2] + 1
        for k, s, p in ((3, 2, 1), (3, 2, 1), (3, 2, 0), (3, 2, 0)):
            nz = (nz + 2 * p - k) // s + 1
        bev_channels = ch[4] * nz
        pc = mc["PFE"]
        self.pfe = VoxelSetAbstraction(
            pc, {n: ch[i] for i, n in enumerate(LEVELS)}, num_point_features - 3, bev_channels,
            point_cloud_range, voxel_size)
        b2 = mc["BACKBONE_2D"]
        self.backbone_2d = backbones_2d.BaseBEVBackbone(
            bev_channels, b2["LAYER_NUMS"], b2["LAYER_STRIDES"], b2["NUM_FILTERS"],
            b2["UPSAMPLE_STRIDES"], b2["NUM_UPSAMPLE_FILTERS"])
        dh = mc["DENSE_HEAD"]
        anchors, _, per_loc = anchor_head.generate_anchors(
            point_cloud_range, self.det_grid_size, dh["ANCHOR_GENERATOR_CONFIG"])
        self.dense_head = anchor_head.AnchorHeadSingle(
            sum(b2["NUM_UPSAMPLE_FILTERS"]), len(class_names), anchors, per_loc,
            use_direction_classifier=dh.get("USE_DIRECTION_CLASSIFIER", True),
            dir_offset=dh.get("DIR_OFFSET", 0.78539),
            dir_limit_offset=dh.get("DIR_LIMIT_OFFSET", 0.0),
            num_dir_bins=dh.get("NUM_DIR_BINS", 2))
        ph = mc["POINT_HEAD"]
        before = bool(ph.get("USE_POINT_FEATURES_BEFORE_FUSION", False))
        self.point_head = PointHeadSimple(
            1 if ph.get("CLASS_AGNOSTIC", False) else len(class_names),
            self.pfe.vsa_point_feature_fusion[0].in_features if before
            else int(pc["NUM_OUTPUT_FEATURES"]), ph["CLS_FC"])
        self.roi_head = PVRCNNHead(mc["ROI_HEAD"], int(pc["NUM_OUTPUT_FEATURES"]))


def build_network(model_cfg, data_cfg, class_names, device) -> PVRCNN:
    pcr = tuple(data_cfg["POINT_CLOUD_RANGE"])
    vox = [p for p in data_cfg["DATA_PROCESSOR"]
           if p["NAME"] in ("det_transform_points_to_voxels", "transform_points_to_voxels")]
    vs = tuple(vox[0]["VOXEL_SIZE"])
    net = PVRCNN(model_cfg, class_names, compute_grid_size(pcr, vs), pcr, vs,
                 len(data_cfg["POINT_FEATURE_ENCODING"]["used_feature_list"]))
    return net.to(device).eval()
