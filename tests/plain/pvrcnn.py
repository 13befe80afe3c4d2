"""A plain float32 PyTorch PV-RCNN from the published equations (Shi et
al., CVPR 2020; OpenPCDet's `VoxelSetAbstraction`, `PointHeadSimple`,
`PVRCNNHead` and `RoIHeadTemplate.generate_predicted_boxes`), written one
frame and one ball at a time, for the port's tests. It imports neither
JAX nor the port: weights come in as a state dict under the port's
PVRCNN names, levels as plain (coords, features) tables.

Where it departs from OpenPCDet's CUDA code, it follows the port's choice,
noted at each function:
- FPS starts at a frame's first valid point (OpenPCDet: index 0 of the
  frame's own points, skipping points within 1e-3 of the origin), and a
  frame with fewer valid points than keypoints repeats its first point
  (OpenPCDet tiles the picks it has);
- a ball holds the points with |q|^2 + |x|^2 - 2 q.x, clamped at 0, at or
  under r^2 (OpenPCDet: the explicit difference, strictly under r^2);
- the BEV bilinear weights come from the unclamped corners (OpenPCDet's
  `bilinear_interpolate_torch` weighs by the clamped ones, which differs
  within a cell of the map's far edges);
- the roi grid points are (i + 0.5) * size / g - size / 2 (OpenPCDet:
  (i + 0.5) / g * size - size / 2, one rounding apart).
"""

from __future__ import annotations

import math

import torch

BN_EPS = 1e-5


# -------------------------------------------------------------------- FPS

def fps(xyz, mask, npoint: int):
    """Furthest point sampling: xyz (B, N, 3), mask (B, N) -> (B, npoint)
    int64. Each frame starts at its first valid point (0 without one);
    each step takes the valid point of the largest squared distance
    (dx * dx + dy * dy) + dz * dz to the points taken, the lowest index
    among equals; a masked point only when no valid one is left."""
    B, N, _ = xyz.shape
    out = torch.zeros((B, npoint), dtype=torch.int64)
    for b in range(B):
        p, m = xyz[b].float(), mask[b].bool()
        valid = torch.nonzero(m).flatten()
        last = int(valid[0]) if len(valid) else 0
        dist = torch.where(m, torch.full((N,), 1e10), torch.full((N,), -1.0))
        out[b, 0] = last
        for i in range(1, npoint):
            d = p - p[last]
            d2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
            dist = torch.where(m, torch.minimum(dist, d2), dist)
            best = dist.max()
            last = int(torch.nonzero(dist == best).flatten()[0])
            out[b, i] = last
    return out


# ------------------------------------------------------------ ball and SA

def ball(support, support_mask, query, radius: float, nsample: int):
    """The first `nsample` valid support points in point order inside the
    ball of `query` (3,): (indices (nsample,), empty). Slots past the
    ball's count repeat its first point."""
    d2 = ((query * query).sum() + (support * support).sum(-1)
          - 2.0 * (support @ query)).clamp(min=0.0)
    inside = torch.nonzero((d2 <= radius * radius) & support_mask).flatten()[:nsample]
    if len(inside) == 0:
        return torch.zeros(nsample, dtype=torch.int64), True
    idx = torch.full((nsample,), int(inside[0]), dtype=torch.int64)
    idx[:len(inside)] = inside
    return idx, False


def mlp(x, sd, prefix: str, n_layers: int):
    """[1x1 conv (no bias), BN (eval), ReLU] x n of a GroupMLP / fc stack
    under `prefix` (weights at `{prefix}{3j}`, BNs at `{prefix}{3j+1}`)."""
    for j in range(n_layers):
        w = sd[f"{prefix}{3 * j}.weight"].float()
        x = x @ w.reshape(w.shape[0], -1).T
        x = bn(x, sd, f"{prefix}{3 * j + 1}")
        x = torch.relu(x)
    return x


def bn(x, sd, prefix: str, eps: float = BN_EPS):
    return ((x - sd[prefix + ".running_mean"]) / torch.sqrt(sd[prefix + ".running_var"] + eps)
            * sd[prefix + ".weight"] + sd[prefix + ".bias"])


def stack_sa(support, support_feat, support_mask, queries, query_mask, radii, nsamples, sd,
             prefix: str, n_layers: int):
    """OpenPCDet's StackSAModuleMSG, max pool, for one frame: per radius,
    each valid query's ball grouped as (offset, features), zeros for an
    empty ball, through its MLP (`{prefix}mlps.{k}.`), max over the ball.
    Masked queries give 0. Returns (M, sum of the MLPs' widths)."""
    outs = []
    for k, (r, ns) in enumerate(zip(radii, nsamples)):
        rows = []
        for q, qm in zip(queries, query_mask):
            idx, empty = ball(support, support_mask, q, float(r), int(ns))
            g = torch.cat([support[idx] - q, support_feat[idx]], -1)
            if empty:
                g = torch.zeros_like(g)
            h = mlp(g, sd, f"{prefix}mlps.{k}.", n_layers).max(0).values
            rows.append(h if qm else torch.zeros_like(h))
        outs.append(torch.stack(rows))
    return torch.cat(outs, -1)


# -------------------------------------------------------------------- VSA

def voxel_centers(zyx, stride: int, voxel_size, pcr):
    return ((zyx.flip(-1).float() + 0.5) * (torch.tensor(voxel_size) * stride)
            + torch.tensor(pcr[:3]))


def bilinear(im, x, y):
    """im (H, W, C) at float pixel (x, y) (N,): the four clamped corners,
    weighed by the unclamped ones."""
    H, W = im.shape[:2]
    x0, y0 = torch.floor(x).long(), torch.floor(y).long()
    x1, y1 = x0 + 1, y0 + 1
    c = [im[yy.clamp(0, H - 1), xx.clamp(0, W - 1)] for yy, xx in
         ((y0, x0), (y1, x0), (y0, x1), (y1, x1))]
    w = [(x1 - x) * (y1 - y), (x1 - x) * (y - y0), (x - x0) * (y1 - y), (x - x0) * (y - y0)]
    return sum(ci * wi[:, None] for ci, wi in zip(c, w))


def vsa(points, points_mask, levels: dict, bev, sd, pfe_cfg, pcr, voxel_size, bev_stride=8,
        keypoint_idx=None):
    """OpenPCDet's VoxelSetAbstraction at `pfe_cfg` (FEATURES_SOURCE,
    SA_LAYER, NUM_KEYPOINTS): points (B, N, 4), points_mask (B, N), levels
    {name: (coords (R, 4) b, z, y, x with b -1 on padding, features (R,
    C))}, bev (B, H, W, C). The keypoints are FPS picks (or `keypoint_idx`);
    each frame's keypoints query that frame's rows of each level. Returns
    (keypoints (B, K, 3), features before the fusion (B, K, C0) in
    OpenPCDet's order: BEV, raw points, levels; after it (B, K, C1):
    Linear, BN, ReLU)."""
    B = points.shape[0]
    K = int(pfe_cfg["NUM_KEYPOINTS"])
    idx = fps(points[..., :3], points_mask, K) if keypoint_idx is None else keypoint_idx
    kp = torch.stack([points[b, idx[b], :3] for b in range(B)])
    kmask = torch.stack([points_mask[b, idx[b]] for b in range(B)]).bool()
    src = list(pfe_cfg["FEATURES_SOURCE"])
    feats = []
    if "bev" in src:
        xi = (kp[..., 0] - pcr[0]) / voxel_size[0] / bev_stride
        yi = (kp[..., 1] - pcr[1]) / voxel_size[1] / bev_stride
        feats.append(torch.stack([bilinear(bev[b].float(), xi[b], yi[b]) for b in range(B)]))
    sa = pfe_cfg["SA_LAYER"]

    def n_layers(name):
        return len(sa[name]["MLPS"][0])

    if "raw_points" in src:
        c = sa["raw_points"]
        feats.append(torch.stack([
            stack_sa(points[b, :, :3], points[b, :, 3:], points_mask[b].bool(), kp[b], kmask[b],
                     c["POOL_RADIUS"], c["NSAMPLE"], sd, "pfe.SA_rawpoints.",
                     n_layers("raw_points")) for b in range(B)]))
    names = [n for n in src if n not in ("bev", "raw_points")]
    for li, name in enumerate(names):
        coords, f = levels[name]
        stride = 2 ** (int(name[-1]) - 1)
        centers = voxel_centers(coords[:, 1:4], stride, voxel_size, pcr)
        c = sa[name]
        rows = []
        for b in range(B):
            mine = coords[:, 0] == b
            rows.append(stack_sa(centers[mine], f[mine].float(),
                                 torch.ones(int(mine.sum()), dtype=torch.bool), kp[b], kmask[b],
                                 c["POOL_RADIUS"], c["NSAMPLE"], sd, f"pfe.SA_layers.{li}.",
                                 n_layers(name)))
        feats.append(torch.stack(rows))
    before = torch.cat(feats, -1)
    h = before @ sd["pfe.vsa_point_feature_fusion.0.weight"].T
    after = torch.relu(bn(h, sd, "pfe.vsa_point_feature_fusion.1"))
    return kp, before, torch.where(kmask[..., None], after, torch.zeros_like(after))


# ------------------------------------------------------------- point head

def point_head(features, sd, n_hidden: int):
    """PointHeadSimple: [Linear, BN, ReLU] x n, Linear with bias; returns
    (logits, the sigmoid's largest over the classes)."""
    x = features
    for j in range(n_hidden):
        x = torch.relu(bn(x @ sd[f"point_head.cls_layers.{3 * j}.weight"].T, sd,
                          f"point_head.cls_layers.{3 * j + 1}"))
    w, b = (sd[f"point_head.cls_layers.{3 * n_hidden}.{k}"] for k in ("weight", "bias"))
    logits = x @ w.T + b
    return logits, torch.sigmoid(logits).max(-1).values


# ---------------------------------------------------------------- roi head

def rotate_z(p, angle):
    """OpenPCDet's rotate_points_along_z of points p (..., 3) by one angle:
    x' = x cos - y sin, y' = x sin + y cos."""
    c, s = math.cos(float(angle)), math.sin(float(angle))
    x, y = p[..., 0], p[..., 1]
    return torch.stack([x * c - y * s, x * s + y * c, p[..., 2]], -1)


def roi_grid(roi, g: int):
    """The roi's g^3 grid points in the global frame, x-major (OpenPCDet's
    `get_dense_grid_points`: the nonzero() order of a (g, g, g) grid)."""
    i = torch.stack(torch.meshgrid(*[torch.arange(g)] * 3, indexing="ij"), -1).reshape(-1, 3)
    size = roi[3:6]
    local = (i.float() + 0.5) * size / g - size / 2
    return rotate_z(local, roi[6]) + roi[:3]


def fc_trunk(x, sd, prefix: str):
    """The Conv1d stack under `prefix` in its index order: a bias-free
    Conv1d is followed by its BN and ReLU (dropout is off at eval), a
    biased one is the output projection (OpenPCDet's shared FCs and
    `make_fc_layers`)."""
    convs = sorted(int(k[len(prefix):].split(".")[0]) for k, v in sd.items()
                   if k.startswith(prefix) and k.endswith(".weight") and v.dim() == 3)
    for i in convs:
        x = x @ sd[f"{prefix}{i}.weight"][:, :, 0].T
        if f"{prefix}{i}.bias" in sd:
            x = x + sd[f"{prefix}{i}.bias"]
        else:
            x = torch.relu(bn(x, sd, f"{prefix}{i + 1}"))
    return x


def pvrcnn_head(rois, roi_valid, keypoints, kp_mask, point_features, point_scores, sd,
                roi_cfg):
    """PVRCNNHead at `roi_cfg` (ROI_GRID_POOL):
    the keypoint features weighted by the point scores, pooled at each
    roi's grid points (one frame's keypoints for its rois), flattened
    C-major, through the shared FCs and the cls / reg FCs. Returns
    (rcnn_cls (B * N, 1), rcnn_reg (B * N, 7)); an invalid roi's grid
    pools zeros."""
    gp = roi_cfg["ROI_GRID_POOL"]
    g = int(gp["GRID_SIZE"])
    B, N = rois.shape[:2]
    feats = point_features * point_scores[..., None]
    n_mlp = len(gp["MLPS"][0])
    pooled = []
    for b in range(B):
        for n in range(N):
            grid = roi_grid(rois[b, n], g)
            qm = torch.full((grid.shape[0],), bool(roi_valid[b, n]))
            pooled.append(stack_sa(keypoints[b], feats[b], kp_mask[b], grid, qm,
                                   gp["POOL_RADIUS"], gp["NSAMPLE"], sd,
                                   "roi_head.roi_grid_pool_layer.", n_mlp))
    x = torch.stack(pooled).permute(0, 2, 1).reshape(B * N, -1)
    h = fc_trunk(x, sd, "roi_head.shared_fc_layer.")
    return fc_trunk(h, sd, "roi_head.cls_layers."), fc_trunk(h, sd, "roi_head.reg_layers.")


def decode(rois, reg):
    """RoIHeadTemplate.generate_predicted_boxes: the residuals decoded
    against the roi with its centre at 0 (ResidualCoder: centre by the
    diagonal / height, sizes by exp, heading added), rotated by the roi's
    heading and moved to its centre. rois (B, N, 7), reg (B * N, 7) ->
    (B, N, 7)."""
    B, N = rois.shape[:2]
    r = rois.reshape(-1, 7)
    t = reg.reshape(-1, 7)
    dxa, dya, dza = r[:, 3], r[:, 4], r[:, 5]
    diag = torch.sqrt(dxa ** 2 + dya ** 2)
    local = torch.stack([t[:, 0] * diag, t[:, 1] * diag, t[:, 2] * dza,
                         torch.exp(t[:, 3]) * dxa, torch.exp(t[:, 4]) * dya,
                         torch.exp(t[:, 5]) * dza, t[:, 6] + r[:, 6]], -1)
    xyz = torch.stack([rotate_z(local[i, :3], r[i, 6]) for i in range(len(r))]) + r[:, :3]
    return torch.cat([xyz, local[:, 3:]], -1).reshape(B, N, 7)
