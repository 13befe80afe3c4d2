"""Ball query, grouping, the multi-scale PointNet SA module and the
pointnet2 surface (`gather_points`, `grouping_operation`, `three_nn`,
`three_interpolate`, `furthest_point_sample`) (counterpart of the exact
path of `btcdet_tpu/ops/group_ops.py`).

Dense padded layout `[B, N, ...]` with validity masks. The query is the
reference CUDA ball query's "first nsample points within the radius, in
point order", computed exactly per scale (top-k over a descending-index
score). The JAX package's approximate shared-candidate query is not
ported (it picks other neighbours once a ball holds more than k points).
Ties go to the lowest index everywhere, as `lax.top_k` and `argmax` give
them in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .sparse import MaskedBatchNorm


def _radii2(radii):
    out = []
    for r in radii:
        if isinstance(r, (list, tuple)):
            out.append((float(r[0]) ** 2, float(r[1]) ** 2))
        else:
            out.append((0.0, float(r) ** 2))
    return out


def multi_ball_query(xyz, xyz_mask, new_xyz, new_mask, radii, nsamples, chunk: int = 512):
    """Exact per-scale multi-radius ball (or shell) query.

    xyz (B, N, 3), xyz_mask (B, N), new_xyz (B, M, 3), new_mask (B, M).
    Distances come from one |q|^2 + |x|^2 - 2 q.x matrix per chunk of
    queries, shared by the scales, clamped at 0: a point at the query's
    own place is at 0 and inside every ball that starts at 0, however the
    difference rounds (a VSA keypoint is such a point). Returns per scale
    (idx (B, M, k_s) int64, empty (B, M) bool); slots past a ball's count
    repeat its first index, empty balls give index 0."""
    r2 = _radii2(radii)
    k_max = max(int(k) for k in nsamples)
    B, M, _ = new_xyz.shape
    N = xyz.shape[1]
    xyz_sq = (xyz * xyz).sum(-1)                                   # (B, N)
    order_score = torch.arange(N, 0, -1, dtype=torch.float32, device=xyz.device)
    idx_out, empty_out = [], []
    for q0 in range(0, M, chunk):
        qc = new_xyz[:, q0:q0 + chunk]
        qmc = new_mask[:, q0:q0 + chunk]
        cross = torch.einsum("bqc,bnc->bqn", qc, xyz)
        dist2 = ((qc * qc).sum(-1)[..., None] + xyz_sq[:, None, :] - 2.0 * cross).clamp(min=0.0)
        scores = torch.stack([
            torch.where((dist2 <= hi) & (dist2 >= lo) & xyz_mask[:, None, :],
                        order_score, torch.full_like(dist2, -1.0))
            for lo, hi in r2
        ])                                                          # (S, B, q, N)
        top_s, top_i = torch.topk(scores, k_max, dim=-1)
        found = top_s > 0
        first = top_i[..., 0:1]
        idx = torch.where(found, top_i, first)
        empty = (~found[..., 0]) | ~qmc[None]
        idx = torch.where(empty[..., None], torch.zeros_like(idx), idx)
        idx_out.append(idx)
        empty_out.append(empty)
    idx = torch.cat(idx_out, dim=2)
    empty = torch.cat(empty_out, dim=2)
    return [(idx[s, ..., : int(nsamples[s])], empty[s]) for s in range(len(r2))]


def ball_query(xyz, xyz_mask, new_xyz, new_mask, radius, nsample: int, chunk: int = 512):
    """Single-radius ball query from explicit coordinate differences:
    (idx (B, M, nsample) int64, empty (B, M) bool), filled as
    `multi_ball_query` fills them."""
    (r_in2, r_out2), = _radii2([radius])
    N = xyz.shape[1]
    order_score = torch.arange(N, 0, -1, dtype=torch.float32, device=xyz.device)
    idx_out, empty_out = [], []
    for q0 in range(0, new_xyz.shape[1], chunk):
        qc = new_xyz[:, q0:q0 + chunk]
        qmc = new_mask[:, q0:q0 + chunk]
        d = qc[:, :, None, :] - xyz[:, None, :, :]
        dist2 = (d * d).sum(-1)
        in_range = (dist2 <= r_out2) & (dist2 >= r_in2) & xyz_mask[:, None, :]
        score = torch.where(in_range, order_score, torch.full_like(dist2, -1.0))
        top_s, top_i = torch.topk(score, nsample, dim=-1)
        found = top_s > 0
        empty = (found.sum(-1) == 0) | ~qmc
        idx = torch.where(found, top_i, top_i[..., 0:1])
        idx_out.append(torch.where(empty[..., None], torch.zeros_like(idx), idx))
        empty_out.append(empty)
    return torch.cat(idx_out, dim=1), torch.cat(empty_out, dim=1)


# fixed-point steps of `OrderedGather`'s backward: the largest gradient
# element maps to 2^40, so a sum of up to 2^22 of them stays in int64
_GRAD_STEPS = 2.0 ** 40


class OrderedGather(torch.autograd.Function):
    """`torch.gather(table, 1, idx)` of whole rows (table (B, N, C), idx
    (B, R, C) with equal columns) whose backward adds the gradient of
    each gathered row into its table row in int64 fixed point (steps of
    2^-40 of the largest gradient element), exactly and so in any order:
    a ball query hands one occ point to many balls, and the float
    `scatter_add_` of gather's own backward adds them in atomic order on
    the card, which differs from run to run (OCC_PNT_UPDATE.PASS_GRAD,
    where the occ points carry a gradient)."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[1]
        return torch.gather(table, 1, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        B, _, C = g.shape
        scale = _GRAD_STEPS / g.abs().amax().double().clamp(min=1e-30)
        fixed = torch.round(g.double() * scale).long()
        acc = torch.zeros((B * ctx.rows, C), dtype=torch.long, device=g.device)
        rows = (idx[..., 0] + torch.arange(B, device=g.device)[:, None] * ctx.rows).reshape(-1)
        acc.index_add_(0, rows, fixed.reshape(-1, C))
        return (acc.double() / scale).to(g.dtype).reshape(B, ctx.rows, C), None


def _gather(table, idx):
    """table (B, N, C), idx (B, M, k) -> (B, M, k, C); a table that needs a
    gradient gathers through `OrderedGather`."""
    B, M, k = idx.shape
    flat = idx.reshape(B, M * k, 1).expand(B, M * k, table.shape[-1])
    if table.requires_grad and torch.is_grad_enabled():
        out = OrderedGather.apply(table, flat)
    else:
        out = torch.gather(table, 1, flat)
    return out.reshape(B, M, k, table.shape[-1])


def _offsets(grouped_xyz, new_xyz, empty, rotate_matrix, xy_scale, z_scale):
    offs = grouped_xyz - new_xyz[:, :, None, :]
    offs = torch.where(empty[..., None, None], torch.zeros_like(offs), offs)
    if rotate_matrix is not None:
        # reference QueryAndGroup.rotate: p' = p @ R^T per query
        offs = torch.einsum("bmnj,bmij->bmni", offs, rotate_matrix)
    if xy_scale is not None:
        offs = torch.cat([offs[..., :2] / xy_scale[:, :, None, None], offs[..., 2:]], -1)
    if z_scale is not None:
        offs = torch.cat([offs[..., :2], offs[..., 2:3] / z_scale[:, :, None, None]], -1)
    return offs


def group_from_idx(xyz, new_xyz, idx, empty, features=None, use_xyz: bool = True,
                   rotate_matrix=None, xy_scale=None, z_scale=None):
    """Gather neighbours, then offset / rotate / scale them and concat the
    features: (B, M, k, 3 + C)."""
    packed = torch.cat([xyz, features], -1) if features is not None else xyz
    g = _gather(packed, idx)
    offs = _offsets(g[..., :3], new_xyz, empty, rotate_matrix, xy_scale, z_scale)
    if features is None:
        assert use_xyz
        return offs
    feats = torch.where(empty[..., None, None], torch.zeros_like(g[..., 3:]), g[..., 3:])
    return torch.cat([offs, feats], -1) if use_xyz else feats


def query_and_group(xyz, xyz_mask, new_xyz, new_mask, radius, nsample: int, features=None,
                    use_xyz: bool = True, rotate_matrix=None, xy_scale=None, z_scale=None,
                    chunk: int = 512):
    """Reference `QueryAndGroup.forward`: (grouped (B, M, k, 3 + C), empty)."""
    idx, empty = ball_query(xyz, xyz_mask, new_xyz, new_mask, radius, nsample, chunk=chunk)
    return group_from_idx(xyz, new_xyz, idx, empty, features=features, use_xyz=use_xyz,
                          rotate_matrix=rotate_matrix, xy_scale=xy_scale,
                          z_scale=z_scale), empty


class GroupMLP(nn.Module):
    """Shared 1x1 conv + BN + ReLU stack over grouped points, with the
    reference layout `mlps.{i}` = [Conv2d, BN2d, ReLU] * n (indices 3j and
    3j + 1 hold weights). BN runs on valid queries only."""

    def __init__(self, channels, dtype=None):
        super().__init__()
        self.compute_dtype = dtype
        for j, (ci, co) in enumerate(zip(channels[:-1], channels[1:])):
            self.add_module(str(3 * j), nn.Conv2d(ci, co, 1, bias=False))
            self.add_module(str(3 * j + 1), MaskedBatchNorm(co, eps=1e-5, momentum=0.1))
            self.add_module(str(3 * j + 2), nn.ReLU())
        self.n_layers = len(channels) - 1

    def forward(self, x, mask):
        """x (B, M, k, C); mask (B, M)."""
        B, M, S, _ = x.shape
        m = mask[:, :, None].expand(B, M, S).reshape(-1)
        h = x.reshape(B * M * S, -1)
        dt = self.compute_dtype or h.dtype
        for j in range(self.n_layers):
            conv = getattr(self, str(3 * j))
            h = torch.nn.functional.linear(h.to(dt), conv.weight[:, :, 0, 0].to(dt))
            h = torch.relu(getattr(self, str(3 * j + 1))(h, m))
        return h.reshape(B, M, S, -1)


class PointSAModuleMSG(nn.Module):
    """Multi-scale grouping SA module (reference `StackSAModuleMSG`), exact
    ball query, each ball pooled by `pool_method`: "max_pool" (the
    default) or "avg_pool" (the mean over the nsample slots, repeated
    slots included)."""

    def __init__(self, radii, nsamples, mlps, use_xyz: bool = True, dtype=None,
                 pool_method: str = "max_pool"):
        super().__init__()
        if pool_method not in ("max_pool", "avg_pool"):
            raise NotImplementedError(f"pool_method {pool_method!r}")
        self.radii, self.nsamples, self.use_xyz = list(radii), list(nsamples), use_xyz
        self.pool_method = pool_method
        self.mlps = nn.ModuleList([GroupMLP(m, dtype=dtype) for m in mlps])

    def forward(self, xyz, xyz_mask, new_xyz, new_mask, features=None,
                rotate_matrix=None, xy_scale=None, z_scale=None):
        queries = multi_ball_query(xyz, xyz_mask, new_xyz, new_mask, self.radii, self.nsamples)
        outs = []
        for (idx, empty), mlp in zip(queries, self.mlps):
            grouped = group_from_idx(xyz, new_xyz, idx, empty, features=features,
                                     use_xyz=self.use_xyz, rotate_matrix=rotate_matrix,
                                     xy_scale=xy_scale, z_scale=z_scale)
            h = mlp(grouped, new_mask)
            outs.append(h.max(dim=2).values if self.pool_method == "max_pool" else h.mean(dim=2))
        out = torch.cat(outs, -1)
        return torch.where(new_mask[..., None], out, torch.zeros_like(out))


def _sq_dist3(d):
    """sum(d ** 2) over the last axis of 3, added in order (x, y, z)."""
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


def gather_points(features, idx):
    """Row gather (reference `pointnet2_batch` gather_points, channels
    last): features (B, N, C), idx (B, M) -> (B, M, C)."""
    return torch.gather(features, 1, idx.long()[..., None].expand(-1, -1, features.shape[-1]))


def grouping_operation(features, idx):
    """Grouped gather (reference `pointnet2_batch` grouping_operation):
    features (B, N, C), idx (B, M, S) -> (B, M, S, C)."""
    B, M, S = idx.shape
    return gather_points(features, idx.reshape(B, M * S)).reshape(B, M, S, -1)


def three_nn(unknown, unknown_mask, known, known_mask):
    """The 3 nearest known points of each unknown one (reference
    `pointnet2_batch` three_nn): unknown (B, N, 3), known (B, M, 3) ->
    (dist (B, N, 3), idx (B, N, 3) int64), nearest first, ties to the
    lower index (a stable sort); masked known points are at inf.
    `unknown_mask` is unused, as in the JAX package."""
    dist2 = _sq_dist3(unknown[:, :, None, :] - known[:, None, :, :])
    dist2 = torch.where(known_mask[:, None, :], dist2, torch.full_like(dist2, float("inf")))
    vals, idx = torch.sort(dist2, dim=-1, stable=True)
    return torch.sqrt(vals[..., :3].clamp(min=0.0)), idx[..., :3]


def three_interpolate(features, idx, weight):
    """features (B, M, C); idx, weight (B, N, 3) -> (B, N, C): the three
    gathered rows weighted and added in order."""
    g = grouping_operation(features, idx)                           # (B, N, 3, C)
    w = weight[..., None]
    return g[:, :, 0] * w[:, :, 0] + g[:, :, 1] * w[:, :, 1] + g[:, :, 2] * w[:, :, 2]


def furthest_point_sample(xyz, mask, npoint: int):
    """Furthest point sampling (reference `pointnet2_batch`
    furthest_point_sampling): xyz (B, N, 3), mask (B, N) -> (B, npoint)
    int64. Starts at each frame's first valid point; every step takes the
    point furthest (squared distance, summed x, y, z) from those taken,
    the first of equals; masked points sit at -1 and are never taken
    while a valid one is left."""
    B = xyz.shape[0]
    m = mask.bool()
    dist = torch.where(m, torch.full_like(xyz[..., 0], 1e10), torch.full_like(xyz[..., 0], -1.0))
    out = torch.zeros((B, npoint), dtype=torch.int64, device=xyz.device)
    last = torch.argmax(m.to(torch.uint8), dim=1)
    out[:, 0] = last
    rows = torch.arange(B, device=xyz.device)
    neg = torch.full_like(dist, -1.0)
    for i in range(1, npoint):
        d = _sq_dist3(xyz - xyz[rows, last][:, None, :])
        dist = torch.minimum(dist, torch.where(m, d, neg))
        last = torch.argmax(dist, dim=1)
        out[:, i] = last
    return out
