"""Ball query, grouping and the multi-scale PointNet SA module
(counterpart of the exact path of `btcdet_tpu/ops/group_ops.py`).

Dense padded layout `[B, N, ...]` with validity masks. The query is the
reference CUDA ball query's "first nsample points within the radius, in
point order", computed exactly per scale (top-k over a descending-index
score). The JAX package's approximate shared-candidate query is not
ported (it picks other neighbours once a ball holds more than k points).
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
    queries, shared by the scales. Returns per scale (idx (B, M, k_s)
    int64, empty (B, M) bool); slots past a ball's count repeat its first
    index, empty balls give index 0."""
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
        dist2 = (qc * qc).sum(-1)[..., None] + xyz_sq[:, None, :] - 2.0 * cross
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
    ball query, max pooling over each ball."""

    def __init__(self, radii, nsamples, mlps, use_xyz: bool = True, dtype=None):
        super().__init__()
        self.radii, self.nsamples, self.use_xyz = list(radii), list(nsamples), use_xyz
        self.mlps = nn.ModuleList([GroupMLP(m, dtype=dtype) for m in mlps])

    def forward(self, xyz, xyz_mask, new_xyz, new_mask, features=None,
                rotate_matrix=None, xy_scale=None, z_scale=None):
        queries = multi_ball_query(xyz, xyz_mask, new_xyz, new_mask, self.radii, self.nsamples)
        outs = []
        for (idx, empty), mlp in zip(queries, self.mlps):
            grouped = group_from_idx(xyz, new_xyz, idx, empty, features=features,
                                     use_xyz=self.use_xyz, rotate_matrix=rotate_matrix,
                                     xy_scale=xy_scale, z_scale=z_scale)
            outs.append(mlp(grouped, new_mask).max(dim=2).values)
        out = torch.cat(outs, -1)
        return torch.where(new_mask[..., None], out, torch.zeros_like(out))
