"""Ball query, grouping, the multi-scale PointNet SA module and the
pointnet2 surface (`gather_points`, `grouping_operation`, `three_nn`,
`three_interpolate`, `furthest_point_sample`) (counterpart of
`btcdet_tpu/ops/group_ops.py`).

Dense padded layout `[B, N, ...]` with validity masks. The exact query is
the reference CUDA ball query's "first nsample points within the radius,
in point order", computed per scale (top-k over a descending-index
score). The approximate queries of the JAX package (`approx`):
  * `multi_ball_query(approx=True)`: one nearest-k_max candidate list per
    query over the widest ball, each scale then its first points in point
    order among those candidates (shells fall back to the exact query);
  * `multi_ball_query_grouped_cand` / `multi_ball_query_grouped`: the
    roi-grouped two-stage query of ConvHead, the `cand_k` points nearest
    each roi centre (stage 1), then each roi grid point's first points in
    point order within its ball among them (stage 2); the first returns
    positions in the roi's candidate table, which `group_from_candidates`
    reads, the second global point indices.
They pick other neighbours than the exact query once a ball holds more
points than the candidates can. The JAX package takes its candidates with
`lax.approx_max_k`, which is the exact top-k on the CPU (values, indices
and the order of ties) and a 0.95-recall approximation on a TPU; the port
takes the exact top-k. Ties go to the lowest index everywhere, as
`lax.top_k` and `argmax` give them in the JAX package: the top-k here
ranks unique int64 keys, never floats that may tie.
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


# the distance^2 of a masked point in the candidate searches (the JAX
# package's -BIG score)
BIG = 3.0e38
# the candidates a roi of the roi-grouped query (ConvHead's SA modules)
GROUP_CAND_K = 512


def _rank_keys(v):
    """Unique int64 keys of the float32 `v` that order as its values do
    along the last axis, ties by position: the value's bits mapped to an
    int32 of the same order, then the position in the low 32 bits."""
    bits = v.float().contiguous().view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    pos = torch.arange(v.shape[-1], dtype=torch.int64, device=v.device)
    return (ordered << 32) | pos


def nearest_k(d2, k: int):
    """Positions of the k smallest entries of `d2` along its last axis,
    smallest first and ties to the lower position: the order `lax.top_k`
    gives of -d2."""
    return torch.topk(_rank_keys(d2), k, dim=-1, largest=False, sorted=True).indices


def first_in_order(in_s, ids, n: int, k: int):
    """Per row, the positions of the k entries of `in_s` with the smallest
    `ids` (point indices below n, distinct within a row), then the other
    positions in order: `lax.top_k` of where(in_s, -ids, -BIG). Returns
    (positions (..., k), found (..., k))."""
    pos = torch.arange(in_s.shape[-1], dtype=torch.int64, device=in_s.device)
    key = torch.where(in_s, ids.to(torch.int64), n + pos)
    top, p = torch.topk(key, k, dim=-1, largest=False, sorted=True)
    return p, top < n


def _sq_dist(q, x):
    """(..., M, 3), (..., N, 3) -> (..., M, N) |q|^2 + |x|^2 - 2 q.x in f32."""
    cross = torch.einsum("...mc,...nc->...mn", q, x)
    return (q * q).sum(-1)[..., None] + (x * x).sum(-1)[..., None, :] - 2.0 * cross


def multi_ball_query(xyz, xyz_mask, new_xyz, new_mask, radii, nsamples, chunk: int = 512,
                     approx: bool = False):
    """Multi-radius ball (or shell) query.

    xyz (B, N, 3), xyz_mask (B, N), new_xyz (B, M, 3), new_mask (B, M).
    Distances come from one |q|^2 + |x|^2 - 2 q.x matrix per chunk of
    queries, shared by the scales, clamped at 0: a point at the query's
    own place is at 0 and inside every ball that starts at 0, however the
    difference rounds (a VSA keypoint is such a point). Each scale takes
    its first points in point order within its radius: among all points
    (the exact query), or with `approx` among the k_max points nearest the
    query within the widest radius, which drops a ball's points only where
    more than k_max points are nearer. Shells always take the exact query:
    their points can all lie behind nearer points inside the inner radius. Returns per scale
    (idx (B, M, k_s) int64, empty (B, M) bool); slots past a ball's count
    repeat its first index, empty balls give index 0."""
    r2 = _radii2(radii)
    k_max = max(int(k) for k in nsamples)
    shared = approx and all(lo == 0.0 for lo, _ in r2)
    r_out_max = max(hi for _, hi in r2)
    B, M, _ = new_xyz.shape
    N = xyz.shape[1]
    order_score = torch.arange(N, 0, -1, dtype=torch.float32, device=xyz.device)
    out = [([], []) for _ in r2]
    for q0 in range(0, M, chunk):
        qc = new_xyz[:, q0:q0 + chunk]
        qmc = new_mask[:, q0:q0 + chunk]
        dist2 = _sq_dist(qc, xyz).clamp(min=0.0)
        if shared:
            in_any = (dist2 <= r_out_max) & xyz_mask[:, None, :]
            dd = torch.where(in_any, dist2, torch.full_like(dist2, BIG))
            cand = nearest_k(dd, k_max)                             # (B, q, k_max)
            cand_d2 = torch.gather(dd, -1, cand)
            cand_ok = cand_d2 < BIG / 2
            for (lo, hi), ks, (idx_out, empty_out) in zip(r2, nsamples, out):
                in_s = cand_ok & (cand_d2 <= hi) & (cand_d2 >= lo)
                pos, found = first_in_order(in_s, cand, N, int(ks))
                sel = torch.gather(cand, -1, pos)
                sel = torch.where(found, sel, sel[..., 0:1])
                empty = ~found[..., 0] | ~qmc
                idx_out.append(torch.where(empty[..., None], torch.zeros_like(sel), sel))
                empty_out.append(empty)
            continue
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
        for s, ((idx_out, empty_out), ks) in enumerate(zip(out, nsamples)):
            idx_out.append(idx[s, ..., :int(ks)])
            empty_out.append(empty[s])
    return [(torch.cat(i, dim=1), torch.cat(e, dim=1)) for i, e in out]


def roi_candidates(xyz, xyz_mask, group_centers, cand_k: int = 512):
    """Stage 1 of the roi-grouped query: the min(cand_k, N) points nearest
    each roi centre by |c|^2 + |x|^2 - 2 c.x in f32, masked points after
    every valid one, nearest first, ties to the lower index. xyz (B, N, 3),
    xyz_mask (B, N), group_centers (B, R, 3). Returns (cand (B, R, ck)
    int64, cand_xyz (B*R, ck, 3), cand_ok (B*R, ck))."""
    B, N, _ = xyz.shape
    R = group_centers.shape[1]
    ck = min(int(cand_k), N)
    d2 = _sq_dist(group_centers, xyz)
    d2 = torch.where(xyz_mask[:, None, :], d2, torch.full_like(d2, BIG))
    cand = nearest_k(d2, ck)
    flat = cand.reshape(B, R * ck)
    cand_xyz = torch.gather(xyz, 1, flat[..., None].expand(B, R * ck, 3)).reshape(B * R, ck, 3)
    cand_ok = torch.gather(xyz_mask, 1, flat).reshape(B * R, ck)
    return cand, cand_xyz, cand_ok


def _grid_d2(new_xyz, cand_xyz, G: int):
    """Stage 2's distances^2 (B*R, G, ck) of each roi's grid points to its
    candidates, clamped at 0 as the exact query's are."""
    qp = new_xyz.reshape(-1, G, 3)
    return _sq_dist(qp, cand_xyz).clamp(min=0.0)


def multi_ball_query_grouped_cand(xyz, xyz_mask, new_xyz, new_mask, radii, nsamples,
                                  group_centers, group_size: int, cand_k: int = 512):
    """The roi-grouped two-stage query (ConvHead's approximate query).

    new_xyz (B, R*G, 3) / new_mask (B, R*G): R rois of G grid points each,
    roi-major; group_centers (B, R, 3). Stage 1 (`roi_candidates`) takes
    the ck = min(cand_k, N) points nearest each roi centre; stage 2 gives
    each grid point, per scale, its first ks candidates in point order
    within [lo^2, hi^2] (shells keep their annulus), over the whole
    candidate table. A ball point is dropped only where more than ck
    points lie nearer its roi's centre. Slots past a ball's count repeat
    its first; an empty ball (or a masked query) is flagged `empty`.
    Returns ([(cpos (B, R*G, ks) int64 positions in the roi's candidate
    table, empty (B, R*G))...], cand (B, R, ck) point indices, cand_xyz
    (B*R, ck, 3), cand_ok (B*R, ck))."""
    cand, cand_xyz, cand_ok = roi_candidates(xyz, xyz_mask, group_centers, cand_k)
    scales = select_in_candidates(cand, cand_xyz, cand_ok, new_xyz, new_mask, radii, nsamples,
                                  xyz.shape[1])
    return scales, cand, cand_xyz, cand_ok


def select_in_candidates(cand, cand_xyz, cand_ok, new_xyz, new_mask, radii, nsamples,
                         n_points: int):
    """Stage 2 of `multi_ball_query_grouped_cand` on given candidates
    (cand (B, R, ck) indices below `n_points`, cand_xyz (B*R, ck, 3),
    cand_ok (B*R, ck)): per scale (cpos (B, R*G, ks), empty (B, R*G))."""
    B, R, ck = cand.shape
    RG = new_xyz.shape[1]
    G = RG // R
    d2 = _grid_d2(new_xyz, cand_xyz, G)
    ok = cand_ok[:, None, :]
    ids = cand.reshape(B * R, 1, ck)
    qm = new_mask.reshape(B * R, G)
    out = []
    for (lo, hi), ks in zip(_radii2(radii), nsamples):
        in_s = ok & (d2 <= hi) & (d2 >= lo)
        p2, found = first_in_order(in_s, ids, n_points, int(ks))
        cpos = torch.where(found, p2, p2[..., 0:1])
        empty = ~found[..., 0] | ~qm
        out.append((cpos.reshape(B, RG, int(ks)), empty.reshape(B, RG)))
    return out


def multi_ball_query_grouped(xyz, xyz_mask, new_xyz, new_mask, radii, nsamples, group_centers,
                             group_size: int, cand_k: int = 512):
    """`multi_ball_query_grouped_cand`'s twin returning point indices: per
    scale (idx (B, R*G, ks) int64 into the point table, empty (B, R*G)),
    the contract of `multi_ball_query`. Where every scale is a ball and
    k_max < ck, stage 2 first keeps each grid point's k_max candidates
    nearest it within the widest radius (ties to the lower candidate
    position) and each scale picks among those; shells pick over the
    whole candidate table."""
    B, N, _ = xyz.shape
    RG = new_xyz.shape[1]
    G = int(group_size)
    R = RG // G
    assert R * G == RG, (RG, G)
    r2 = _radii2(radii)
    k_max = max(int(k) for k in nsamples)
    cand, cand_xyz, cand_ok = roi_candidates(xyz, xyz_mask, group_centers, cand_k)
    ck = cand.shape[-1]
    d2 = _grid_d2(new_xyz, cand_xyz, G)
    cand_rows = cand.reshape(B * R, 1, ck).expand(B * R, G, ck).reshape(B * R * G, ck)
    if all(lo == 0.0 for lo, _ in r2) and k_max < ck:
        r_out_max = max(hi for _, hi in r2)
        in_any = (d2 <= r_out_max) & cand_ok[:, None, :]
        dd = torch.where(in_any, d2, torch.full_like(d2, BIG)).reshape(B * R * G, ck)
        pos = nearest_k(dd, k_max)
        sel_d2 = torch.gather(dd, 1, pos)
        sel_ok = sel_d2 < BIG / 2
        sel_idx = torch.gather(cand_rows, 1, pos)
    else:
        sel_d2 = d2.reshape(B * R * G, ck)
        sel_ok = cand_ok[:, None, :].expand(B * R, G, ck).reshape(B * R * G, ck)
        sel_idx = cand_rows
    qm = new_mask.reshape(B * R * G)
    out = []
    for (lo, hi), ks in zip(r2, nsamples):
        in_s = sel_ok & (sel_d2 <= hi) & (sel_d2 >= lo)
        p2, found = first_in_order(in_s, sel_idx, N, int(ks))
        sel = torch.gather(sel_idx, 1, p2)
        sel = torch.where(found, sel, sel[:, 0:1])
        empty = ~found[:, 0] | ~qm
        sel = torch.where(empty[:, None], torch.zeros_like(sel), sel)
        out.append((sel.reshape(B, RG, int(ks)), empty.reshape(B, RG)))
    return out


def split_hi_lo(x):
    """f32 -> (bf16 hi, bf16 lo), x ~= hi + lo to about 2^-17 of |x| (both
    casts round to nearest even, as XLA's)."""
    hi = x.to(torch.bfloat16)
    lo = (x - hi.float()).to(torch.bfloat16)
    return hi, lo


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
    (B, R, C) with equal columns), cast to `out_dtype` if one is given,
    whose backward adds the gradient of each gathered row into its table
    row in int64 fixed point (steps of 2^-40 of the largest gradient
    element), exactly and so in any order, then rounds the sum to the
    gradient's dtype and on to the table's: a ball query hands one occ
    point to many balls, and the float `scatter_add_` of gather's own
    backward adds them in atomic order on the card, which differs from
    run to run (OCC_PNT_UPDATE.PASS_GRAD, where the occ points carry a
    gradient)."""

    @staticmethod
    def forward(ctx, table, idx, out_dtype=None):
        ctx.save_for_backward(idx)
        ctx.rows, ctx.table_dtype = table.shape[1], table.dtype
        out = torch.gather(table, 1, idx)
        return out if out_dtype is None else out.to(out_dtype)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        B, _, C = g.shape
        scale = _GRAD_STEPS / g.abs().amax().double().clamp(min=1e-30)
        fixed = torch.round(g.double() * scale).long()
        acc = torch.zeros((B * ctx.rows, C), dtype=torch.long, device=g.device)
        rows = (idx[..., 0] + torch.arange(B, device=g.device)[:, None] * ctx.rows).reshape(-1)
        acc.index_add_(0, rows, fixed.reshape(-1, C))
        grad = (acc.double() / scale).to(g.dtype).to(ctx.table_dtype)
        return grad.reshape(B, ctx.rows, C), None, None


def _gather(table, idx, out_dtype=None):
    """table (B, N, C), idx (B, M, k) -> (B, M, k, C) in `out_dtype` (the
    table's by default); a table that needs a gradient gathers through
    `OrderedGather`."""
    B, M, k = idx.shape
    flat = idx.reshape(B, M * k, 1).expand(B, M * k, table.shape[-1])
    if table.requires_grad and torch.is_grad_enabled():
        out = OrderedGather.apply(table, flat, out_dtype)
    else:
        out = torch.gather(table, 1, flat)
        out = out if out_dtype is None else out.to(out_dtype)
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


def candidate_table(xyz, features, cand):
    """The per-roi candidate table of the roi-grouped query: xyz (B, N, 3),
    features (B, N, C) or None, cand (B, R, ck) -> (B*R, ck, 6 + C)
    bfloat16 [hi xyz, lo xyz (`split_hi_lo`), features rounded to bf16]
    (the JAX package rounds the features to bf16 whatever its compute
    dtype). Gathered through `_gather`, so a gradient into the features
    (PASS_GRAD) adds up in a fixed order."""
    B, R, ck = cand.shape
    packed = xyz if features is None else torch.cat([xyz, features.to(xyz.dtype)], -1)
    g = _gather(packed, cand).reshape(B * R, ck, -1)
    hi, lo = split_hi_lo(g[..., :3])
    return torch.cat([hi, lo, g[..., 3:].to(torch.bfloat16)], -1)


def group_from_candidates(cand_feat, cpos, empty, new_xyz, use_xyz: bool = True,
                          rotate_matrix=None, xy_scale=None, z_scale=None, n_feat: int = 0):
    """`group_from_idx` over a candidate table: cand_feat (B*R, ck, 6 + C)
    bf16 (`candidate_table`), cpos (B, R*G, ks) positions in the roi's
    table, empty (B, R*G). The JAX package gathers with a one-hot bf16
    matmul summed in f32, in which every output is one product with 1:
    this is that gather, each row read in f32, the xyz as hi + lo. Its
    backward sums each table row's gradient exactly (`OrderedGather`) and
    rounds it to bf16, the dtype of the matmul's cotangent. Returns (B,
    R*G, ks, 3 + n_feat) (offsets rotated and scaled as `group_from_idx`
    does, empty balls zeroed)."""
    B, RG, ks = cpos.shape
    BR = cand_feat.shape[0]
    G = RG * B // BR
    g = _gather(cand_feat, cpos.reshape(BR, G, ks), torch.float32).reshape(B, RG, ks, -1)
    offs = _offsets(g[..., 0:3] + g[..., 3:6], new_xyz, empty, rotate_matrix, xy_scale,
                    z_scale)
    if not n_feat:
        assert use_xyz
        return offs
    feats = g[..., 6:6 + n_feat]
    feats = torch.where(empty[..., None, None], torch.zeros_like(feats), feats)
    return torch.cat([offs, feats], -1) if use_xyz else feats


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
    """Multi-scale grouping SA module (reference `StackSAModuleMSG`), each
    ball pooled by `pool_method`: "max_pool" (the default) or "avg_pool"
    (the mean over the nsample slots, repeated slots included). The exact
    ball query by default; with `approx_query` the JAX package's
    approximate ones: the roi-grouped query over a candidate table of
    GROUP_CAND_K points a roi (`multi_ball_query_grouped_cand`,
    `group_from_candidates`) where the call gives `group_centers` and
    `group_size` (ConvHead), else the shared-candidate query
    (`multi_ball_query(approx=True)`)."""

    def __init__(self, radii, nsamples, mlps, use_xyz: bool = True, dtype=None,
                 pool_method: str = "max_pool", approx_query: bool = False):
        super().__init__()
        if pool_method not in ("max_pool", "avg_pool"):
            raise NotImplementedError(f"pool_method {pool_method!r}")
        self.radii, self.nsamples, self.use_xyz = list(radii), list(nsamples), use_xyz
        self.pool_method = pool_method
        self.approx_query = bool(approx_query)
        self.mlps = nn.ModuleList([GroupMLP(m, dtype=dtype) for m in mlps])

    def forward(self, xyz, xyz_mask, new_xyz, new_mask, features=None, rotate_matrix=None,
                xy_scale=None, z_scale=None, group_centers=None, group_size=None):
        kw = dict(use_xyz=self.use_xyz, rotate_matrix=rotate_matrix, xy_scale=xy_scale,
                  z_scale=z_scale)
        if self.approx_query and group_centers is not None and group_size is not None:
            with torch.no_grad():
                scales, cand, _, _ = multi_ball_query_grouped_cand(
                    xyz, xyz_mask, new_xyz, new_mask, self.radii, self.nsamples,
                    group_centers, group_size, cand_k=GROUP_CAND_K)
            table = candidate_table(xyz, features, cand)
            nf = 0 if features is None else features.shape[-1]
            grouped = [group_from_candidates(table, cpos, empty, new_xyz, n_feat=nf, **kw)
                       for cpos, empty in scales]
        else:
            queries = multi_ball_query(xyz, xyz_mask, new_xyz, new_mask, self.radii,
                                       self.nsamples, approx=self.approx_query)
            grouped = [group_from_idx(xyz, new_xyz, idx, empty, features=features, **kw)
                       for idx, empty in queries]
        outs = []
        for g, mlp in zip(grouped, self.mlps):
            h = mlp(g, new_mask)
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
