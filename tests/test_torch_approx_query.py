"""The JAX package's approximate ball queries in the port, against
`btcdet_tpu` on the CPU: `split_hi_lo`, `group_from_candidates` (forward
and VJP), both stages of the roi-grouped `multi_ball_query_grouped_cand`
(random, tied and over-full layouts), `multi_ball_query_grouped`,
`multi_ball_query(approx=True)`, the approximate `PointSAModuleMSG`
(values, and the PASS_GRAD gradient into the pooled features), and the
micro model with ROI_HEAD.APPROX_QUERY on: its eval detections and one
train step.

The JAX package takes its candidates with `lax.approx_max_k`, which on the
CPU is the exact top-k, ties to the lower index: the port's query is held
to it entry for entry. Where two answers may differ, because a point lies
within f32 rounding of a radius or of the cut of the candidate list,
each differing entry is proven valid in float64 (`d2_round`)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from btcdet_tpu.ops import group_ops as JG
from btcdet_tpu_torch import weights as W
from btcdet_tpu_torch.ops import group_ops as TG
from torch_parity import assert_close, f32_mode, full_micro_cfgs, perturb_variables, run_both

# f32 unit roundoff: |c|^2 + |x|^2 - 2 c.x in f32 is within
# 8 * U32 * (|c| + |x|)^2 of its exact value, however its sums are ordered
U32 = 2.0 ** -24
# bf16 activations (the SA MLPs' compute dtype): each of the two layers
# rounds its output to bf16 once, so the pooled features agree to a few
# bf16 ulps (2^-8 of the value) of the output's magnitude
BF16_TOL = 2.0 ** -5


def t(x):
    return torch.from_numpy(np.array(x))


def j(x):
    return jnp.asarray(np.asarray(x))


def bf16_bits(x):
    """The bit patterns (uint16) of a bf16 JAX or torch array."""
    if torch.is_tensor(x):
        return x.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def bf16_ulp(x):
    """The bf16 spacing at |x| (the smallest normal's below it)."""
    e = np.floor(np.log2(np.maximum(np.abs(np.asarray(x, np.float64)), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def d2_round(q, x):
    """The f32 rounding bound of |q|^2 + |x|^2 - 2 q.x (float64 (..., 3)
    arrays, broadcast)."""
    return 8 * U32 * (np.linalg.norm(q, axis=-1) + np.linalg.norm(x, axis=-1)) ** 2


def scene(seed, B=2, N=3000, R=6, G=27, extent=(8.0, 8.0, 3.0), spread=0.8, lattice=False):
    """B frames of N points (90 % valid) in a box of `extent`, R roi centres
    and G query points a roi scattered around its centre (roi-major), 80 %
    of the rois valid. `lattice`: every coordinate on a 1/16 m grid and the
    first 200 points repeated later in the table, so that candidate
    distances tie exactly."""
    rng = np.random.RandomState(seed)
    ext = np.asarray(extent)
    xyz = rng.rand(B, N, 3) * ext
    cent = rng.rand(B, R, 3) * ext
    new = cent[:, :, None, :] + rng.randn(B, R, G, 3) * spread
    if lattice:
        xyz, cent, new = (np.round(a * 16) / 16 for a in (xyz, cent, new))
        xyz[:, N - 200:] = xyz[:, :200]
    mask = rng.rand(B, N) < 0.9
    new_mask = np.repeat(rng.rand(B, R) < 0.8, G, axis=1)
    f32 = lambda a: a.astype(np.float32)
    return f32(xyz), mask, f32(new.reshape(B, R * G, 3)), new_mask, f32(cent)


RADII = [0.4, 0.8, (0.8, 1.6), 2.4]          # a shell among the balls
NSAMPLES = [16, 16, 32, 64]


# ------------------------------------------------------------- proofs

def candidates_valid(cand, xyz, mask, cent, b, r):
    """`cand` (ck,) is a valid nearest-ck list for centre `cent[b, r]` in
    float64: the valid points among it are all the valid points, or the
    list holds every valid point nearer than the ck-th distance less its
    rounding bound and none farther than it plus the bound."""
    x = xyz[b].astype(np.float64)
    c = cent[b, r].astype(np.float64)
    d2 = ((x - c) ** 2).sum(-1)
    ok = mask[b]
    listed = set(int(i) for i in cand if ok[i])
    valid = np.flatnonzero(ok)
    ck = len(cand)
    if len(valid) <= ck:
        return listed == set(valid.tolist())
    kth = np.sort(d2[valid])[ck - 1]
    eps = d2_round(c, x)
    must = set(np.flatnonzero(ok & (d2 < kth - eps)).tolist())
    may = ok & (d2 <= kth + eps)
    return must <= listed and all(may[i] for i in listed) and len(listed) == ck


def ball_valid(lst, empty, cands, xyz, mask, q, lo, hi):
    """`lst` (ks,) with `empty` is a valid first-in-point-order answer for
    the query point `q` among the candidate indices `cands` in float64:
    each listed point a valid candidate within the rounding bound of
    [lo, hi], and every candidate surely inside listed, up to the list's
    last index where the list is full."""
    x = xyz.astype(np.float64)
    d2 = ((x - q.astype(np.float64)) ** 2).sum(-1)
    eps = d2_round(q.astype(np.float64), x)
    cset = [int(i) for i in cands if mask[i]]
    surely = {i for i in cset if lo + eps[i] < d2[i] < hi - eps[i]}
    picked = set() if empty else {int(i) for i in lst}
    if not all(i in cset and lo - eps[i] <= d2[i] <= hi + eps[i] for i in picked):
        return False
    if len(picked) == len(lst):
        surely = {i for i in surely if i < max(picked)}
    return surely <= picked


def assert_same_or_valid(ref, out, cands_ref, cands_out, xyz, mask, new_xyz, radii):
    """Per scale, (idx, empty) lists of point indices equal, or each query
    whose lists differ valid on both sides (`ball_valid`) with the
    candidates of its own side (cands_*[b][m], point indices). Returns the
    number of differing queries."""
    n_diff = 0
    for s, ((ri, re), (oi, oe), rad) in enumerate(zip(ref, out, radii)):
        lo, hi = (rad[0] ** 2, rad[1] ** 2) if isinstance(rad, tuple) else (0.0, rad ** 2)
        differ = (ri != oi).any(-1) | (re != oe)
        for b, m in zip(*np.nonzero(differ)):
            for idx, emp, cands in ((ri, re, cands_ref), (oi, oe, cands_out)):
                assert ball_valid(idx[b, m], emp[b, m], cands[b][m], xyz[b], mask[b],
                                  new_xyz[b, m], lo, hi), (s, b, m)
            n_diff += 1
    return n_diff


def global_ids(cpos, cand, G):
    """cpos (B, R*G, ks) positions in each roi's candidate table -> point
    indices."""
    B, R, ck = cand.shape
    rows = np.repeat(np.arange(R), G)
    return np.take_along_axis(np.asarray(cand)[:, rows, :], np.asarray(cpos), axis=-1)


def roi_cands(cand, G):
    """[b][m] -> the candidate point indices of query m's roi."""
    cand = np.asarray(cand)
    return [[cand[b, m // G] for m in range(cand.shape[1] * G)] for b in range(cand.shape[0])]


def all_points(B, M, N):
    return [[np.arange(N)] * M for _ in range(B)]


# --------------------------------------------------------------- tests

def test_split_hi_lo_bit_for_bit():
    """Round to nearest even in both casts: random values over 40 octaves,
    both signs, and values exactly halfway between two bf16s."""
    rng = np.random.RandomState(0)
    x = rng.randn(4000) * 2.0 ** rng.randint(-20, 20, 4000)
    ties = (np.arange(256) + 0.5) * 2.0 ** -7 + 1.0       # halfway between bf16s of [1, 2)
    x = np.concatenate([x, ties, -ties, [0.0, -0.0, 1e-30]]).astype(np.float32)
    jh, jl = JG.split_hi_lo(j(x))
    th, tl = TG.split_hi_lo(t(x))
    np.testing.assert_array_equal(bf16_bits(th), bf16_bits(jh))
    np.testing.assert_array_equal(bf16_bits(tl), bf16_bits(jl))
    assert th.dtype == tl.dtype == torch.bfloat16


def _from_candidates_case(seed=1):
    """A candidate table of 5 channels, positions, empties, query points,
    rotations and scales."""
    rng = np.random.RandomState(seed)
    B, R, G, ck, ks, C = 2, 5, 8, 64, 16, 5
    xyz = (rng.rand(B * R, ck, 3) * 60).astype(np.float32)
    hi, lo = TG.split_hi_lo(t(xyz))
    feats = t(rng.randn(B * R, ck, C).astype(np.float32)).to(torch.bfloat16)
    table = torch.cat([hi, lo, feats], -1)
    cpos = rng.randint(0, ck, (B, R * G, ks))
    empty = rng.rand(B, R * G) < 0.2
    new_xyz = (rng.rand(B, R * G, 3) * 60).astype(np.float32)
    a = rng.uniform(-3, 3, (B, R * G))
    rot = np.zeros((B, R * G, 3, 3), np.float32)
    rot[..., 0, 0], rot[..., 0, 1], rot[..., 1, 0], rot[..., 1, 1] = (
        np.cos(a), np.sin(a), -np.sin(a), np.cos(a))
    rot[..., 2, 2] = 1.0
    xy_s = rng.uniform(0.5, 2, (B, R * G)).astype(np.float32)
    z_s = rng.uniform(0.5, 2, (B, R * G)).astype(np.float32)
    cot = rng.randn(B, R * G, ks, 3 + C).astype(np.float32)
    return table, cpos, empty, new_xyz, rot, xy_s, z_s, cot, C


def test_group_from_candidates_matches_bit_for_bit():
    """The forward equals the one-hot matmul's bit for bit (offsets and
    features); with the per-query rotation and scales, whose f32 sums the
    two packages order differently, to 1e-4. Its VJP: the JAX cotangent
    of the bf16 table is the bf16 rounding of an f32 sum over the rows that
    read a table row (the transpose of the bf16 `dot_general`); the port's
    is the exact sum rounded alike, so on the feature columns (cotangent:
    the output's, zeroed on empty balls) it equals the float64 sum rounded
    to f32 then bf16, bit for bit, and the JAX one lies within one bf16
    ulp of it, as on the xyz columns."""
    table, cpos, empty, new_xyz, rot, xy_s, z_s, cot, C = _from_candidates_case()
    jtab = j(table.float().numpy()).astype(jnp.bfloat16)
    jargs = (j(cpos.astype(np.int32)), j(empty), j(new_xyz))
    targs = (t(cpos), t(empty), t(new_xyz))
    plain = JG.group_from_candidates(jtab, *jargs, n_feat=C)
    out = TG.group_from_candidates(table, *targs, n_feat=C)
    np.testing.assert_array_equal(out.numpy(), np.asarray(plain))

    def jfn(tab):
        return JG.group_from_candidates(tab, *jargs, rotate_matrix=j(rot), xy_scale=j(xy_s),
                                        z_scale=j(z_s), n_feat=C)
    ref, vjp = jax.vjp(jfn, jtab)
    (ref_ct,) = vjp(j(cot))
    assert ref_ct.dtype == jnp.bfloat16
    tab = table.clone().requires_grad_()
    out = TG.group_from_candidates(tab, *targs, rotate_matrix=t(rot), xy_scale=t(xy_s),
                                   z_scale=t(z_s), n_feat=C)
    assert_close(out.detach().numpy(), np.asarray(ref))
    out.backward(t(cot))
    got = tab.grad
    assert got.dtype == torch.bfloat16

    # the feature columns' exact sums
    BR, ck, _ = table.shape
    B, RG, ks = cpos.shape
    rows = (np.arange(B)[:, None] * (BR // B) + np.arange(RG)[None, :] // (RG * B // BR))
    g_feat = np.where(empty[..., None, None], 0.0, cot[..., 3:].astype(np.float64))
    exact = np.zeros((BR, ck, C))
    np.add.at(exact, (np.broadcast_to(rows[..., None], cpos.shape), cpos), g_feat)
    want = torch.from_numpy(exact.astype(np.float32)).to(torch.bfloat16)
    np.testing.assert_array_equal(bf16_bits(got[..., 6:]), bf16_bits(want))
    got_f, ref_f = got.float().numpy(), np.asarray(ref_ct.astype(jnp.float32))
    assert (np.abs(got_f - ref_f) <= bf16_ulp(np.maximum(np.abs(got_f), np.abs(ref_f)))).all()
    assert np.abs(ref_f).max() > 1.0 and (got_f != 0).mean() > 0.5


@pytest.mark.parametrize("lattice", [False, True], ids=["random", "ties"])
def test_stage1_candidates_match(lattice):
    """Stage 1 (the cand_k points nearest each roi centre) against the JAX
    package's: the same lists in the same order; where a set differs,
    each differing member lies within f32 rounding of the cut (the
    cand_k-th distance), on both sides. `ties`: lattice points and
    repeated points, so equal distances are exact on both sides and only
    the lower-index rule orders them."""
    xyz, mask, new, new_mask, cent = scene(2, lattice=lattice, N=1500)
    _, jc, jcx, jok = JG.multi_ball_query_grouped_cand(
        j(xyz), j(mask), j(new), j(new_mask), RADII, NSAMPLES, j(cent), 27, cand_k=256)
    tc, tcx, tok = TG.roi_candidates(t(xyz), t(mask), t(cent), 256)
    jc, tc = np.asarray(jc), tc.numpy()
    n_diff = 0
    for b, r in zip(*np.nonzero((jc != tc).any(-1))):
        n_diff += 1
        for c in (jc[b, r], tc[b, r]):
            assert candidates_valid(c, xyz, mask, cent, b, r), (b, r)
    if lattice:
        d2 = ((xyz[:, None].astype(np.float64) - cent[:, :, None]) ** 2).sum(-1)
        kth = np.sort(np.where(mask[:, None], d2, np.inf), -1)[..., 255]
        at_cut = (d2 == kth[..., None]).sum(-1)
        assert (at_cut >= 2).sum() >= 3, ("the cut must fall within a tie on some rois", at_cut)
        np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tcx.numpy(), np.take_along_axis(
        xyz, tc.reshape(2, -1)[..., None], 1).reshape(tcx.shape))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))


@pytest.mark.parametrize("lattice", [False, True], ids=["random", "ties"])
def test_stage2_on_jax_candidates_matches(lattice):
    """Stage 2 on the JAX package's own candidates: the same positions, or
    (random points) each differing ball proven valid at its radius."""
    xyz, mask, new, new_mask, cent = scene(3, lattice=lattice)
    jscales, jc, jcx, jok = JG.multi_ball_query_grouped_cand(
        j(xyz), j(mask), j(new), j(new_mask), RADII, NSAMPLES, j(cent), 27)
    out = TG.select_in_candidates(t(np.asarray(jc).astype(np.int64)), t(jcx), t(jok), t(new),
                                  t(new_mask), RADII, NSAMPLES, xyz.shape[1])
    ref = [(global_ids(p, jc, 27), np.asarray(e)) for p, e in jscales]
    got = [(global_ids(p.numpy(), jc, 27), e.numpy()) for p, e in out]
    cands = roi_cands(jc, 27)
    n_diff = assert_same_or_valid(ref, got, cands, cands, xyz, mask, new, RADII)
    if lattice:
        assert n_diff == 0
        for (p, e), (jp, je) in zip(out, jscales):
            np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    assert n_diff <= 2, n_diff
    full = [(np.asarray(e) == 0).mean() for _, e in jscales]
    assert min(full) > 0.5, full


def test_stage2_grid_point_on_a_candidate():
    """A grid point at a candidate's own place (9 of each roi's 27, on a
    70 x 80 m scene): the port clamps d^2 at 0, as its exact query does, so
    the candidate is in each of the grid point's balls (listed unless the
    ball is full of lower indices); the JAX package does not clamp, so it
    keeps the candidate where its f32 d^2 rounds to >= 0 and drops it where
    it rounds below 0, and then lists the first points of the ball without
    it. Every other ball is the same on both sides. Some of the planted
    points fall on each side of 0 in the JAX package's rounding."""
    rng = np.random.RandomState(10)
    B, R, G, N, ck = 1, 8, 27, 800, 128
    radii, ns = [0.4, 0.8, (0.8, 1.6)], [16, 16, 32]
    xyz = (rng.rand(B, N, 3) * [70.0, 80.0, 4.0] - [0.0, 40.0, 2.0]).astype(np.float32)
    mask = np.ones((B, N), bool)
    cent = xyz[:, rng.choice(N, R, replace=False)]
    new = (cent[:, :, None, :] + rng.randn(B, R, G, 3) * 0.5).astype(np.float32)
    tc, tcx, _ = TG.roi_candidates(t(xyz), t(mask), t(cent), ck)
    planted = {}                                   # grid point -> point index
    for r in range(R):
        for g in range(0, G, 3):
            c = rng.randint(ck)
            new[0, r, g] = tcx[r, c].numpy()
            planted[r * G + g] = int(tc[0, r, c])
    new = new.reshape(B, R * G, 3)
    new_mask = np.ones((B, R * G), bool)
    jscales, jc, jcx, jok = JG.multi_ball_query_grouped_cand(
        j(xyz), j(mask), j(new), j(new_mask), radii, ns, j(cent), G, cand_k=ck)
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    out = TG.select_in_candidates(tc, tcx, t(np.asarray(jok)), t(new), t(new_mask), radii, ns, N)
    # the JAX package's own f32 d^2 of each planted grid point to its point
    qp = j(new).reshape(R, G, 3)
    jd2 = np.asarray(jnp.sum(qp * qp, -1)[..., None] + jnp.sum(jcx * jcx, -1)[:, None, :]
                     - 2.0 * jnp.einsum("rgc,rkc->rgk", qp, jcx,
                                        preferred_element_type=jnp.float32))
    cands = roi_cands(jc, G)
    kept = dropped = 0
    for ((jp, je), (tp, te), rad, ks) in zip(jscales, out, radii, ns):
        ji, ti = global_ids(jp, jc, G)[0], global_ids(tp.numpy(), jc, G)[0]
        je, te = np.asarray(je)[0], te.numpy()[0]
        shell = isinstance(rad, tuple)
        lo, hi = (rad[0] ** 2, rad[1] ** 2) if shell else (0.0, rad ** 2)
        for m in range(R * G):
            same = je[m] == te[m] and (je[m] or (ji[m] == ti[m]).all())
            p = planted.get(m)
            if p is None or shell:
                assert same, (rad, m)
                continue
            listed = set(ti[m].tolist())
            assert not te[m] and (p in listed or (len(listed) == ks and max(listed) < p))
            c = int(np.flatnonzero(np.asarray(jc)[0, m // G] == p)[0])
            if jd2[m // G, m % G, c] >= 0:
                assert same, (rad, m)
                kept += 1
            else:
                assert ball_valid(ji[m], je[m], [i for i in cands[0][m] if i != p], xyz[0],
                                  mask[0], new[0, m], lo, hi), (rad, m)
                assert p not in set(ji[m].tolist()) or je[m]
                dropped += 1
    assert kept > 0 and dropped > 0, (kept, dropped)


def test_grouped_cand_matches_jax_not_exact_in_over_full_balls():
    """A cluster of 4608 points (sigma 0.5 m) around the first roi's centre,
    among 2000 background points: the 512 candidates nearest the centre fill
    the balls of that roi's grid points, whose exact first-in-point-order
    neighbours often lie among the cluster's other points. The port equals
    the JAX package there (global point indices), and differs from the
    exact query on more than a third of those grid points' balls."""
    rng = np.random.RandomState(4)
    B, R, G = 1, 3, 27
    cent = np.array([[[5.0, 5.0, 1.0], [2.0, 7.0, 1.0], [7.0, 2.0, 2.0]]], np.float32)
    cluster = cent[0, 0] + rng.randn(4608, 3) * 0.5
    bg = rng.rand(2000, 3) * [10.0, 10.0, 3.0]
    pts = np.concatenate([bg[:1000], cluster, bg[1000:]])[None].astype(np.float32)
    mask = np.ones(pts.shape[:2], bool)
    offs = np.stack(np.meshgrid(*[np.array([-0.6, 0.0, 0.6])] * 3, indexing="ij"), -1)
    new = (cent[:, :, None, :] + offs.reshape(1, 1, G, 3)).reshape(B, R * G, 3)
    new = new.astype(np.float32)
    new_mask = np.ones((B, R * G), bool)
    radii, ns = [0.4, 0.8, 1.2, 2.4], [16, 16, 32, 64]
    jscales, jc, _, _ = JG.multi_ball_query_grouped_cand(
        j(pts), j(mask), j(new), j(new_mask), radii, ns, j(cent), G)
    tscales, tc, _, _ = TG.multi_ball_query_grouped_cand(
        t(pts), t(mask), t(new), t(new_mask), radii, ns, t(cent), G)
    exact = TG.multi_ball_query(t(pts), t(mask), t(new), t(new_mask), radii, ns)
    ref = [(global_ids(p, jc, G), np.asarray(e)) for p, e in jscales]
    got = [(global_ids(p.numpy(), tc.numpy(), G), e.numpy()) for p, e in tscales]
    assert assert_same_or_valid(ref, got, roi_cands(jc, G), roi_cands(tc, G), pts, mask, new,
                                radii) == 0
    share = []
    for (gi, _), (ei, _) in zip(got, exact):
        share.append(float((gi[0, :G] != ei.numpy()[0, :G]).any(-1).mean()))
    assert max(share) > 1 / 3, share


def test_grouped_and_shared_candidate_queries_match():
    """`multi_ball_query_grouped` (balls: the shared nearest-k_max step;
    with a shell: the whole candidate table) and the shared-candidate
    `multi_ball_query(approx=True)` (balls; with a shell it falls back to
    the exact query) against the JAX package's."""
    xyz, mask, new, new_mask, cent = scene(5)
    args = (j(xyz), j(mask), j(new), j(new_mask))
    targs = (t(xyz), t(mask), t(new), t(new_mask))
    balls, ns = [0.4, 0.8, 1.2], [16, 16, 32]
    n_diff = 0
    for radii in (balls, RADII[:3]):
        ns_r = NSAMPLES[:3] if radii is not balls else ns
        ref = JG.multi_ball_query_grouped(*args, radii, ns_r, j(cent), 27, cand_k=400)
        out = TG.multi_ball_query_grouped(*targs, radii, ns_r, t(cent), 27, cand_k=400)
        _, tc, _, _ = TG.multi_ball_query_grouped_cand(*targs, radii, ns_r, t(cent), 27,
                                                       cand_k=400)
        cands = roi_cands(tc.numpy(), 27)
        n_diff += assert_same_or_valid([(np.asarray(i), np.asarray(e)) for i, e in ref],
                                       [(i.numpy(), e.numpy()) for i, e in out],
                                       cands, cands, xyz, mask, new, radii)
        ref = JG.multi_ball_query(*args, radii, ns_r, chunk=64, approx=True)
        out = TG.multi_ball_query(*targs, radii, ns_r, chunk=64, approx=True)
        every = all_points(2, new.shape[1], xyz.shape[1])
        n_diff += assert_same_or_valid([(np.asarray(i), np.asarray(e)) for i, e in ref],
                                       [(i.numpy(), e.numpy()) for i, e in out],
                                       every, every, xyz, mask, new, radii)
    assert n_diff <= 2, n_diff


# ------------------------------------------------------- the SA module

SA_RADII, SA_NS, SA_MLPS = [0.4, 0.8, 1.6], [8, 16, 16], [[4, 8, 8], [4, 8, 16], [4, 8, 8]]


def _sa_case(dtype, seed=6):
    """The approximate SA module of both packages with the same perturbed
    weights, and its inputs (features: one channel)."""
    xyz, mask, new, new_mask, cent = scene(seed, N=2000, R=5)
    feats = np.random.RandomState(seed).rand(*xyz.shape[:2], 1).astype(np.float32)
    rot = np.tile(np.eye(3, dtype=np.float32), new_mask.shape + (1, 1))
    rot[..., 0, 1], rot[..., 1, 0] = 0.6, -0.6
    jsa = JG.PointSAModuleMSG(radii=SA_RADII, nsamples=SA_NS, mlps=SA_MLPS, approx_query=True,
                              group_cand_k=TG.GROUP_CAND_K, dtype=dtype)
    jargs = (j(xyz), j(mask), j(new), j(new_mask))
    jkw = dict(features=j(feats), rotate_matrix=j(rot), group_centers=j(cent), group_size=27)
    v = perturb_variables(jsa.init(jax.random.PRNGKey(0), *jargs, **jkw), seed=2)
    tsa = TG.PointSAModuleMSG(SA_RADII, SA_NS, SA_MLPS, approx_query=True,
                              dtype=torch.float32 if dtype == jnp.float32 else torch.bfloat16)
    tsa.load_state_dict({k: t(x) for k, x in W.sa_module_state(v["params"],
                                                                v["batch_stats"]).items()})
    targs = (t(xyz), t(mask), t(new), t(new_mask))
    tkw = dict(features=t(feats), rotate_matrix=t(rot), group_centers=t(cent), group_size=27)
    return jsa, v, jargs, jkw, tsa.eval(), targs, tkw


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_point_sa_module_approx_matches(dtype):
    """f32 (BTCDET_F32) to 1e-4; bf16 MLPs to BF16_TOL of the output's max.
    Both round the pooled features to bf16 in the candidate table."""
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    with f32_mode():
        jsa, v, jargs, jkw, tsa, targs, tkw = _sa_case(jdt)
        ref = np.asarray(jsa.apply(v, *jargs, **jkw).astype(jnp.float32))
        with torch.no_grad():
            out = tsa(*targs, **tkw).float().numpy()
    assert np.abs(ref).max() > 0.1
    if dtype == "f32":
        assert_close(out, ref)
    else:
        tol = BF16_TOL * np.abs(ref).max()
        np.testing.assert_allclose(out, ref, rtol=0, atol=tol)


def test_point_sa_module_pass_grad_matches():
    """The gradient of a random projection of the approximate SA module's
    output into its pooled features (f32; PASS_GRAD's occ probabilities).
    A feature's gradient is a sum over the rois that hold the point as a
    candidate of each roi's table-row cotangent rounded to bf16, which
    each package sums in f32 in its own order before the rounding; so the
    two agree within one bf16 ulp of each row cotangent, 2^-7 of its
    magnitude, summed over the point's rois. The row cotangents are
    rebuilt from the port's grouped gradients (their f32 differences from
    the JAX ones are covered by 1e-5 of the same sum)."""
    with f32_mode():
        jsa, v, jargs, jkw, tsa, targs, tkw = _sa_case(jnp.float32, seed=7)
        proj = np.random.RandomState(8).randn(*jargs[2].shape[:2], 32).astype(np.float32)

        def loss(f):
            return (jsa.apply(v, *jargs, **dict(jkw, features=f)) * j(proj)).sum()
        ref = np.asarray(jax.grad(loss)(jkw["features"]))

        seen = {}
        hooks = [m.register_full_backward_hook(
            lambda mod, gi, go, i=i: seen.__setitem__(i, gi[0].detach().numpy()))
            for i, m in enumerate(tsa.mlps)]
        feats = tkw["features"].clone().requires_grad_()
        (tsa(*targs, **dict(tkw, features=feats)) * t(proj)).sum().backward()
        for h in hooks:
            h.remove()
        got = feats.grad.numpy()
        scales, cand, _, _ = TG.multi_ball_query_grouped_cand(
            *targs, SA_RADII, SA_NS, tkw["group_centers"], 27, cand_k=TG.GROUP_CAND_K)
    cand = cand.numpy()
    B, R, ck = cand.shape
    rows = np.repeat(np.arange(R), 27)
    row_ct = np.zeros((B, R, ck))
    for i, (cpos, empty) in enumerate(scales):
        g = np.where(empty.numpy()[..., None], 0.0, seen[i][..., 3].astype(np.float64))
        for b in range(B):
            np.add.at(row_ct[b], (np.broadcast_to(rows[:, None], g.shape[1:]), cpos[b].numpy()),
                      g[b])
    bound = np.zeros(got.shape[:2])
    for b in range(B):
        np.add.at(bound[b], cand[b].reshape(-1), np.abs(row_ct[b]).reshape(-1))
    tol = (2.0 ** -7 + 1e-5) * bound + 1e-9
    err = np.abs(got[..., 0] - ref[..., 0])
    assert (err <= tol).all(), float((err / np.maximum(tol, 1e-30)).max())
    assert (np.abs(ref) > 0).mean() > 0.1 and np.abs(ref).max() > 1e-3


# ------------------------------------------------------------ the model

@functools.cache
def micro_eval():
    from btcdet_tpu.config import EasyDict

    data_cfg, model_cfg = full_micro_cfgs(APPROX_QUERY=True)
    return run_both(EasyDict({"DATA_CONFIG": data_cfg, "MODEL": model_cfg}), 2048, 4)


def test_micro_eval_with_approx_query_matches():
    """The full micro config with APPROX_QUERY True, eval forward +
    post-processing: rcnn outputs and detections to 1e-4 (f32, as
    tests/test_torch_model.py holds the exact query)."""
    res = micro_eval()
    ref, out, ref_post, post = res["ref"], res["out"], res["ref_post"], res["post"]
    assert not res["missing"].missing_keys and not res["missing"].unexpected_keys
    np.testing.assert_array_equal(out["roi_valid"], ref["roi_valid"])
    assert_close(out["rois"], ref["rois"])
    assert_close(out["batch_cls_preds"], ref["batch_cls_preds"])
    assert_close(out["batch_box_preds"], ref["batch_box_preds"])
    np.testing.assert_array_equal(post["pred_valid"], ref_post["pred_valid"])
    np.testing.assert_array_equal(post["pred_labels"], ref_post["pred_labels"])
    assert_close(post["pred_scores"], ref_post["pred_scores"])
    assert_close(post["pred_boxes"], ref_post["pred_boxes"])
    assert post["pred_valid"].any()


@functools.cache
def micro_step():
    from test_torch_train import train_step_both

    data_cfg, model_cfg = full_micro_cfgs(DP_RATIO=0.0, APPROX_QUERY=True)
    return train_step_both(data_cfg, model_cfg, 2048, 4)


def test_micro_train_step_with_approx_query_matches():
    """One micro train step with APPROX_QUERY True in both packages (same
    weights, batch and roi draws): loss terms to 1e-4, every gradient
    within 1e-3 of its tensor's max (as tests/test_torch_train_step.py
    holds the exact query's step)."""
    from test_torch_train import assert_step_gradients_match

    res = micro_step()
    ref, out = res["ref_metrics"], res["metrics"]
    for k in ref:
        assert np.isfinite(out[k]), k
        assert_close(out[k], float(np.asarray(ref[k])), err_msg=k)
    assert ref["rcnn_loss_cls"] > 0
    assert_step_gradients_match(res)
