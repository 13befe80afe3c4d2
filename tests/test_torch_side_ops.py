"""The side functions of the port against the JAX package: `atss_assign`
(both IoU settings), `roiaware_pool3d` (max, avg), `roipoint_pool3d`,
`chamfer_distance`, `PointPillarScatter` and the NMS functions
`class_agnostic_nms` / `multi_classes_nms`. Inputs from a numpy seed,
float32, CPU.

Tolerances: labels, indices, kept sets, sampled rows and empty flags
exact; f32 outputs 1e-4. The roi ops decide a point's box and cell by
comparisons of rotated coordinates and quotients, which XLA on the CPU
and torch may round to either side where a point lies on a box face or a
cell edge: such points (a float64 distance within 1e-5 of the face or
edge) are asserted to be there and then left out of both runs; the rest
is held exactly.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from btcdet_tpu.models import map_to_bev as JM
from btcdet_tpu.models import model_nms_utils as JN
from btcdet_tpu.models.dense_heads import atss_assigner as JA
from btcdet_tpu.ops import chamfer as JCH
from btcdet_tpu.ops import roiaware_pool as JR
from btcdet_tpu_torch.models import map_to_bev as TM
from btcdet_tpu_torch.models import model_nms_utils as TN
from btcdet_tpu_torch.models.dense_heads import anchor_head
from btcdet_tpu_torch.models.dense_heads import atss_assigner as TA
from btcdet_tpu_torch.ops import chamfer as TCH
from btcdet_tpu_torch.ops import iou3d as TI
from btcdet_tpu_torch.ops import roiaware_pool as TR
from torch_parity import assert_close


def t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------------------ ATSS


def _anchors_and_gts(seed=0):
    """Anchors on a 24 x 20 grid, 2 rotations (960), and 6 gt boxes near
    them (one invalid), classes 1..3."""
    rng = np.random.RandomState(seed)
    xs, ys = np.meshgrid(np.linspace(0, 11.5, 24), np.linspace(-4.75, 4.75, 20), indexing="xy")
    loc = np.stack([xs.ravel(), ys.ravel()], 1)
    anchors = []
    for rot in (0.0, np.pi / 2):
        a = np.zeros((len(loc), 7), np.float32)
        a[:, :2], a[:, 2], a[:, 3:6], a[:, 6] = loc, -1.0, (3.9, 1.6, 1.56), rot
        anchors.append(a)
    anchors = np.concatenate(anchors)
    gt = np.zeros((6, 7), np.float32)
    gt[:, 0] = rng.uniform(1, 10.5, 6)
    gt[:, 1] = rng.uniform(-4, 4, 6)
    gt[:, 2] = rng.uniform(-1.3, -0.7, 6)
    gt[:, 3:6] = rng.uniform([3.2, 1.4, 1.3], [4.6, 1.9, 1.8], (6, 3))
    gt[:, 6] = rng.uniform(-np.pi, np.pi, 6)
    valid = np.array([True, True, True, True, False, True])
    classes = np.array([1, 2, 3, 1, 2, 3], np.int32)
    return anchors, gt, valid, classes


def test_anchor_iou3d_chunks_equal_the_full_matrix(monkeypatch):
    """The chunked rotated IoU that `atss_assign` takes under
    `match_height` equals `iou3d.boxes_iou3d` of the whole matrix bit for
    bit (chunks of 7 pairs here)."""
    anchors, gt, _, _ = _anchors_and_gts()
    monkeypatch.setattr(anchor_head, "IOU3D_CHUNK_PAIRS", 7 * 6)
    a = t(anchors)
    full = TI.boxes_iou3d(a, t(gt))
    chunked = anchor_head.anchor_iou3d(a, torch.ones(len(a), dtype=torch.bool), t(gt))
    assert torch.equal(full, chunked) and float(full.max()) > 0.3


@pytest.mark.parametrize("match_height", [True, False], ids=["iou3d", "nearest_bev"])
def test_atss_assign_matches_jax(match_height):
    """Labels and the positive set exact, reg targets 1e-4."""
    anchors, gt, valid, classes = _anchors_and_gts()
    jl, jr, jp = JA.atss_assign(jnp.asarray(anchors), jnp.asarray(gt), jnp.asarray(valid),
                                jnp.asarray(classes), match_height=match_height)
    tl, tr, tp = TA.atss_assign(t(anchors), t(gt), t(valid), t(classes),
                                match_height=match_height)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert_close(tr.numpy(), np.asarray(jr))
    assert set(np.unique(tl.numpy())) >= {0, 1, 2, 3} and tl.dtype == torch.int32


# --------------------------------------------------------------- roi ops


def _rois_and_points(seed=1, n_rois=6, n_points=900, C=5):
    rng = np.random.RandomState(seed)
    rois = np.zeros((n_rois, 7), np.float32)
    rois[:, :3] = rng.uniform([0, -3, -1], [8, 3, 0], (n_rois, 3))
    rois[:, 3:6] = rng.uniform([2.5, 1.2, 1.2], [4.5, 2.0, 1.8], (n_rois, 3))
    rois[:, 6] = rng.uniform(-np.pi, np.pi, n_rois)
    rois[-1, :3] = (50, 50, 0)                               # no point inside
    centre = rois[rng.randint(0, n_rois - 1, n_points), :3]
    points = (centre + rng.uniform(-2.2, 2.2, (n_points, 3))).astype(np.float32)
    feats = rng.randn(n_points, C).astype(np.float32)
    mask = rng.rand(n_points) > 0.1
    return rois, points, feats, mask


def _edge_points(rois, points, out_size=None, tol=1e-5):
    """(P,) points within `tol` (float64) of some roi's box face, or with
    `out_size` of one of its cell edges."""
    r, p = rois.astype(np.float64), points.astype(np.float64)
    local = p[None, :, :3] - r[:, None, :3]
    c, s = np.cos(-r[:, 6])[:, None], np.sin(-r[:, 6])[:, None]
    lx = local[..., 0] * c + local[..., 1] * s
    ly = -local[..., 0] * s + local[..., 1] * c
    local = np.stack([lx, ly, local[..., 2]], -1)
    half = r[:, None, 3:6] / 2
    edge = (np.abs(np.abs(local) - half) < tol).any(-1)
    if out_size is not None:
        oz, oy, ox = out_size
        q = (local + half) / (r[:, None, 3:6] / np.array([ox, oy, oz]))
        inside = (np.abs(local) <= half + tol).all(-1)
        edge |= inside & (np.abs(q - np.round(q)) < tol * 10).any(-1)
    return edge.any(0)


@pytest.mark.parametrize("pool_method", ["max", "avg"])
def test_roiaware_pool3d_matches_jax(pool_method):
    """(N, 6, 6, 6, C) pooled grids: exact for max, 1e-4 for avg (the
    sums' order), 0 in every empty cell and for the roi holding no point."""
    rois, points, feats, mask = _rois_and_points()
    edge = _edge_points(rois, points, (6, 6, 6))
    assert edge.sum() <= 3, edge.sum()
    mask = mask & ~edge
    ref = np.asarray(JR.roiaware_pool3d(jnp.asarray(rois), jnp.asarray(points),
                                        jnp.asarray(feats), jnp.asarray(mask),
                                        pool_method=pool_method))
    out = TR.roiaware_pool3d(t(rois), t(points), t(feats), t(mask),
                             pool_method=pool_method).numpy()
    if pool_method == "max":
        np.testing.assert_array_equal(out, ref)
    else:
        assert_close(out, ref)
    assert (out != 0).any(-1).sum() > 50 and not out[-1].any()


def test_roipoint_pool3d_matches_jax():
    """512 samples of (xyz, features) in each enlarged roi, in point order
    and wrapped, and the empty flags, exact."""
    rois, points, feats, mask = _rois_and_points(2)
    extra = (0.2, 0.2, 0.2)
    edge = _edge_points(np.concatenate([rois[:, :3], rois[:, 3:6] + extra, rois[:, 6:]], 1),
                        points)
    assert edge.sum() <= 3, edge.sum()
    mask = mask & ~edge
    jp, je = JR.roipoint_pool3d(jnp.asarray(rois), jnp.asarray(points), jnp.asarray(feats),
                                jnp.asarray(mask), num_sampled_points=512, extra_width=extra)
    tp, te = TR.roipoint_pool3d(t(rois), t(points), t(feats), t(mask), num_sampled_points=512,
                                extra_width=extra)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert te.numpy()[-1] and not te.numpy()[:-1].any()


# ----------------------------------------------------- chamfer, scatter, NMS


def test_chamfer_distance_matches_jax():
    rng = np.random.RandomState(3)
    a = rng.randn(2, 50, 3).astype(np.float32)
    b = rng.randn(2, 60, 3).astype(np.float32)
    m1, m2 = rng.rand(2, 50) > 0.2, rng.rand(2, 60) > 0.3
    for masks in ((None, None), (m1, m2)):
        jd1, jd2 = JCH.chamfer_distance(jnp.asarray(a), jnp.asarray(b),
                                        *(None if m is None else jnp.asarray(m) for m in masks))
        td1, td2 = TCH.chamfer_distance(t(a), t(b), *(None if m is None else t(m) for m in masks))
        for x, y in ((td1, jd1), (td2, jd2)):
            y = np.asarray(y)
            np.testing.assert_array_equal(np.isinf(x.numpy()), np.isinf(y))
            fin = np.isfinite(y)
            assert_close(x.numpy()[fin], y[fin])


def test_point_pillar_scatter_matches_jax():
    """The canvas of 2 frames on a 30 x 20 grid; the port's (B, ny, nx, C)
    equals the JAX canvas and its NCHW view the transpose."""
    rng = np.random.RandomState(4)
    nx, ny, C, B = 30, 20, 6, 2
    cells = rng.choice(B * ny * nx, 150, replace=False)
    b, yx = np.divmod(cells, ny * nx)
    y, x = np.divmod(yx, nx)
    coords = np.stack([b, np.zeros_like(b), y, x], 1).astype(np.int32)
    coords = np.concatenate([coords, np.full((10, 4), -1, np.int32)])
    feats = rng.randn(len(coords), C).astype(np.float32)
    ref = np.asarray(JM.PointPillarScatter(types.SimpleNamespace(NUM_BEV_FEATURES=C),
                                           (nx, ny, 1))(jnp.asarray(feats), jnp.asarray(coords), B))
    nchw, nhwc = TM.PointPillarScatter(C, (nx, ny, 1))(t(feats), t(coords), B)
    np.testing.assert_array_equal(nhwc.numpy(), ref)
    np.testing.assert_array_equal(nchw.numpy(), ref.transpose(0, 3, 1, 2))
    assert (ref != 0).any(-1).sum() == 150


def test_nms_functions_match_jax():
    """`class_agnostic_nms` (with and without a score threshold) and
    `multi_classes_nms` over 3 classes: kept indices, flags, labels exact."""
    rng = np.random.RandomState(5)
    n = 120
    boxes = np.zeros((n, 7), np.float32)
    boxes[:, :2] = rng.uniform(0, 12, (n, 2))
    boxes[:, 2] = -1
    boxes[:, 3:6] = rng.uniform([3, 1.4, 1.4], [4.5, 1.9, 1.7], (n, 3))
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, n)
    scores = rng.rand(n, 3).astype(np.float32)
    cfg = types.SimpleNamespace(NMS_THRESH=0.1, NMS_PRE_MAXSIZE=64, NMS_POST_MAXSIZE=20)
    for thresh in (None, 0.3):
        ji, jv = JN.class_agnostic_nms(jnp.asarray(scores[:, 0]), jnp.asarray(boxes), cfg, thresh)
        ti, tv = TN.class_agnostic_nms(t(scores[:, 0]), t(boxes), cfg, thresh)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ti.numpy()[tv.numpy()], np.asarray(ji)[np.asarray(jv)])
        assert 3 < int(tv.sum()) < 20
    jall = JN.multi_classes_nms(jnp.asarray(scores), jnp.asarray(boxes), cfg, 0.2)
    tall = TN.multi_classes_nms(t(scores), t(boxes), cfg, 0.2)
    assert len(tall) == 3
    for (ji, jv, jl), (ti, tv, tl) in zip(jall, tall):
        v = np.asarray(jv)
        np.testing.assert_array_equal(tv.numpy(), v)
        np.testing.assert_array_equal(ti.numpy()[v], np.asarray(ji)[v])
        np.testing.assert_array_equal(tl.numpy()[v], np.asarray(jl)[v])
