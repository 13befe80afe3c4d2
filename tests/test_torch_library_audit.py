"""The library functions of the JAX package that no config reaches, in the
port against `btcdet_tpu`: every box coder of `utils/box_coder.py` (and
`build_box_coder`), `iou3d.nms_normal`, `box_utils.points_in_boxes_id`
and the flat-list occ-target helpers `mirror_points_in_boxes_batched` /
`points_in_gt_batched`. Inputs from a numpy seed, float32, CPU.

Tolerances: indices, kept sets and masks exact; coded and decoded boxes
to 1e-5 relative (elementwise log / exp / atan2, whose f32 libraries may
round apart by an ulp or two); mirrored points to 1e-4 (sums of rotated
coordinates)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from btcdet_tpu.models.occ import occ_targets as JT
from btcdet_tpu.ops import iou3d as JI
from btcdet_tpu.utils import box_coder as JBC
from btcdet_tpu.utils import box_utils as JBU
from btcdet_tpu_torch.models.occ import occ_targets as TT
from btcdet_tpu_torch.ops import iou3d as TI
from btcdet_tpu_torch.utils import box_coder as TBC
from btcdet_tpu_torch.utils import box_utils as TBU
from torch_parity import assert_close


def t(x):
    return torch.from_numpy(np.array(x))


def boxes(rng, n, extra: int = 0):
    """(n, 7 + extra) boxes: centres over 20 m, car-to-pedestrian dims, any
    heading, `extra` velocity-like columns."""
    b = np.concatenate([rng.uniform(-10, 10, (n, 3)), rng.uniform(0.4, 4.5, (n, 3)),
                        rng.uniform(-np.pi, np.pi, (n, 1)), rng.randn(n, extra)], 1)
    return b.astype(np.float32)


CODERS = [
    ("ResidualCoder", {}, 0), ("ResidualCoder", {"encode_angle_by_sincos": True}, 2),
    ("AbsResidualCoder", {}, 2), ("AbsResidualCoder", {"encode_angle_by_sincos": True}, 0),
    ("DeltaXYZWLHRBBoxCoder", {}, 1),
]


@pytest.mark.parametrize("name,kw,extra", CODERS,
                         ids=[f"{n}-{'sincos' if k else 'plain'}-{e}" for n, k, e in CODERS])
def test_box_coder_encode_decode_match(name, kw, extra):
    rng = np.random.RandomState(len(name) + extra)
    gt, anchors = boxes(rng, 300, extra), boxes(rng, 300, extra)
    jc, tc = JBC.build_box_coder(name, **kw), TBC.build_box_coder(name, **kw)
    assert type(tc).__name__ == name and tc.code_size == jc.code_size
    ref = np.asarray(jc.encode(jnp.asarray(gt), jnp.asarray(anchors)))
    enc = tc.encode(t(gt), t(anchors))
    assert enc.shape == ref.shape == (300, tc.code_size + extra)
    assert_close(enc.numpy(), ref, rtol=1e-5, atol=1e-5)
    dec_ref = np.asarray(jc.decode(jnp.asarray(ref), jnp.asarray(anchors)))
    dec = tc.decode(t(ref), t(anchors))
    assert_close(dec.numpy(), dec_ref, rtol=1e-5, atol=1e-5)
    # a round trip gives the boxes back (headings up to a turn under sincos)
    assert_close(dec.numpy()[:, :6], gt[:, :6], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["PreviousResidualDecoder", "PreviousResidualRoIDecoder"])
def test_previous_residual_decoders_match(name):
    rng = np.random.RandomState(3)
    enc = (rng.randn(200, 9) * 0.3).astype(np.float32)
    anchors = boxes(rng, 200, 2)
    ref = np.asarray(JBC.build_box_coder(name).decode(jnp.asarray(enc), jnp.asarray(anchors)))
    out = TBC.build_box_coder(name).decode(t(enc), t(anchors))
    assert out.shape == ref.shape == (200, 9)
    assert_close(out.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mean,classes", [(True, True), (True, False), (False, False)],
                         ids=["mean_size-classes", "mean_size", "no_mean_size"])
def test_point_residual_coder_matches(mean, classes):
    rng = np.random.RandomState(4)
    gt = boxes(rng, 250)
    pts = (gt[:, :3] + rng.randn(250, 3) * 0.5).astype(np.float32)
    cls = rng.randint(1, 4, 250).astype(np.int32) if classes else None
    sizes = [[3.9, 1.6, 1.56], [0.8, 0.6, 1.73], [1.76, 0.6, 1.73]]
    kw = dict(use_mean_size=mean, mean_size=sizes)
    jc, tc = JBC.build_box_coder("PointResidualCoder", **kw), TBC.PointResidualCoder(**kw)
    ref = np.asarray(jc.encode(jnp.asarray(gt), jnp.asarray(pts),
                               None if cls is None else jnp.asarray(cls)))
    enc = tc.encode(t(gt), t(pts), None if cls is None else t(cls))
    assert_close(enc.numpy(), ref, rtol=1e-5, atol=1e-5)
    dec_ref = np.asarray(jc.decode(jnp.asarray(ref), jnp.asarray(pts),
                                   None if cls is None else jnp.asarray(cls)))
    dec = tc.decode(t(ref), t(pts), None if cls is None else t(cls))
    assert_close(dec.numpy(), dec_ref, rtol=1e-5, atol=1e-5)


def test_nms_normal_matches():
    rng = np.random.RandomState(5)
    b = boxes(rng, 400)
    b[:, :2] = rng.uniform(0, 12, (400, 2))
    b[:, 3:6] = rng.uniform(1.4, 4.5, (400, 3))
    scores = rng.rand(400).astype(np.float32)
    valid = rng.rand(400) < 0.9
    ji, jv = JI.nms_normal(jnp.asarray(b), jnp.asarray(scores), jnp.asarray(valid), thresh=0.5,
                           pre_max_size=300, post_max_size=256)
    ti, tv = TI.nms_normal(t(b), t(scores), t(valid), thresh=0.5, pre_max_size=300,
                           post_max_size=256)
    jv = np.asarray(jv)
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(ti.numpy()[jv], np.asarray(ji)[jv])
    assert 10 < jv.sum() < 250, "the boxes must suppress each other"


def test_points_in_boxes_id_matches():
    """Overlapping boxes, so that the first containing box decides."""
    rng = np.random.RandomState(6)
    b = boxes(rng, 12)
    b[:, :3] = rng.uniform(-3, 3, (12, 3))
    pts = rng.uniform(-5, 5, (3000, 3)).astype(np.float32)
    ref = np.asarray(JBU.points_in_boxes_id(jnp.asarray(pts), jnp.asarray(b)))
    out = TBU.points_in_boxes_id(t(pts), t(b)).numpy()
    np.testing.assert_array_equal(out, ref)
    inside = JBU.points_in_boxes_mask(pts, b)
    assert (inside.sum(1) > 1).any() and (ref == -1).any()


def test_mirror_and_membership_of_flat_point_lists_match():
    """A flat point list with a frame index a point, in no frame order."""
    rng = np.random.RandomState(7)
    B, N, G = 3, 1500, 4
    gt = np.zeros((B, G, 8), np.float32)
    gt[..., :3] = rng.uniform(-3, 3, (B, G, 3))
    gt[..., 3:6] = rng.uniform(1.5, 4.0, (B, G, 3))
    gt[..., 6] = rng.uniform(-np.pi, np.pi, (B, G))
    gt[..., 7] = 1
    gt_valid = rng.rand(B, G) < 0.8
    flag = (rng.rand(B, G) < 0.7).astype(np.float32)
    pts = rng.uniform(-4, 4, (N, 3)).astype(np.float32)
    valid = rng.rand(N) < 0.9
    pb = rng.randint(0, B, N).astype(np.int32)
    args = (pts, valid, pb, gt, gt_valid, flag)
    ref = JT.mirror_points_in_boxes_batched(*map(jnp.asarray, args), B)
    out = TT.mirror_points_in_boxes_batched(*map(t, args), B)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
    sel = np.asarray(ref[2])
    assert sel.sum() > 50
    assert_close(out[1].numpy()[sel], np.asarray(ref[1])[sel])
    ref_in = JT.points_in_gt_batched(*map(jnp.asarray, (pts, valid, pb, gt, gt_valid)), B)
    out_in = TT.points_in_gt_batched(*map(t, (pts, valid, pb, gt, gt_valid)), B)
    np.testing.assert_array_equal(out_in.numpy(), np.asarray(ref_in))
    assert np.asarray(ref_in).sum() > np.asarray(ref[2]).sum()
