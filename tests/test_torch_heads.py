"""Head-side parity of the port against the JAX package: rotated IoU and
NMS (same kept set), the proposal layer, the exact ball query in the
dense regime, grouping and the SA module, HeightCompression, the BEV
backbone and the anchor head decode. CPU, float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from btcdet_tpu.models import backbones_2d as J2D
from btcdet_tpu.models import map_to_bev as JBEV
from btcdet_tpu.models.dense_heads import anchor_head as JAH
from btcdet_tpu.models.roi_heads import roi_head_utils as JRH
from btcdet_tpu.ops import group_ops as JG
from btcdet_tpu.ops import iou3d as JI
from btcdet_tpu.ops import sparse as JS
from btcdet_tpu_torch import weights as W
from btcdet_tpu_torch.models import backbones_2d as T2D
from btcdet_tpu_torch.models import map_to_bev as TBEV
from btcdet_tpu_torch.models.dense_heads import anchor_head as TAH
from btcdet_tpu_torch.models.roi_heads import roi_head_utils as TRH
from btcdet_tpu_torch.ops import group_ops as TG
from btcdet_tpu_torch.ops import iou3d as TI
from btcdet_tpu_torch.ops import sparse as TS
from torch_parity import assert_close, f32_mode, perturb_variables, to_np_tree


def random_boxes(seed, n, spread=12.0):
    """Car-sized boxes crowded enough that NMS has work to do."""
    rng = np.random.RandomState(seed)
    ctr = rng.rand(n, 3) * [spread, spread, 1.0]
    dims = np.stack([rng.uniform(3, 4.5, n), rng.uniform(1.4, 2.0, n), rng.uniform(1.3, 1.8, n)], 1)
    yaw = rng.uniform(-np.pi, np.pi, n)
    return np.concatenate([ctr, dims, yaw[:, None]], 1).astype(np.float32)


def t(x):
    return torch.from_numpy(np.array(x))


def test_boxes_iou_bev_matches():
    a, b = random_boxes(0, 40), random_boxes(1, 30)
    ref = np.asarray(JI.boxes_iou_bev(jnp.asarray(a), jnp.asarray(b)))
    out = TI.boxes_iou_bev(t(a), t(b)).numpy()
    assert_close(out, ref, rtol=1e-5, atol=1e-5)
    assert (ref > 0.1).sum() > 20


@pytest.mark.parametrize("thresh,pre,post", [(0.7, 200, 64), (0.1, 120, 500), (0.3, 50, 16)])
def test_nms_rotated_same_kept_set(thresh, pre, post):
    n = 300
    boxes = random_boxes(2, n)
    rng = np.random.RandomState(3)
    scores = rng.randn(n).astype(np.float32)
    scores[::7] = scores[0]                          # score ties
    valid = rng.rand(n) < 0.85
    ji, jv = JI.nms_rotated(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid),
                            thresh=thresh, pre_max_size=pre, post_max_size=post)
    ti, tv = TI.nms_rotated(t(boxes), t(scores), t(valid), thresh=thresh, pre_max_size=pre,
                            post_max_size=post)
    jv = np.asarray(jv)
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(ti.numpy()[jv], np.asarray(ji)[jv])
    assert 0 < jv.sum() < valid[:pre].sum(), "NMS must suppress some boxes"


def test_nms_eval_size_matches_rounds():
    """The eval proposal NMS's size (k = 1024 -> 100) over boxes crowded
    round 12 objects, so the chunked pass spans several chunks: the same
    kept set as the JAX package's eval path (`impl="rounds"`, one IoU row
    per kept box)."""
    n = 1200
    rng = np.random.RandomState(7)
    centres = random_boxes(6, 12, spread=40.0)
    boxes = (centres[rng.randint(0, 12, n)] + rng.normal(0, 1, (n, 7))
             * [0.25, 0.25, 0.1, 0.1, 0.05, 0.05, 0.08]).astype(np.float32)
    scores = rng.rand(n).astype(np.float32)
    valid = rng.rand(n) < 0.95
    kw = dict(thresh=0.7, pre_max_size=1024, post_max_size=100)
    ji, jv = JI.nms_rotated(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid),
                            impl="rounds", **kw)
    ti, tv = TI.nms_rotated(t(boxes), t(scores), t(valid), **kw)
    jv = np.asarray(jv)
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(ti.numpy()[jv], np.asarray(ji)[jv])
    order = np.argsort(-np.where(valid, scores, -np.inf), kind="stable")
    last = max(int(np.flatnonzero(order == i)[0]) for i in ti.numpy()[tv.numpy()])
    assert last >= TI.NMS_CHUNK, "the case should span several chunks"


def test_nms_matches_chunked_jax_path():
    """The JAX package's large-k (train-size) chunked NMS is the same greedy."""
    n = 600
    boxes = random_boxes(4, n, spread=30.0)
    scores = np.random.RandomState(5).rand(n).astype(np.float32)
    valid = np.ones(n, bool)
    ji, jv = JI.nms_rotated(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid),
                            thresh=0.5, pre_max_size=500, post_max_size=128, impl="chunked")
    ti, tv = TI.nms_rotated(t(boxes), t(scores), t(valid), thresh=0.5, pre_max_size=500,
                            post_max_size=128)
    jv = np.asarray(jv)
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(ti.numpy()[jv], np.asarray(ji)[jv])


def test_proposal_layer_matches():
    B, A = 2, 400
    boxes = np.stack([random_boxes(6 + b, A) for b in range(B)])
    cls = np.random.RandomState(8).randn(B, A, 1).astype(np.float32)
    ref = JRH.proposal_layer(jnp.asarray(boxes), jnp.asarray(cls), nms_pre=256, nms_post=32,
                             nms_thresh=0.7)
    out = TRH.proposal_layer(t(boxes), t(cls), nms_pre=256, nms_post=32, nms_thresh=0.7)
    np.testing.assert_array_equal(out.roi_valid.numpy(), np.asarray(ref.roi_valid))
    np.testing.assert_array_equal(out.roi_labels.numpy(), np.asarray(ref.roi_labels))
    assert_close(out.rois.numpy(), np.asarray(ref.rois))
    assert_close(out.roi_scores.numpy(), np.asarray(ref.roi_scores))


def dense_cloud(seed, B=2, N=4000, M=150):
    """Points on a 1/16 m lattice in a 2 m cube: every distance is exact in
    f32 whatever the summation order, and balls hold far more points than
    nsample (the dense regime where only "first K in point order" fixes
    the neighbour set)."""
    rng = np.random.RandomState(seed)
    xyz = (rng.randint(0, 32, (B, N, 3)) / 16.0).astype(np.float32)
    mask = rng.rand(B, N) < 0.9
    new_xyz = (rng.randint(8, 24, (B, M, 3)) / 16.0).astype(np.float32)
    new_mask = rng.rand(B, M) < 0.9
    feats = rng.randn(B, N, 1).astype(np.float32)
    return xyz, mask, new_xyz, new_mask, feats


def test_multi_ball_query_exact_in_dense_balls():
    xyz, mask, new_xyz, new_mask, _ = dense_cloud(9)
    radii, nsamples = [0.4, 0.8, 1.2], [16, 16, 32]
    ref = JG.multi_ball_query(jnp.asarray(xyz), jnp.asarray(mask), jnp.asarray(new_xyz),
                              jnp.asarray(new_mask), radii, nsamples, chunk=64, approx=False)
    out = TG.multi_ball_query(t(xyz), t(mask), t(new_xyz), t(new_mask), radii, nsamples, chunk=64)
    d2 = ((new_xyz[:, :, None] - xyz[:, None]) ** 2).sum(-1)
    for s, ((ji, je), (ti, te)) in enumerate(zip(ref, out)):
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        full = ((d2 <= radii[s] ** 2) & mask[:, None]).sum(-1)
        assert (full[new_mask] > nsamples[s]).mean() > 0.5, "balls must overflow nsample"


def test_query_and_group_matches():
    xyz, mask, new_xyz, new_mask, feats = dense_cloud(10)
    rot = np.asarray(jax.vmap(jax.vmap(lambda a: jnp.array(
        [[jnp.cos(a), jnp.sin(a), 0], [-jnp.sin(a), jnp.cos(a), 0], [0, 0, 1.0]])))(
        jnp.asarray(np.random.RandomState(1).uniform(-3, 3, new_mask.shape))))
    ref, rempty = JG.query_and_group(jnp.asarray(xyz), jnp.asarray(mask), jnp.asarray(new_xyz),
                                     jnp.asarray(new_mask), 0.6, 24, features=jnp.asarray(feats),
                                     rotate_matrix=jnp.asarray(rot))
    out, oempty = TG.query_and_group(t(xyz), t(mask), t(new_xyz), t(new_mask), 0.6, 24,
                                     features=t(feats), rotate_matrix=t(rot))
    np.testing.assert_array_equal(oempty.numpy(), np.asarray(rempty))
    assert_close(out.numpy(), np.asarray(ref))


def test_point_sa_module_msg_matches():
    xyz, mask, new_xyz, new_mask, feats = dense_cloud(11)
    radii, nsamples, mlps = [0.4, 1.2], [8, 16], [[4, 8, 8], [4, 8, 16]]
    rot = np.tile(np.eye(3, dtype=np.float32), new_mask.shape + (1, 1))
    rot[..., 0, 1], rot[..., 1, 0] = 0.6, -0.6
    args = (jnp.asarray(xyz), jnp.asarray(mask), jnp.asarray(new_xyz), jnp.asarray(new_mask))
    jsa = JG.PointSAModuleMSG(radii=radii, nsamples=nsamples, mlps=mlps, approx_query=False,
                              dtype=jnp.float32)
    with f32_mode():
        v = jsa.init(jax.random.PRNGKey(0), *args, features=jnp.asarray(feats),
                     rotate_matrix=jnp.asarray(rot))
        v = perturb_variables(v, seed=2)
        ref = jsa.apply(v, *args, features=jnp.asarray(feats), rotate_matrix=jnp.asarray(rot))
        tsa = TG.PointSAModuleMSG(radii, nsamples, mlps, dtype=torch.float32).eval()
        sd = {}
        for i in range(len(mlps)):
            pm, sm = v["params"][f"mlp_{i}"], v["batch_stats"][f"mlp_{i}"]
            for k in range(len(mlps[i]) - 1):
                sd[f"mlps.{i}.{3 * k}.weight"] = W.inv_fc(pm[f"Dense_{k}"]["kernel"], 4)
                W._bn(sd, f"mlps.{i}.{3 * k + 1}", pm[f"MaskedBatchNorm_{k}"],
                      sm[f"MaskedBatchNorm_{k}"])
        tsa.load_state_dict({k: torch.tensor(np.asarray(x)) for k, x in sd.items()}, strict=True)
        with torch.no_grad():
            out = tsa(t(xyz), t(mask), t(new_xyz), t(new_mask), features=t(feats),
                      rotate_matrix=t(rot))
    assert_close(out.numpy(), np.asarray(ref))
    assert np.abs(np.asarray(ref)).max() > 0.1


def test_height_compression_matches():
    rng = np.random.RandomState(12)
    shape, B, C = (2, 20, 24), 2, 6
    n = 300
    coords = np.unique(np.stack([rng.randint(0, B, n), rng.randint(0, 2, n),
                                 rng.randint(0, 20, n), rng.randint(0, 24, n)], 1), axis=0)
    coords = np.concatenate([coords, -np.ones((20, 4), np.int64)]).astype(np.int32)
    feats = rng.randn(len(coords), C).astype(np.float32)
    jst = JS.from_coords(jnp.asarray(feats), jnp.asarray(coords), shape, B)
    tst = TS.from_coords(t(feats), t(coords), shape, B)
    with f32_mode():
        ref = np.asarray(JBEV.HeightCompression()(jst))
        nchw, nhwc = TBEV.HeightCompression()(tst)
    np.testing.assert_array_equal(nhwc.numpy(), ref)
    # the reference's C-major fold: channel c*nz + d
    d = tst.dense().numpy()                                    # (B, nz, ny, nx, C)
    np.testing.assert_array_equal(nchw.numpy()[:, 3 * 2 + 1], d[:, 1, :, :, 3])


def test_bev_backbone_matches():
    x = np.random.RandomState(13).randn(2, 16, 12, 32).astype(np.float32)      # NHWC
    cfg = dict(layer_nums=(1, 2), layer_strides=(1, 2), num_filters=(8, 12),
               upsample_strides=(1, 2), num_upsample_filters=(8, 8))
    jm = J2D.BaseBEVBackbone(**cfg)
    with f32_mode():
        v = perturb_variables(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), seed=3)
        ref = np.asarray(jm.apply(v, jnp.asarray(x)))
        tm = T2D.BaseBEVBackbone(32, cfg["layer_nums"], cfg["layer_strides"], cfg["num_filters"],
                                 cfg["upsample_strides"], cfg["num_upsample_filters"]).eval()
        # flax numbering: per block its convs, then its upsample head
        p, s, sd = v["params"], v["batch_stats"], {}
        conv = 0
        for b, n in enumerate(cfg["layer_nums"]):
            for k in range(n + 1):
                sd[f"blocks.{b}.{1 + 3 * k}.weight"] = W.inv_conv2d(p[f"Conv_{conv}"]["kernel"])
                W._bn(sd, f"blocks.{b}.{2 + 3 * k}", p[f"_BN_{conv}"]["BatchNorm_0"],
                      s[f"_BN_{conv}"]["BatchNorm_0"])
                conv += 1
            up = p[f"Conv_{conv}"] if f"Conv_{conv}" in p else p["ConvTranspose_0"]
            sd[f"deblocks.{b}.0.weight"] = W.inv_convT2d(up["kernel"])
            W._bn(sd, f"deblocks.{b}.1", p[f"_BN_{conv}"]["BatchNorm_0"],
                  s[f"_BN_{conv}"]["BatchNorm_0"])
            conv += 1
        tm.load_state_dict({k: torch.tensor(np.asarray(a)) for k, a in sd.items()}, strict=True)
        with torch.no_grad():
            out = tm(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert out.shape == ref.shape
    assert_close(out, ref)


def test_anchor_head_decode_matches():
    pcr, grid = (0.0, -3.2, -3.0, 6.4, 3.2, 1.0), (64, 64, 40)
    acfg = [{"class_name": "Car", "anchor_sizes": [[3.9, 1.6, 1.56]],
             "anchor_rotations": [0, 1.57], "anchor_bottom_heights": [-1.78],
             "align_center": False, "feature_map_stride": 8,
             "matched_threshold": 0.6, "unmatched_threshold": 0.45}]
    ja, jc, per = JAH.generate_anchors(pcr, grid, acfg)
    ta, tc, tper = TAH.generate_anchors(pcr, grid, acfg)
    np.testing.assert_array_equal(ta, ja)
    x = np.random.RandomState(14).randn(2, 8, 8, 16).astype(np.float32)
    jm = JAH.AnchorHeadSingle(num_class=1, anchors=ja, anchor_class=jc,
                              num_anchors_per_location=per)
    v = to_np_tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    rng = np.random.RandomState(15)
    for k in ("Conv_0", "Conv_1", "Conv_2"):       # O(1) regressions and logits
        v["params"][k]["kernel"] = rng.normal(0, 0.3, v["params"][k]["kernel"].shape).astype(np.float32)
    ref = jm.apply(v, jnp.asarray(x))
    tm = TAH.AnchorHeadSingle(16, 1, ta, tper)
    sd = {}
    for ours, name in (("Conv_0", "conv_cls"), ("Conv_1", "conv_box"), ("Conv_2", "conv_dir_cls")):
        sd[f"{name}.weight"] = torch.tensor(W.inv_conv2d(v["params"][ours]["kernel"]))
        sd[f"{name}.bias"] = torch.tensor(v["params"][ours]["bias"])
    tm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = tm(t(x).permute(0, 3, 1, 2))
    for k in ("cls_preds", "box_preds", "dir_preds", "batch_box_preds"):
        assert_close(out[k].numpy(), np.asarray(ref[k]), err_msg=k)
