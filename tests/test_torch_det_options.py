"""The det-side options of the port against the JAX package on the CPU:
the materialized PassOccVox merge (OCC_PNT_UPDATE.FUSED_VFE False, both
MERGE_IMPL versions) and its gradient, OccVFE and MeanVFE over the merged
table, DATA_CONFIG.CLAMP, MATCH_HEIGHT's target assignment (the rotated
3-D IoU, chunked over anchors), and the micro model's eval forward under
each model-level BACKBONE_3D.OUT_FEAT_TYPE (`None`, `combine`,
`big_combine`). The other det VFE options' and the fractional upsample's
eval forwards are in tests/test_torch_det_vfe.py, their train steps and
the optimizers in tests/test_torch_det_train.py. CPU, float32, exact ball
queries; the model runs share one JAX run per config."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close, full_micro_cfgs, run_both

# the merged table's capacities in the unit cases
GRID = (12, 10, 4)            # nx, ny, nz
MAX_POINTS = 8


def t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _merge_case(seed: int, B: int = 2, Nd: int = 30, Pd: int = 5, K: int = 90, extra: int = 7):
    """Per frame a key-sorted det table (valid rows first, -1 padding, the
    points inside their cells) widened to MAX_POINTS slots and 6 channels,
    and K new points: a third in det cells (some overflowing the slots),
    the rest in new cells (more cells than `extra`), a few out of the
    grid (clamped to its edge) and a few invalid."""
    rng = np.random.RandomState(seed)
    nx, ny, nz = GRID
    dvox = np.zeros((B, Nd, MAX_POINTS, 6), np.float32)
    dc = np.full((B, Nd, 4), -1, np.int32)
    dn = np.zeros((B, Nd), np.int32)
    opts = np.zeros((B, K, 6), np.float32)
    ovalid = rng.rand(B, K) > 0.1
    for b in range(B):
        nv = Nd - 4
        keys = np.sort(rng.choice(nx * ny * nz, nv, replace=False))
        zyx = np.stack([keys // (nx * ny), keys // nx % ny, keys % nx], -1)
        dc[b, :nv] = np.concatenate([np.full((nv, 1), b), zyx], -1)
        dn[b, :nv] = rng.randint(1, Pd + 1, nv)
        for r in range(nv):
            xyz = zyx[r, ::-1] + rng.rand(dn[b, r], 3)
            dvox[b, r, :dn[b, r], :3] = xyz
            dvox[b, r, :dn[b, r], 3] = rng.rand(dn[b, r])
        hot = zyx[rng.randint(0, nv, K // 3), ::-1]
        xyz = np.concatenate([hot + rng.rand(K // 3, 3),
                              rng.rand(K - K // 3, 3) * [nx, ny, nz]], 0)
        xyz[:4] += [[-3.0, 0, 0], [0, 2.0 * ny, 0], [0, 0, 9.0], [40.0, -5.0, 0]]
        opts[b, :, :3] = xyz[rng.permutation(K)]
        opts[b, :, 3] = 0.0
        opts[b, :, 4] = rng.uniform(0.1, 1.0, K)
        opts[b, :, 5] = 1.0
    return dvox, dc, dn, opts * ovalid[..., None], ovalid, extra


def _jax_merge(impl, case, opts=None):
    from btcdet_tpu.ops import voxelizer as JV

    dvox, dc, dn, o, ov, extra = case
    fn = {"v1": JV.merge_points_into_voxels, "v2": JV.merge_points_into_voxels_v2}[impl]

    def merge(dv, c, n, p, v):
        return fn(dv, c, n, p, v, grid_size=GRID, lo=jnp.zeros(3), vs=jnp.ones(3),
                  extra=extra, max_points=MAX_POINTS)
    return jax.vmap(merge)(jnp.asarray(dvox), jnp.asarray(dc), jnp.asarray(dn),
                           jnp.asarray(o if opts is None else opts), jnp.asarray(ov))


def _port_merge(case, opts=None):
    from btcdet_tpu_torch.ops import voxelizer as TV

    dvox, dc, dn, o, ov, extra = case
    return TV.merge_points_into_voxels(t(dvox), t(dc), t(dn), t(o) if opts is None else opts,
                                       t(ov), grid_size=GRID, lo=torch.zeros(3),
                                       vs=torch.ones(3), extra=extra, max_points=MAX_POINTS)


@pytest.mark.parametrize("impl", ["v1", "v2"])
@pytest.mark.parametrize("seed", [0, 1])
def test_merge_matches_jax_bit_for_bit(impl, seed):
    """The merged point table, counts, coords and row flags equal the JAX
    package's v1 and v2 merges (MERGE_IMPL) bit for bit."""
    case = _merge_case(seed)
    ref = [np.asarray(r) for r in _jax_merge(impl, case)]
    out = [r.numpy() for r in _port_merge(case)]
    for name, a, b in zip(("vox", "num", "coords_zyx", "row_valid"), out, ref):
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    dn, extra = case[2], case[5]
    num, rv = ref[1], ref[3]
    # the case covers hits, slot overflow, new rows and a full extra block
    assert (num[:, :dn.shape[1]] > dn).any() and (num[:, :dn.shape[1]] == MAX_POINTS).any()
    assert rv[:, dn.shape[1]:].all()


def test_merge_gradient_matches_jax():
    """Under PASS_GRAD the merged table's gradient reaches the kept points'
    values, as the JAX VJP sends it: bit for bit (each kept point is a copy)."""
    case = _merge_case(3)
    w = np.random.RandomState(4).randn(2, 30 + case[5], MAX_POINTS, 6).astype(np.float32)

    def loss(o):
        return (_jax_merge("v1", case, o)[0] * w).sum()
    ref = np.asarray(jax.grad(loss)(jnp.asarray(case[3])))
    o = t(case[3]).requires_grad_(True)
    (_port_merge(case, o)[0] * t(w)).sum().backward()
    np.testing.assert_array_equal(o.grad.numpy(), ref)
    assert (ref != 0).any(axis=-1).sum() > 20 and (ref == 0).all(axis=-1).any()


def test_vfes_match_jax():
    """OccVFE (features and the occ code) and MeanVFE over a merged table
    against the JAX package's, to 1e-5."""
    from btcdet_tpu.models import vfe as JVFE

    from btcdet_tpu_torch.models import vfe as TVFE

    case = _merge_case(5)
    vox, num = (np.asarray(r) for r in _jax_merge("v1", case)[:2])
    vox, num = vox.reshape(-1, MAX_POINTS, 6), num.reshape(-1)
    ref_f, ref_c = JVFE.OccVFE(num_raw_features=4)(jnp.asarray(vox), jnp.asarray(num))
    out_f, out_c = TVFE.OccVFE(4)(t(vox), t(num))
    assert_close(out_f.numpy(), np.asarray(ref_f), rtol=1e-5, atol=1e-5)
    assert_close(out_c.numpy(), np.asarray(ref_c), rtol=1e-5, atol=1e-5)
    # the case has voxels of occ points only, of raw points only, of both
    occ = vox[..., -1] >= 0.05
    filled = np.arange(MAX_POINTS)[None] < num[:, None]
    assert ((occ & filled).any(1) & ~(~occ & filled).any(1)).any()
    assert ((occ & filled).any(1) & (~occ & filled).any(1)).any()
    ref_m = JVFE.MeanVFE(num_raw_features=4)(jnp.asarray(vox), jnp.asarray(num))
    assert_close(TVFE.MeanVFE()(t(vox), t(num)).numpy(), np.asarray(ref_m), rtol=1e-5,
                 atol=1e-5)


def _clamp_batch(seed=0):
    rng = np.random.RandomState(seed)
    return {"points": rng.uniform(-2, 3, (2, 50, 4)).astype(np.float32),
            "voxels": rng.uniform(-2, 3, (30, 5, 4)).astype(np.float32),
            "occ_voxels": rng.uniform(-2, 3, (20, 12, 4)).astype(np.float32),
            "det_voxels": rng.uniform(-2, 3, (30, 5, 5)).astype(np.float32),
            "gt_boxes": rng.uniform(-2, 3, (2, 3, 8)).astype(np.float32)}


def test_clamp_max_matches_jax_bit_for_bit():
    """CLAMP 1.0: channel 3 of the points and of every voxel table clipped
    to [0, 1], the other channels and keys untouched, bit for bit."""
    from btcdet_tpu.models.detectors import btcnet as JB

    from btcdet_tpu_torch.models.detectors import btcnet as TB

    batch = _clamp_batch()
    ref = JB._clamp_intensity({k: jnp.asarray(v) for k, v in batch.items()}, 1.0)
    out = TB.clamp_intensity({k: t(v) for k, v in batch.items()}, 1.0)
    for k in batch:
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]), err_msg=k)
    assert not np.array_equal(out["points"].numpy(), batch["points"])


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def test_clamp_tanh_matches_jax_within_its_tanh_error():
    """CLAMP tanh: the same channels through tanh, every other value equal
    bit for bit. XLA's float32 tanh on the CPU is a rational approximation
    up to 5 ulps from the correctly rounded value (2 M draws in [-20, 20]),
    torch's within 1 (ROADMAP Queue 3): the two agree to 6 ulps, and the
    port's is within 1 ulp of float64's tanh rounded."""
    from btcdet_tpu.models.detectors import btcnet as JB

    from btcdet_tpu_torch.models.detectors import btcnet as TB

    batch = _clamp_batch(1)
    ref = JB._clamp_intensity({k: jnp.asarray(v) for k, v in batch.items()}, "tanh")
    out = TB.clamp_intensity({k: t(v) for k, v in batch.items()}, "tanh")
    for k in batch:
        a, b = out[k].numpy(), np.asarray(ref[k])
        if k == "gt_boxes":
            np.testing.assert_array_equal(a, b)
            continue
        np.testing.assert_array_equal(np.delete(a, 3, -1), np.delete(b, 3, -1), err_msg=k)
        assert _ulps(a[..., 3], b[..., 3]).max() <= 6, k
        exact = np.tanh(batch[k][..., 3].astype(np.float64)).astype(np.float32)
        assert _ulps(a[..., 3], exact).max() <= 1, k


def _anchor_case(seed=0):
    from btcdet_tpu.models.dense_heads import anchor_head as JAH

    cfgs = [{"class_name": n, "anchor_sizes": [s], "anchor_rotations": [0, 1.57],
             "anchor_bottom_heights": [h], "align_center": False, "feature_map_stride": 8,
             "matched_threshold": 0.5, "unmatched_threshold": 0.35}
            for n, s, h in (("Car", [3.9, 1.6, 1.56], -1.78), ("Pedestrian", [0.8, 0.6, 1.73], -0.6),
                            ("Cyclist", [1.76, 0.6, 1.73], -0.6))]
    anchors, anchor_class, _ = JAH.generate_anchors((0, -8, -3, 16, 8, 1), (128, 128), cfgs)
    rng = np.random.RandomState(seed)
    gt = anchors[rng.choice(len(anchors), 8, replace=False)].copy()
    gt[:, :3] += rng.normal(0, 0.3, (8, 3))
    gt[:, 6] += rng.normal(0, 0.2, 8)
    return anchors, anchor_class, gt.astype(np.float32)


@pytest.mark.parametrize("ci", [0, 1, 2])
def test_match_height_labels_match_jax(ci, monkeypatch):
    """MATCH_HEIGHT's assignment for each class of a 3-class anchor set:
    the labels and reg mask equal the JAX package's bit for bit, the reg
    targets to 1e-5; the port's IoU chunked over 37 anchors at a time
    gives the same bits as one call."""
    from btcdet_tpu.models.dense_heads import anchor_head as JAH
    from btcdet_tpu.utils import box_coder as JBC

    from btcdet_tpu_torch.models.dense_heads import anchor_head as TAH
    from btcdet_tpu_torch.utils.box_coder import ResidualCoder

    anchors, anchor_class, gt = _anchor_case()
    gv = np.arange(len(gt)) % 3 == ci
    sel = anchor_class == ci
    ref = JAH.assign_targets_single_class(
        jnp.asarray(anchors), jnp.asarray(sel), jnp.asarray(gt), jnp.asarray(gv), ci + 1,
        0.5, 0.35, JBC.ResidualCoder(), True)
    args = (t(anchors), t(sel), t(gt), t(gv), ci + 1, 0.5, 0.35, ResidualCoder(), True)
    out = TAH.assign_targets_single_class(*args)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
    assert_close(out[1].numpy(), np.asarray(ref[1]), rtol=1e-5, atol=1e-5)
    assert (np.asarray(ref[0]) == ci + 1).sum() >= 2
    whole = TAH.anchor_iou3d(t(anchors), t(sel), t(gt))
    monkeypatch.setattr(TAH, "IOU3D_CHUNK_PAIRS", 37 * len(gt))
    np.testing.assert_array_equal(TAH.anchor_iou3d(t(anchors), t(sel), t(gt)).numpy(),
                                  whole.numpy())


# ------------------------------------------------- the micro model, eval

def set_out_feat_type(model_cfg, kind: str):
    """OUT_FEAT_TYPE `kind`; under `combine` ConvHead's x_combine sampler at
    the strided grid's stride, (16, 16, 8) det voxels in x, y, z, so the
    samples land where the features are (the yaml's (8, 8, 8) reads the
    halved grid at twice the distance, in both packages alike)."""
    model_cfg.BACKBONE_3D.OUT_FEAT_TYPE = ["None"] * 4 + [kind]
    if kind == "combine":
        model_cfg.ROI_HEAD.CONV_GRID_POOL.CONV_LAYER.x_combine.DOWNSAMPLE_FACTOR = [16, 16, 8]



@functools.cache
def out_feat_run(kind: str) -> dict:
    from btcdet_tpu.config import EasyDict

    data_cfg, model_cfg = full_micro_cfgs()
    set_out_feat_type(model_cfg, kind)
    return run_both(EasyDict({"DATA_CONFIG": data_cfg, "MODEL": model_cfg}), 2048, 4)


def assert_eval_matches(res):
    """The eval forward's stages (1e-4) and the detections of the port
    against the JAX package's: every weight mapped, the rois' slots and
    labels, the rcnn outputs, the kept detections."""
    assert not res["missing"].missing_keys and not res["missing"].unexpected_keys
    ref, out = res["ref"], res["out"]
    for k in ("encoded_features", "spatial_features_2d", "rpn_cls_preds", "rpn_box_preds",
              "rois", "batch_cls_preds", "batch_box_preds"):
        assert out[k].shape == ref[k].shape, k
        assert_close(out[k], ref[k], err_msg=k)
    for k in ("roi_valid", "roi_labels"):
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    post, ref_post = res["post"], res["ref_post"]
    np.testing.assert_array_equal(post["pred_valid"], ref_post["pred_valid"])
    np.testing.assert_array_equal(post["pred_labels"], ref_post["pred_labels"])
    assert_close(post["pred_scores"], ref_post["pred_scores"])
    assert_close(post["pred_boxes"], ref_post["pred_boxes"])
    assert post["pred_valid"].any()


@pytest.mark.parametrize("kind", ["None", "combine", "big_combine"])
def test_out_feat_type_eval_matches(kind):
    """The micro model under each OUT_FEAT_TYPE: `None` (no x_combine, no
    combine convs, ConvHead without the x_combine branch), `combine`
    (x_combine on the stride-(1,2,2) spconv5 sites, sampled there) and
    `big_combine`."""
    assert_eval_matches(out_feat_run(kind))


def test_out_feat_type_parameter_sets():
    """Which backbone and head parameters each OUT_FEAT_TYPE makes: `None`
    has no down2 / down3 / squeezeBev / down_combine and no x_combine conv
    stack; `combine` has the strided down_combine.1 (spconv5) and
    down_combine.2 (subm5) at 128 channels."""
    from btcdet_tpu.config import EasyDict

    from btcdet_tpu_torch.models import build_network

    names = {}
    for kind in ("None", "combine", "big_combine", "big_bev_combine"):
        data_cfg, model_cfg = full_micro_cfgs()
        model_cfg.BACKBONE_3D.OUT_FEAT_TYPE = ["None"] * 4 + [kind]
        cfg = EasyDict({"DATA_CONFIG": data_cfg, "MODEL": model_cfg})
        net = build_network(cfg.MODEL, cfg.DATA_CONFIG, ["Car"], device="cpu")
        names[kind] = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    bb = "det_modules.backbone_3d."
    for part in ("down2.", "down3.", "squeezeBev.", "down_combine."):
        assert not any(k.startswith(bb + part) for k in names["None"]), part
    assert not any("roi_head.conv_layers" in k for k in names["None"])
    ch = names["big_bev_combine"][bb + "down_combine.0.0.weight"][-1]
    assert names["combine"][bb + "down_combine.1.0.weight"] == (3, 3, 3, ch, ch)
    assert names["combine"][bb + "down_combine.2.0.weight"] == (3, 3, 3, ch, ch)
    assert bb + "down_combine.2.0.weight" not in names["big_combine"]
    assert not any(k.startswith(bb + "squeezeBev.") for k in names["big_combine"])
    # the rcnn's first FC drops the x_combine pool's channels
    fc = "det_modules.roi_head.shared_fc_layer.0.weight"
    assert names["None"][fc][1] < names["combine"][fc][1] == names["big_bev_combine"][fc][1]


def test_combine_samples_the_spconv5_grid():
    """Under `combine` ConvHead samples the stride-(1,2,2) spconv5 volume:
    the conv4 grid's depth, half its rows and columns, the same width."""
    from btcdet_tpu.config import EasyDict

    from btcdet_tpu_torch.datasets import make_synthetic_batch
    from btcdet_tpu_torch.models import build_network

    grids = {}
    for kind in ("combine", "big_combine"):
        data_cfg, model_cfg = full_micro_cfgs()
        model_cfg.BACKBONE_3D.OUT_FEAT_TYPE = ["None"] * 4 + [kind]
        cfg = EasyDict({"DATA_CONFIG": data_cfg, "MODEL": model_cfg})
        net = build_network(cfg.MODEL, cfg.DATA_CONFIG, ["Car"], device="cpu")
        seen = {}
        hook = net.det_modules.roi_head.register_forward_pre_hook(
            lambda m, a: seen.update(xc=a[5]))
        net(make_synthetic_batch(cfg.DATA_CONFIG, batch_size=2, num_points=2048, num_gt=4,
                                 seed=0, mode="test", device="cpu"))
        hook.remove()
        grids[kind] = (tuple(seen["xc"].spatial_shape), seen["xc"].features.shape[1])
    (d, h, w), c = grids["big_combine"]
    assert grids["combine"] == (((d - 1) // 1 + 1, (h - 1) // 2 + 1, (w - 1) // 2 + 1), c)
