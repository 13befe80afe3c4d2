"""PV-RCNN on the port's normal path (`MODEL.NAME` PVRCNN,
`models/detectors/pv_rcnn.py`) against the plain float32 reference of the
published equations (`tests/plain/pvrcnn.py`), on the CPU at the micro
config (`mini_config.micro_pv_rcnn_cfg`), float32 everywhere, seeded
random weights: furthest point sampling, the VSA at PV-RCNN's source
settings (its per-frame grouping against the whole-table query too),
`PointHeadSimple`, `PVRCNNHead` (a roi whose grid finds no keypoint
included), the roi decode, and one whole eval forward. Also
`build_network`'s dispatch, the state-dict names at the published widths,
the stages, read-backs and tallies of a recorded forward.

Tests marked `cuda` hold the FPS kernel (`csrc/furthest_point_sample.cu`)
to the plain loop bit for bit, one launch a call; they skip without a
card: `python -m pytest --noconftest tests/test_torch_pvrcnn.py -m cuda`.

Tolerances: indices (FPS picks, keypoints) exact; float32 features and
logits 1e-4 relative (the port and the plain reference add BN, matmul and
MLP terms in other orders); the per-frame grouping equals the whole-table
query to the bit.
"""

import functools

import numpy as np
import pytest
import torch

from btcdet_tpu_torch.config import pv_rcnn
from btcdet_tpu_torch.datasets.mini_config import micro_model_cfg, micro_pv_rcnn_cfg
from btcdet_tpu_torch.datasets.synthetic import make_synthetic_batch_np
from btcdet_tpu_torch.models import build_network
from btcdet_tpu_torch.models.detectors import BtcNet, PVRCNN, post_processing, pv_rcnn as D
from btcdet_tpu_torch.models.dense_heads.point_head_simple import PointHeadSimple
from btcdet_tpu_torch.models.roi_heads.pvrcnn_head import PVRCNNHead
from btcdet_tpu_torch.ops import group_ops
from btcdet_tpu_torch.utils import common, trace
from plain import pvrcnn as P

RTOL, ATOL = 1e-4, 1e-5


def close(a, b, what=""):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=RTOL, atol=ATOL, err_msg=what)


def seeded_state(net, seed: int) -> dict:
    """Random weights by name: BN variances U(0.5, 1.5), means N(0, 0.3),
    scales N(1, 0.2), other vectors N(0, 0.2), kernels N(0, 2 / fan_in)."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in net.state_dict().items():
        if not v.dtype.is_floating_point:
            sd[k] = v
        elif k.endswith("running_var"):
            sd[k] = 0.5 + torch.rand(v.shape, generator=g)
        elif k.endswith("running_mean"):
            sd[k] = 0.3 * torch.randn(v.shape, generator=g)
        elif v.dim() <= 1:
            sd[k] = float(k.endswith(".weight")) + 0.2 * torch.randn(v.shape, generator=g)
        else:
            out = v.shape[-1] if v.dim() == 5 else v.shape[0]
            sd[k] = torch.randn(v.shape, generator=g) * (2.0 / (v.numel() // out)) ** 0.5
    return sd


def _batch(cfg, seed=3, num_points=1024, B=2):
    b = make_synthetic_batch_np(cfg.DATA_CONFIG, batch_size=B, num_points=num_points, num_gt=3,
                                seed=seed, mode="test")
    out = {k: torch.from_numpy(v) for k, v in b.items()}
    out["points_mask"][1, 700:] = False            # a mixed batch: frame 1 has fewer points
    out["points"][1, 700:] = 0.0
    return out


@functools.cache
def _micro() -> dict:
    """The micro PV-RCNN in float32 on one batch: the net, its weights, the
    batch, the forward's output and the backbone's levels."""
    with common.float32_everywhere():
        cfg = micro_pv_rcnn_cfg()
        net = build_network(cfg.MODEL, cfg.DATA_CONFIG, list(cfg.CLASS_NAMES), device="cpu")
        sd = seeded_state(net, 0)
        net.load_state_dict(sd)
        batch = _batch(cfg)
        kept = {}
        net.backbone_3d.register_forward_hook(lambda m, a, o: kept.update(levels=o))
        out = net(batch)
        bev = net.map_to_bev_module(kept["levels"]["encoded"])[0].permute(0, 2, 3, 1)
    return dict(cfg=cfg, net=net, sd=sd, batch=batch, out=out, levels=kept["levels"], bev=bev)


def _plain_levels(levels) -> dict:
    return {k: (st.coords.long(), st.features) for k, st in levels.items() if k.startswith("x_conv")}


# --------------------------------------------------------------------- FPS

def _fps_cloud(case: str, B=3, N=300, seed=0):
    rng = np.random.RandomState(seed)
    xyz = rng.uniform(-5, 5, (B, N, 3)).astype(np.float32)
    mask = rng.rand(B, N) > 0.2                                     # masked points
    if case == "ties":
        xyz[:, 1::2] = xyz[:, 0::2][:, :xyz[:, 1::2].shape[1]]       # every point twice
        xyz = np.round(xyz).astype(np.float32)                        # equal distances
    if case == "fewer_valid":
        mask[0] = False
        mask[0, [5, 17, 40]] = True
        mask[1] = False                                               # no valid point
        mask[1, 0] = False
    return torch.from_numpy(xyz), torch.from_numpy(mask)


@pytest.mark.parametrize("case", ["masked", "ties", "fewer_valid"])
def test_fps_matches_plain(case):
    """The port's FPS (the plain loop on CPU tensors) picks the reference's
    indices, frame by frame: ties to the lowest index, masked points never
    while a valid one is left, a frame with fewer valid points repeating."""
    xyz, mask = _fps_cloud(case)
    got = group_ops.furthest_point_sample(xyz, mask, 64)
    np.testing.assert_array_equal(got.numpy(), P.fps(xyz, mask, 64).numpy())
    if case == "fewer_valid":
        assert set(got[0].tolist()) == {5, 17, 40} and set(got[1].tolist()) == {0}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the FPS kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case, B, N, K", [
    ("pv_rcnn", 8, 16384, 2048), ("masked", 3, 1000, 256), ("ties", 3, 3000, 512),
    ("fewer_valid", 3, 300, 64), ("global_memory", 2, 24000, 512), ("one_point", 1, 1, 4)])
def test_fps_kernel_equals_plain_loop(cuda, case, B, N, K):
    """The kernel's indices equal the plain loop's on the card bit for bit,
    in one launch: at PV-RCNN's eval shape (8 frames of 16 384 points, 2048
    picks), with ties, masks, frames with fewer valid points than picks or
    none, and a frame too large for shared memory."""
    xyz, mask = _fps_cloud(case if case in ("ties", "fewer_valid") else "masked", B, N, 1)
    xyz, mask = xyz.to(cuda), mask.to(cuda)
    before = trace.COUNTS.get("launch.furthest_point_sample", 0)
    got = group_ops.furthest_point_sample(xyz, mask, K)
    assert trace.COUNTS.get("launch.furthest_point_sample", 0) == before + 1
    want = group_ops.furthest_point_sample_plain(xyz, mask, K)
    differ = (got != want).any(1)
    assert not differ.any(), f"frames {torch.nonzero(differ).flatten().tolist()} differ"


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["masked", "fewer_valid"])
def test_fps_kernel_past_its_registers_keeps_distances_in_scratch(cuda, case):
    """Frames of more than `FPS_REG_POINTS` points (32 running distances a
    thread) run the kernel too, their distances in a scratch buffer: one
    launch, the plain loop's indices bit for bit on the card and the plain
    reference's on the CPU."""
    N = group_ops.FPS_REG_POINTS + 7232                            # 40 000 points
    xyz, mask = _fps_cloud(case, 2, N, 2)
    before = trace.COUNTS.get("launch.furthest_point_sample", 0)
    got = group_ops.furthest_point_sample(xyz.to(cuda), mask.to(cuda), 256)
    assert trace.COUNTS.get("launch.furthest_point_sample", 0) == before + 1
    want = group_ops.furthest_point_sample_plain(xyz.to(cuda), mask.to(cuda), 256)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.cpu().numpy(), P.fps(xyz, mask, 256).numpy())


# --------------------------------------------------------------------- VSA

def test_vsa_matches_plain():
    """The VSA at PV-RCNN's source settings (BEV, raw points, x_conv1-4,
    OpenPCDet's order, fusion BN) on the micro forward's levels and BEV map:
    keypoints exact, features before and after the fusion 1e-4."""
    r = _micro()
    b, cfg = r["batch"], r["cfg"]
    pts = b["points"]
    kp, before, after = P.vsa(pts, b["points_mask"], _plain_levels(r["levels"]), r["bev"],
                              r["sd"], cfg.MODEL.PFE, cfg.DATA_CONFIG.POINT_CLOUD_RANGE,
                              [0.2, 0.2, 0.1])
    out = r["out"]
    np.testing.assert_array_equal(out["keypoints"].numpy(), kp.numpy())
    close(out["point_features_before_fusion"], before, "before fusion")
    close(out["point_features"], after, "after fusion")
    assert before.shape[-1] == r["net"].pfe.num_features_before_fusion
    assert float(before.abs().max()) > 0.1 and float(after.abs().max()) > 0.1


def test_vsa_per_frame_grouping_equals_whole_table():
    """Each level's SA on its per-frame slots (the VSA's grouping) gives
    the whole-table query's output, every frame's keypoints against the
    batch's table with a per-frame mask, to the bit, on a batch whose
    frames hold different numbers of rows."""
    r = _micro()
    vsa, levels, B = r["net"].pfe, r["levels"], 2
    kp, kmask = r["out"]["keypoints"], r["out"]["keypoint_mask"]
    tables = vsa._level_tables(levels, B)
    rows = [int((levels[n].coords[:, 0] == f).sum()) for n in vsa.levels for f in range(B)]
    assert len(set(rows)) > len(vsa.levels), rows                      # frames differ
    with torch.no_grad(), common.float32_everywhere():
        for name, sa, (xyz, feats, mask) in zip(vsa.levels, vsa.SA_layers, tables):
            st = levels[name]
            centers = common.get_voxel_centers(st.coords[:, 1:4], 2 ** (int(name[-1]) - 1),
                                               vsa.voxel_size, vsa.point_cloud_range)
            frames = torch.arange(B)[:, None]
            sup = (st.coords[None, :, 0] == frames) & st.valid[None, :]
            whole = sa(centers[None].expand(B, -1, -1), sup, kp, kmask,
                       features=st.features[None].expand(B, -1, -1))
            grouped = sa(xyz, mask, kp, kmask, features=feats)
            assert torch.equal(grouped, whole), name


# ---------------------------------------------------------- point head

def test_point_head_matches_plain():
    r = _micro()
    logits, scores = P.point_head(r["out"]["point_features_before_fusion"], r["sd"], 2)
    close(r["out"]["point_cls_preds"], logits, "logits")
    close(r["out"]["point_cls_scores"], scores, "scores")


def test_point_head_dtype():
    """Hidden linears in the compute dtype, logits and scores in float32."""
    head = PointHeadSimple(1, 12, (8, 8), compute_dtype=torch.bfloat16).eval()
    logits, scores = head(torch.randn(2, 5, 12))
    assert logits.dtype == scores.dtype == torch.float32
    assert logits.shape == (2, 5, 1) and scores.shape == (2, 5)


# ------------------------------------------------------------- roi head

def test_pvrcnn_head_matches_plain_with_an_empty_roi():
    """PVRCNNHead on the micro forward's keypoints, features and scores,
    its rois with one moved far from every keypoint (each of its grid
    balls empty: they pool the MLP of zeros, as OpenPCDet's stack SA does)
    and one invalid: rcnn cls / reg 1e-4 on the valid rois (an invalid
    roi's outputs are the program's padding, read by nothing), the empty
    balls tallied."""
    r = _micro()
    out, sd, cfg = r["out"], r["sd"], r["cfg"]
    rois, valid = out["rois"].clone(), out["roi_valid"].clone()
    rois[0, 0] = torch.tensor([60.0, 30.0, 0.0, 3.9, 1.6, 1.5, 0.3])
    valid[0, 0], valid[1, 1] = True, False
    head = r["net"].roi_head
    trace.enable()
    with torch.no_grad(), common.float32_everywhere():
        pooled = head.roi_grid_pool(rois, valid, out["keypoints"], out["keypoint_mask"],
                                    out["point_features"], out["point_cls_scores"])
        cls, reg = head(pooled, valid)
    rec = trace.disable()
    want_cls, want_reg = P.pvrcnn_head(rois, valid, out["keypoints"], out["keypoint_mask"],
                                       out["point_features"], out["point_cls_scores"], sd,
                                       cfg.MODEL.ROI_HEAD)
    v = valid.reshape(-1)
    close(cls[v], want_cls[v], "rcnn_cls")
    close(reg[v], want_reg[v], "rcnn_reg")
    G = head.grid_size ** 3
    empty = np.sum(rec.tallies["roi_grid.balls_empty"], axis=0)
    balls = np.sum(rec.tallies["roi_grid.balls"], axis=0)
    assert empty[0] >= 2 * G and balls.tolist() == (valid.sum(1) * 2 * G).tolist()
    assert float(pooled[0, :G].abs().max()) > 0                       # MLP of zeros, pooled


def test_roi_decode_matches_plain():
    r = _micro()
    out = r["out"]
    want = P.decode(out["rois"], out["rcnn_reg"])
    close(out["batch_box_preds"], want, "decoded boxes")
    assert out["batch_box_preds"].dtype == torch.float32


def test_grid_points_are_x_major():
    """The head's grid points in OpenPCDet's order (x slowest), each
    within one rounding of OpenPCDet's (i + 0.5) / g * size - size / 2."""
    head = PVRCNNHead(1, 4, grid_size=3, mlps=((4,),), radii=(0.8,), nsamples=(4,),
                      shared_fc=(8,), cls_fc=(8,), reg_fc=(8,))
    roi = torch.tensor([[[10.0, -2.0, -1.0, 3.9, 1.6, 1.5, 0.7]]])
    got = head.grid_points(roi)[0, 0]
    close(got, P.roi_grid(roi[0, 0], 3), "grid points")


# ---------------------------------------------------------- whole forward

def test_eval_forward_matches_plain():
    """One whole eval forward of the micro PV-RCNN: every stage after the
    backbone against the plain reference fed the same inputs (the
    backbone's levels and BEV map, the forward's proposals), and the final
    NMS's detections."""
    r = _micro()
    out, sd, cfg, b = r["out"], r["sd"], r["cfg"], r["batch"]
    kp, before, after = P.vsa(b["points"], b["points_mask"], _plain_levels(r["levels"]),
                              r["bev"], sd, cfg.MODEL.PFE, cfg.DATA_CONFIG.POINT_CLOUD_RANGE,
                              [0.2, 0.2, 0.1])
    _, scores = P.point_head(before, sd, 2)
    cls, reg = P.pvrcnn_head(out["rois"], out["roi_valid"], kp, out["keypoint_mask"], after,
                             scores, sd, cfg.MODEL.ROI_HEAD)
    v = out["roi_valid"]
    close(out["rcnn_cls"][v.reshape(-1)], cls[v.reshape(-1)], "rcnn_cls")
    close(out["rcnn_reg"][v.reshape(-1)], reg[v.reshape(-1)], "rcnn_reg")
    close(out["batch_box_preds"][v], P.decode(out["rois"], reg)[v], "boxes")
    assert out["roi_valid"].any() and out["roi_labels"].min() >= 1
    post = post_processing(out, cfg.MODEL.POST_PROCESSING, 3, "cpu")
    assert post["pred_valid"].any()
    kept = post["pred_labels"][post["pred_valid"]]
    assert kept.min() >= 1 and kept.max() <= 3


def test_recorded_forward_stages_readbacks_and_tallies():
    """A recorded eval forward and its final NMS open the nine stages in
    order, read back once for the VSA's level rows, tally the valid
    keypoints a frame and the grid balls a radius."""
    r = _micro()
    net, cfg, b = r["net"], r["cfg"], r["batch"]
    trace.enable()
    with common.float32_everywhere():
        post_processing(net(b), cfg.MODEL.POST_PROCESSING, 3, "cpu")
    rec = trace.disable()
    names = [s[0] for s in rec.spans if s[0] in D.STAGES]
    assert names == list(D.STAGES)
    assert rec.sync_counts().get("vsa.level_rows") == 1
    assert rec.tally("vsa.keypoints_valid").tolist() == [64, 64]
    assert len(rec.tallies["roi_grid.balls"]) == 2
    G = net.roi_head.grid_size ** 3
    assert rec.tally("roi_grid.balls").tolist() == (r["out"]["roi_valid"].sum(1) * 2 * G).tolist()
    assert (rec.tally("roi_grid.balls_empty") <= rec.tally("roi_grid.balls")).all()


# --------------------------------------------------------- the network

def test_build_network_dispatches_on_model_name():
    pv = micro_pv_rcnn_cfg()
    assert isinstance(build_network(pv.MODEL, pv.DATA_CONFIG, list(pv.CLASS_NAMES),
                                    device="cpu"), PVRCNN)
    from btcdet_tpu_torch.datasets.mini_config import micro_data_cfg

    assert isinstance(build_network(micro_model_cfg(with_occ=False),
                                    micro_data_cfg(with_occ=False), ["Car"], device="cpu"),
                      BtcNet)
    pv.MODEL.NAME = "PointRCNN"
    with pytest.raises(KeyError, match="PointRCNN"):
        build_network(pv.MODEL, pv.DATA_CONFIG, list(pv.CLASS_NAMES), device="cpu")


def test_train_mode_is_refused():
    cfg = micro_pv_rcnn_cfg()
    net = build_network(cfg.MODEL, cfg.DATA_CONFIG, list(cfg.CLASS_NAMES), device="cpu")
    with pytest.raises(NotImplementedError, match="train runner"):
        net.train()


def test_state_dict_names_at_published_widths():
    """OpenPCDet's PVRCNN module names, at the published widths: the VSA's
    640 features before the fusion, its Linear 640 -> 128 and BN, the point
    head's 640 -> 256 -> 256 -> 1, the grid pool's 131 -> 64 -> 64 at two
    radii and the shared FC's 6^3 * 128 = 27 648 -> 256."""
    cfg = pv_rcnn()
    net = build_network(cfg.MODEL, cfg.DATA_CONFIG, list(cfg.CLASS_NAMES), device="cpu")
    sd = net.state_dict()
    assert {k.split(".")[0] for k in sd} == {"backbone_3d", "pfe", "backbone_2d", "dense_head",
                                             "point_head", "roi_head"}
    shapes = {
        "pfe.vsa_point_feature_fusion.0.weight": (128, 640),
        "pfe.vsa_point_feature_fusion.1.running_var": (128,),
        "pfe.SA_rawpoints.mlps.0.0.weight": (16, 4, 1, 1),
        "pfe.SA_layers.0.mlps.1.3.weight": (16, 16, 1, 1),
        "pfe.SA_layers.3.mlps.0.0.weight": (64, 67, 1, 1),
        "point_head.cls_layers.0.weight": (256, 640),
        "point_head.cls_layers.6.weight": (1, 256),
        "roi_head.roi_grid_pool_layer.mlps.1.0.weight": (64, 131, 1, 1),
        "roi_head.shared_fc_layer.0.weight": (256, 27648, 1),
        "roi_head.reg_layers.7.weight": (7, 256, 1),
        "backbone_3d.conv4.0.0.weight": (3, 3, 3, 64, 64),
        "backbone_3d.conv_out.0.weight": (3, 1, 1, 64, 128),
        "backbone_2d.deblocks.1.0.weight": (256, 256, 2, 2),
    }
    assert {k: tuple(sd[k].shape) for k in shapes} == shapes
    assert net.pfe.num_features_before_fusion == 640
    assert net.backbone_3d.level_caps["test"] == (32000, 20000, 10000, 8000)
