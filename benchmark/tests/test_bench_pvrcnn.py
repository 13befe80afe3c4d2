"""The PV-RCNN eval cell (`arch/pvrcnn.py`, `reference/pvref`) on the CPU
at the port's micro PV-RCNN config (`mini_config.micro_pv_rcnn_cfg`),
through `evalcell.run`, held to `limits/pv_rcnn.eval_b8.json`: a sound run
is correct on exactly its 11 numbers, the control (the reference in float8,
decodes in bfloat16) fails every "rel" and "box" number, and three planted
faults each fail theirs; the FPS work count and `fps_roofline.eval` on a
hand-made trace."""

import json
import time
from pathlib import Path

import pytest
import torch

from benchmark.lib import evalcell
from benchmark.lib.layers import Layers
from benchmark.lib.spec import arch_module, metric_reader
from benchmark.reference.pvref import stages as pstages
from benchmark.tests.test_bench_trace import Ev
from benchmark.lib.trace import Trace
from benchmark.work import counts, pvrcnn as pwork

BENCH = Path(__file__).resolve().parent.parent
TRAFFIC = {"kind": "eval", "batch_size": 2, "pool": 2, "num_points": 2048,
           "gt": {"Car": 1, "Pedestrian": 1, "Cyclist": 1}, "mode": "test", "scene_seed": 7,
           "weight_seed": 2}
LIMITS = {k: v["limit"] for k, v in
          json.loads((BENCH / "limits" / "pv_rcnn.eval_b8.json").read_text()).items()}
NUMBERS = ["backbone", "backbone_sites", "keypoints", "vsa", "point_head", "rpn", "rpn_boxes",
           "proposals", "rcnn", "rcnn_boxes", "final"]


def _micro() -> dict:
    pytest.importorskip("btcdet_tpu_torch")
    from btcdet_tpu_torch.datasets.mini_config import micro_pv_rcnn_cfg

    return json.loads(json.dumps(micro_pv_rcnn_cfg()))


def _run(seed=2**31 + 45, control=False):
    return evalcell.run(_micro(), TRAFFIC, seed, 0.5, False, torch.device("cpu"),
                        time.perf_counter(), LIMITS, control=control)


def _failing(res):
    return sorted(k for k, v in res["checks"].items() if not v["value"] <= v["limit"])


def test_sound_run_is_correct_on_its_eleven_numbers():
    cfg = _micro()
    assert arch_module(cfg).check_names(cfg) == NUMBERS == list(LIMITS)
    res = _run(control=True)
    assert list(res["checks"]) == NUMBERS
    assert res["correct"], res["checks"]
    # the control fails every rel and box number
    ctl = res["control"]
    kinds = dict(pstages.KINDS, rcnn_boxes="box", final="count")
    for k, kind in kinds.items():
        if kind != "count":
            assert not ctl[k] <= LIMITS[k], (k, ctl[k])


def _keypoints_shifted(monkeypatch):
    """Every keypoint one index on from the one FPS picked."""
    from btcdet_tpu_torch.ops import group_ops

    orig = group_ops.furthest_point_sample

    def fps(xyz, mask, npoint):
        return (orig(xyz, mask, npoint) + 1) % xyz.shape[1]

    monkeypatch.setattr(group_ops, "furthest_point_sample", fps)


def _scores_not_applied(monkeypatch):
    """The RoI-grid pool reads the keypoint features without the point
    head's scores."""
    from btcdet_tpu_torch.models.roi_heads import pvrcnn_head

    orig = pvrcnn_head.PVRCNNHead.roi_grid_pool

    def pool(self, rois, roi_valid, keypoints, kp_mask, feats, scores):
        return orig(self, rois, roi_valid, keypoints, kp_mask, feats, torch.ones_like(scores))

    monkeypatch.setattr(pvrcnn_head.PVRCNNHead, "roi_grid_pool", pool)


def _scores_without_sigmoid(monkeypatch):
    """The point head's scores are its largest logit, not its sigmoid."""
    from btcdet_tpu_torch.models.dense_heads import point_head_simple

    orig = point_head_simple.PointHeadSimple.forward

    def forward(self, point_features):
        logits, _ = orig(self, point_features)
        return logits, logits.max(dim=-1).values

    monkeypatch.setattr(point_head_simple.PointHeadSimple, "forward", forward)


@pytest.mark.parametrize("fault, number", [(_keypoints_shifted, "keypoints"),
                                           (_scores_not_applied, "rcnn"),
                                           (_scores_without_sigmoid, "rcnn")],
                         ids=["keypoints_shifted", "scores_not_applied",
                              "scores_without_sigmoid"])
def test_planted_fault_is_not_correct(monkeypatch, fault, number):
    fault(monkeypatch)
    res = _run()
    assert not res["correct"], res["checks"]
    assert number in _failing(res), res["checks"]


def test_fps_work_by_hand():
    # 2 frames, 5 picks, 7 valid points of 8 slots: 4 steps of 10 ops a valid point
    ops, nbytes = pwork.fps_work(frames=2, keypoints=5, valid_points=7, points=8)
    assert ops == 4 * 7 * 10
    assert nbytes == 8 * 3 * 4 + 2 * 5 * 8


def test_work_recorder_logs_the_references_sampling():
    from benchmark.reference.btcref.ops import group_ops

    mask = torch.tensor([[True, True, False, True], [True, False, False, False]])
    rec = pwork.WorkRecorder()
    with rec:
        idx = group_ops.furthest_point_sample(torch.randn(2, 4, 3), mask, 3)
    assert rec.fps == [(2, 3, 4, 8)] and idx.shape == (2, 3)
    assert group_ops.furthest_point_sample.__name__ == "furthest_point_sample"


def _fps_trace():
    """Two batches (pool entries 0 and 1) whose `vsa` spans launched a 10
    and an 8 ms FPS kernel and a 5 ms other kernel each. The FPS kernels
    link to no host op: their own ids collide with host events of the other
    batch."""
    ms = 1_000_000
    return Trace([
        Ev("bench.batch.0", 0, 100 * ms, "user_annotation", 1),
        Ev("vsa", 10 * ms, 40 * ms, "user_annotation", 2),
        Ev("aten::mm", 12 * ms, 13 * ms, "cpu_op", 3),
        Ev("bench.batch.1", 200 * ms, 300 * ms, "user_annotation", 4),
        Ev("vsa", 210 * ms, 240 * ms, "user_annotation", 5),
        Ev("aten::mm", 212 * ms, 213 * ms, "cpu_op", 6),
        Ev("void (anonymous namespace)::fps_kernel<16, true>(...)", 20 * ms, 30 * ms,
           "kernel", 6, 0),
        Ev("gemm", 31 * ms, 36 * ms, "kernel", 901, 3),
        Ev("(anonymous namespace)::fps_kernel_large(...)", 220 * ms, 228 * ms, "kernel", 3, 0),
        Ev("gemm", 231 * ms, 236 * ms, "kernel", 902, 6)], ("vsa",))


def test_fps_roofline_on_a_hand_made_trace():
    """The last entry's FPS kernel ran 8 ms, the reference's sampling of 8
    frames x 16 384 points, 2048 picks: the least time over the kernel's,
    in (0, 100], its batch found by time despite the colliding id."""
    t = _fps_trace()
    layers = Layers.__new__(Layers)
    layers.t, layers.last, layers.n_by_entry = t, 1, t.batches_by_entry()
    layers.rec = pwork.WorkRecorder()
    layers.rec.fps = [(8, 2048, 8 * 16384, 8 * 16384)]
    assert pwork.fps_seconds_by_batch(t) == pytest.approx({0: 0.010, 1: 0.008})
    share = metric_reader("fps_roofline.eval")(layers)
    least = counts.least_seconds(*pwork.fps_work(8, 2048, 8 * 16384, 8 * 16384),
                                 counts.PEAK_F32)
    assert share == pytest.approx(100.0 * least / 0.008) and 0 < share <= 100
    assert metric_reader("vsa_dev_ms.eval")(layers) == pytest.approx(14.0)
    layers.rec.fps = []
    assert metric_reader("fps_roofline.eval")(layers) is None
