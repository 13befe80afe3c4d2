"""The comparison that decides `correct`, against planted faults.

A whole eval run on the CPU at the micro config (the harness's look for
a chip skipped), held to the car cell's limits: a sound run is correct,
and each fault planted in the timed path underneath makes it not
correct. A second test holds the control (the reference in float8 in
the program's place) to the same limits."""

import json
from pathlib import Path

import pytest
import torch

from benchmark.lib import evalcell
from benchmark.lib.spec import load_config

HERE = Path(__file__).resolve().parent
TRAFFIC = {"kind": "eval", "batch_size": 2, "pool": 2, "num_points": 2048, "gt": {"Car": 2},
           "mode": "test", "scene_seed": 7, "weight_seed": 2}
LIMITS = {k: v["limit"] for k, v in
          json.loads((HERE.parent / "limits" / "car.eval_b8.json").read_text()).items()}


def _run(seed=2**31 + 21, control=False):
    pytest.importorskip("btcdet_tpu_torch")
    import time

    return evalcell.run(load_config(HERE / "micro.json"), TRAFFIC, seed, 0.5, False,
                        torch.device("cpu"), time.perf_counter(), LIMITS, control=control)


def _failing(res):
    return sorted(k for k, v in res["checks"].items() if not v["value"] <= v["limit"])


def test_sound_run_is_correct():
    res = _run()
    assert res["correct"], res["checks"]


def _alter_answer(monkeypatch):
    """A detection altered where it is produced: frame 0's boxes move 0.5 m."""
    from btcdet_tpu_torch.models.detectors import btcnet

    orig = btcnet.post_processing

    def post(*a, **kw):
        out = orig(*a, **kw)
        out["pred_boxes"][0, :, 0] += 0.5
        return out

    monkeypatch.setattr(btcnet, "post_processing", post)


def _half_batch(monkeypatch):
    """Half of the batch left out of ConvHead: the rois of the second half
    of the frames get the first half's refinement."""
    from btcdet_tpu_torch.models.roi_heads import conv_head

    orig = conv_head.ConvHead.forward

    def forward(self, rois, *a, **kw):
        cls, reg = orig(self, rois, *a, **kw)
        half = cls.shape[0] // 2
        return torch.cat([cls[:half], cls[:half]]), torch.cat([reg[:half], reg[:half]])

    monkeypatch.setattr(conv_head.ConvHead, "forward", forward)


def _stale_stage(monkeypatch):
    """A stage that returns its input's state: the BEV pyramid skipped
    (its input map, cut to its output's channels, passed on)."""
    from btcdet_tpu_torch.models import backbones_2d

    orig = backbones_2d.BaseBEVBackbone.forward

    def forward(self, x, *a, **kw):
        y = orig(self, x, *a, **kw)
        return x[:, :y.shape[1]].to(y.dtype) if x.shape[1] >= y.shape[1] else torch.zeros_like(y)

    monkeypatch.setattr(backbones_2d.BaseBEVBackbone, "forward", forward)


def _wrong_direction_head(monkeypatch):
    """A wrong direction head: the RPN's direction logits negated where
    they are produced, and the boxes decoded with them (headings flipped
    by pi wherever the bins differ)."""
    from btcdet_tpu_torch.models.dense_heads import anchor_head

    orig = anchor_head.AnchorHeadSingle.forward

    def forward(self, x):
        out = orig(self, x)
        out["dir_preds"] = -out["dir_preds"]
        out["batch_box_preds"] = self._decode(out["box_preds"], out["dir_preds"])
        return out

    monkeypatch.setattr(anchor_head.AnchorHeadSingle, "forward", forward)


def _rpn_decode_flipped(monkeypatch):
    """The RPN's anchor decode off by pi in the heading."""
    from btcdet_tpu_torch.models.dense_heads import anchor_head

    orig = anchor_head.AnchorHeadSingle._decode

    def decode(self, box_preds, dir_preds):
        boxes = orig(self, box_preds, dir_preds)
        return torch.cat([boxes[..., :6], boxes[..., 6:7] + torch.pi, boxes[..., 7:]], dim=-1)

    monkeypatch.setattr(anchor_head.AnchorHeadSingle, "_decode", decode)


def _rcnn_decode_shifted(monkeypatch):
    """ConvHead's residual decode with its centres 0.2 m off in x."""
    from btcdet_tpu_torch.models.roi_heads import conv_head

    orig = conv_head.ConvHead.generate_predicted_boxes

    def decode(self, rois, rcnn_cls, rcnn_reg):
        cls, boxes = orig(self, rois, rcnn_cls, rcnn_reg)
        return cls, torch.cat([boxes[..., :1] + 0.2, boxes[..., 1:]], dim=-1)

    monkeypatch.setattr(conv_head.ConvHead, "generate_predicted_boxes", decode)


@pytest.mark.parametrize("fault", [_alter_answer, _half_batch, _stale_stage,
                                   _wrong_direction_head, _rpn_decode_flipped,
                                   _rcnn_decode_shifted],
                         ids=["answer_altered", "half_batch", "stale_stage",
                              "wrong_direction_head", "rpn_decode_flipped",
                              "rcnn_decode_shifted"])
def test_planted_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    res = _run()
    assert not res["correct"], res["checks"]
    assert _failing(res)


def test_control_is_not_correct():
    res = _run(control=True)
    ctl = res["control"]
    assert any(not ctl[k] <= LIMITS[k] for k in ctl), ctl
    # the box decodes' control (bfloat16) fails their own numbers
    assert not ctl["rpn_boxes"] <= LIMITS["rpn_boxes"], ctl
    assert not ctl["rcnn_boxes"] <= LIMITS["rcnn_boxes"], ctl
