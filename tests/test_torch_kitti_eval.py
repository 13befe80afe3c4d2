"""The port's official KITTI AP (`btcdet_tpu_torch/eval/kitti_eval.py`)
against the JAX package's on the same annotations: every key of the
result dict to 1e-4, the per-image overlap matrices to 1e-6, and the
port's C++ statistics core equal to its numpy twin."""

import copy

import numpy as np
import pytest
from test_kitti_eval import make_annos

from btcdet_tpu.eval import kitti_eval as JE
from btcdet_tpu_torch.eval import kitti_eval as TE


def _jittered(seed, n_img=20):
    """Near-miss detections: small shifts, turns and score noise, plus a
    false positive per image, so overlaps cross the 0.5 / 0.7 thresholds
    and the AOS similarity is not trivial."""
    rng = np.random.RandomState(seed)
    gt, dt = make_annos(rng, n_img=n_img, perfect=True)
    for g, d in zip(gt, dt):
        n = len(d["name"])
        d["location"] += rng.normal(0, 0.25, (n, 3))
        d["dimensions"] *= rng.uniform(0.9, 1.1, (n, 3))
        d["rotation_y"] += rng.normal(0, 0.3, n)
        d["alpha"] = d["rotation_y"].copy()
        d["bbox"] += rng.normal(0, 8, (n, 4))
        for k, v in {"name": "Car", "truncated": 0.0, "occluded": 0.0, "alpha": 0.3,
                     "rotation_y": 0.3, "score": 0.4}.items():
            d[k] = np.append(d[k], v)
        d["bbox"] = np.vstack([d["bbox"], [100, 100, 180, 170]])
        d["location"] = np.vstack([d["location"], [0, 1, 20]])
        d["dimensions"] = np.vstack([d["dimensions"], [4, 1.5, 1.6]])
        g["occluded"] = rng.randint(0, 3, len(g["name"])).astype(float)
    return gt, dt


def _case(name):
    if name == "perfect":
        return make_annos(np.random.RandomState(0), n_img=60, perfect=True) + (None,)
    if name == "empty":
        return make_annos(np.random.RandomState(1), n_img=6, perfect=False) + (None,)
    if name == "shifted":
        gt, dt = make_annos(np.random.RandomState(2), n_img=12, perfect=True)
        for d in dt:
            k = len(d["name"]) // 2
            d["location"][:k, 0] += 10.0
            d["bbox"][:k, 0] += 500
            d["bbox"][:k, 2] += 500
        return gt, dt, None
    if name == "jittered":
        return _jittered(5) + (None,)
    if name == "coverage":
        rng = np.random.RandomState(3)
        gt, dt = make_annos(rng, n_img=40, perfect=True)
        for g in gt:
            g["coverage_rates"] = rng.uniform(0.0, 1.0, (len(g["name"]), 1))
        return gt, dt, [[0.0, 0.3], [0.3, 0.7], [0.7, 1.01]]
    raise ValueError(name)


CASES = ("perfect", "empty", "shifted", "jittered", "coverage")


@pytest.mark.parametrize("name", CASES)
def test_official_result_matches(name):
    gt, dt, cov = _case(name)
    _, got, got_details = TE.get_official_eval_result(copy.deepcopy(gt), copy.deepcopy(dt),
                                                      ["Car"], coverage_rates=cov)
    _, want, want_details = JE.get_official_eval_result(gt, dt, ["Car"], coverage_rates=cov)
    assert got.keys() == want.keys() and len(got) >= 12
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= 1e-4, (k, got[k], want[k])
    assert got_details.keys() == want_details.keys()
    for kind in want_details:
        for diff, curves in want_details[kind]["Car"].items():
            for c, v in curves.items():
                np.testing.assert_allclose(got_details[kind]["Car"][diff][c], v, atol=1e-4)
    if name == "perfect":
        assert got["Car_3d/easy_R40"] > 97.0
    if name == "empty":
        assert got["Car_3d/moderate_R40"] == 0.0


@pytest.mark.parametrize("metric", [0, 1, 2], ids=["bbox", "bev", "3d"])
def test_overlaps_match(metric):
    gt, dt = _jittered(7, n_img=8)
    got = TE.calculate_iou(gt, dt, metric)
    want = JE.calculate_iou(gt, dt, metric)
    assert len(got) == len(want) == 8
    assert sum(int((w > 0.5).sum()) for w in want) > 0
    for g, w in zip(got, want):
        assert g.dtype == np.float64 and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["jittered", "shifted"])
def test_native_statistics_equal_the_numpy_twin(name, monkeypatch):
    """Every call the metric makes to the C++ core gives exactly what the
    numpy twin gives on the same inputs."""
    gt, dt, cov = _case(name)
    for g in gt:  # a dontcare box per image exercises the absorption
        for k, v in {"name": "DontCare", "truncated": 0.0, "occluded": 0.0, "alpha": 0.0,
                     "rotation_y": 0.0}.items():
            g[k] = np.append(g[k], v)
        g["bbox"] = np.vstack([g["bbox"], [95, 95, 190, 175]])
        g["location"] = np.vstack([g["location"], [0, 1, 30]])
        g["dimensions"] = np.vstack([g["dimensions"], [4, 1.5, 1.6]])
    native = TE.compute_statistics
    calls = []

    def both(*args, **kw):
        a = native(*args, **kw)
        b = TE.compute_statistics_plain(*args, **kw)
        assert a[:4] == b[:4], (a[:4], b[:4])
        np.testing.assert_array_equal(a[4], b[4])
        calls.append(kw.get("compute_aos", False))
        return a

    monkeypatch.setattr(TE, "compute_statistics", both)
    TE.get_official_eval_result(gt, dt, ["Car"], coverage_rates=cov)
    assert len(calls) > 100 and any(calls)
