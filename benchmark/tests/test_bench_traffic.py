"""The frozen traffic generator: car frames equal the stored digest of
the port's synthetic frames, and the class-mixed gt follows its anchors."""

import json
from pathlib import Path

import numpy as np
import pytest

from benchmark.lib.spec import load_config
from benchmark.traffic import generator as G

HERE = Path(__file__).resolve().parent
CONFIGS = HERE.parent / "configs"


def test_car_frames_match_stored_digest():
    cfg = load_config(CONFIGS / "car.json")
    want = json.loads((HERE / "traffic_digests.json").read_text())["car_b2_seed0"]
    assert G.digest(G.make_batch(cfg, 2, 16384, {"Car": 10}, 0, "test")) == want


def test_car_frames_match_port_generator():
    synthetic = pytest.importorskip("btcdet_tpu_torch.datasets.synthetic")
    from btcdet_tpu_torch.config import EasyDict

    cfg = load_config(CONFIGS / "car.json")
    port = synthetic.make_synthetic_batch_np(EasyDict(cfg["DATA_CONFIG"]), 2, 16384, 10, 3,
                                             "test")
    assert G.digest(G.make_batch(cfg, 2, 16384, {"Car": 10}, 3, "test")) == G.digest(port)


def test_mixed_classes_take_anchor_sizes():
    cfg = load_config(CONFIGS / "three_class.json")
    b = G.make_batch(cfg, 2, 4096, {"Car": 4, "Pedestrian": 4, "Cyclist": 2}, 11, "test")
    gt = b["gt_boxes"]
    assert gt.shape == (2, 10, 8)
    np.testing.assert_array_equal(gt[0, :, 7], [1] * 4 + [2] * 4 + [3] * 2)
    sizes = [a["anchor_sizes"][0] for a in cfg["MODEL"]["DENSE_HEAD"]["ANCHOR_GENERATOR_CONFIG"]]
    for lab in (2, 3):
        d = gt[:, :, 3:6][gt[:, :, 7] == lab]
        ratio = d / np.asarray(sizes[lab - 1], np.float32)
        assert ((ratio > 0.89) & (ratio < 1.11)).all(), ratio
        z = gt[:, :, 2][gt[:, :, 7] == lab]
        np.testing.assert_allclose(z, G.GROUND_Z + d[:, 2] / 2, atol=1e-5)


def test_split_and_collate_round_trip():
    cfg = load_config(CONFIGS / "car.json")
    b = G.make_batch(cfg, 3, 2048, {"Car": 2}, 5, "test")
    assert G.digest(G.collate(G.split_frames(b, 3))) == G.digest(b)


def test_scene_seed_deals_the_same_frames_to_every_seed():
    cfg = load_config(CONFIGS / "car.json")
    t = {"batch_size": 2, "pool": 2, "num_points": 2048, "gt": {"Car": 2}, "mode": "test",
         "scene_seed": 0}
    assert [G.digest(b) for b in G.make_pool(cfg, t, 2**31 + 1)] == \
        [G.digest(b) for b in G.make_pool(cfg, t, 2**31 + 1)]
    frames = {}
    for seed in (2**31 + 1, 2**31 + 2):
        pool = G.make_pool(cfg, t, seed)
        got = [G.digest(f) for b in pool for f in G.split_frames(b, 2)]
        frames[seed] = got
        for b in pool:
            c = b["det_voxel_coords"]
            assert set(c[c[:, 0] >= 0, 0]) <= {0, 1}
    assert sorted(frames[2**31 + 1]) == sorted(frames[2**31 + 2])
    assert frames[2**31 + 1] != frames[2**31 + 2]


def test_run_scene_seed_draws_the_frames_from_the_run_seed():
    cfg = load_config(CONFIGS / "car.json")
    t = {"batch_size": 2, "pool": 1, "num_points": 2048, "gt": {"Car": 2}, "mode": "test",
         "scene_seed": "run"}
    a, b = (G.make_pool(cfg, t, s)[0] for s in (2**31 + 1, 2**31 + 2))
    assert G.digest(a) == G.digest(G.make_pool(cfg, t, 2**31 + 1)[0])
    assert sorted(G.digest(f) for f in G.split_frames(a, 2)) != \
        sorted(G.digest(f) for f in G.split_frames(b, 2))
