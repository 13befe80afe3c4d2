"""The port's eval loop (`train/eval_utils.eval_one_epoch`) against the JAX
package's on a synthetic KITTI tree, with the micro model: one run per
package (the JAX side in float32 with exact ball queries), the same
weights carried across. Per frame the same detections (count exact, boxes
and scores to 1e-4), the same KITTI annos, the official AP and the occ
statistics to 1e-4, and the recall counts exactly."""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import RTOL, f32_mode, full_micro_cfgs, init_jax, perturb_variables

from btcdet_tpu.config import EasyDict
from btcdet_tpu.datasets.kitti import kitti_infos as JI
from btcdet_tpu.datasets.kitti.kitti_dataset import KittiDataset as JaxKitti
from btcdet_tpu.datasets.loader import PyLoader
from btcdet_tpu.datasets.synthetic_kitti import make_raw_kitti
from btcdet_tpu.models import build_network as jax_build
from btcdet_tpu.train import eval_utils as JU
from btcdet_tpu_torch import config as tcfg
from btcdet_tpu_torch import weights
from btcdet_tpu_torch.datasets.kitti import kitti_infos as TI
from btcdet_tpu_torch.datasets.kitti.kitti_dataset import KittiDataset
from btcdet_tpu_torch.datasets.loader import make_loader
from btcdet_tpu_torch.models import build_network
from btcdet_tpu_torch.train import eval_utils as TU

N_FRAMES, N_TRAIN, BATCH = 6, 2, 2
# low thresholds too: random weights put few boxes near a gt
RECALL_THRESH = (0.0, 0.05, 0.1, 0.3, 0.5, 0.7)


def kitti_micro_data_cfg(root, data_cfg):
    """The micro data config reading a KITTI tree: points outside the 6.4 m
    scene are dropped first, and a frame holds at most 2048 points."""
    d = copy.deepcopy(dict(data_cfg))
    d.update({"DATASET": "KittiDataset", "DATA_PATH": str(root),
              "DATA_SPLIT": {"train": "train", "test": "val"},
              "INFO_PATH": {"train": ["kitti_infos_train.pkl"], "test": ["kitti_infos_val.pkl"]},
              "FOV_POINTS_ONLY": False, "MAX_POINTS_PER_FRAME": 2048, "MAX_GT_BOXES": 4})
    d["DATA_PROCESSOR"] = [{"NAME": "mask_points_and_boxes_outside_range",
                            "REMOVE_OUTSIDE_BOXES": True}] + list(d["DATA_PROCESSOR"])
    return EasyDict(d)


@functools.cache
def runs(root):
    """(JAX run, port run): each (result_str, result_dict, det_annos, recall)."""
    data_cfg, model_cfg = full_micro_cfgs()
    dcfg = kitti_micro_data_cfg(root, data_cfg)
    post_cfg = model_cfg.POST_PROCESSING
    out = {}
    with f32_mode():
        ds = JaxKitti(dcfg, ["Car"], training=False, root_path=root)
        loader = PyLoader(ds, BATCH, collate_fn=ds.collate_batch)
        first = {k: v for k, v in next(iter(loader)).items() if k != "frame_id"}
        net = jax_build(model_cfg, dcfg, ["Car"])
        variables = perturb_variables(init_jax(net, first))
        cls = variables["params"]["occ_subnet"]["conv_cls"]
        cls["bias"] = np.zeros_like(cls["bias"])
        variables = jax.tree_util.tree_map(jnp.asarray, variables)
        recall = {}
        orig = JU.recall_record

        def counting(*a):
            rec = orig(*a)
            for k, v in rec.items():
                recall[k] = recall.get(k, 0) + v
            return rec

        JU.recall_record = counting
        try:
            out["jax"] = JU.eval_one_epoch(net, variables, loader, ds, post_cfg, ["Car"],
                                           recall_thresh_list=RECALL_THRESH) + (
                recall,)
        finally:
            JU.recall_record = orig

        tdcfg, tmcfg = tcfg.EasyDict(dcfg), tcfg.EasyDict(model_cfg)
        tds = KittiDataset(tdcfg, ["Car"], training=False, root_path=root)
        port = build_network(tmcfg, tdcfg, ["Car"], device="cpu")
        port.load_state_dict(weights.from_jax_variables(
            jax.tree_util.tree_map(np.asarray, variables), dp_ratio=tmcfg.ROI_HEAD.DP_RATIO,
            upsample_strides=tmcfg.BACKBONE_2D.UPSAMPLE_STRIDES),
            strict=True)
        tl = make_loader(tds, BATCH, collate_fn=tds.collate_batch)
        res = TU.eval_one_epoch(port, tl, tds, tcfg.EasyDict(post_cfg), ["Car"],
                                recall_thresh_list=RECALL_THRESH)
        out["port"] = res + (res[1]["recall"],)
    return out["jax"], out["port"]


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti_micro")
    # one car a frame inside the micro model's 6.4 m x 6.4 m scene
    make_raw_kitti(root, n_frames=N_FRAMES, n_train=N_TRAIN, seed=2, cars_per_frame=1,
                   n_background=6000, x_range=(3.0, 3.4), y_range=(-0.4, 0.4))
    JI.create_kitti_infos(root, workers=2)
    return runs(root)


def test_every_frame_is_evaluated(both):
    ref, got = both
    assert [a["frame_id"] for a in got[2]] == [a["frame_id"] for a in ref[2]] == [
        f"{i:06d}" for i in range(N_TRAIN, N_FRAMES)]
    assert sum(len(a["name"]) for a in got[2]) > 0


def test_detections_match_per_frame(both):
    ref, got = both
    for a, b in zip(got[2], ref[2]):
        assert len(a["name"]) == len(b["name"]), a["frame_id"]
        np.testing.assert_array_equal(a["name"], b["name"])
        for k in ("boxes_lidar", "score", "bbox", "location", "dimensions", "rotation_y",
                  "alpha"):
            np.testing.assert_allclose(np.asarray(a[k], np.float64), np.asarray(b[k], np.float64),
                                       rtol=RTOL, atol=1e-4, err_msg=f"{a['frame_id']} {k}")


def test_recall_is_exact(both):
    ref, got = both
    assert got[3] == ref[3]
    assert got[3]["gt"] == N_FRAMES - N_TRAIN
    assert got[3]["roi_0.0"] > 0 and got[3]["rcnn_0.0"] > 0


def test_ap_and_occ_stats_match(both):
    ref, got = both
    keys = [k for k in ref[1] if k not in ("sec_per_example", "frames_per_sec")]
    assert any(k.startswith("Car_3d/") for k in keys)
    assert any(k.startswith("occ_precision@") for k in keys)
    assert any(k.startswith("occ_box_cvrg@") for k in keys)
    for k in keys:
        assert abs(float(got[1][k]) - float(ref[1][k])) <= 1e-4, (k, got[1][k], ref[1][k])


def test_to_host_is_one_copy():
    """`to_host` packs tensors of mixed dtypes into one buffer and gives
    each back with its dtype, shape and values."""
    g = torch.Generator().manual_seed(0)
    t = {"boxes": torch.randn((2, 3, 7), generator=g), "valid": torch.rand((2, 3), generator=g) > 0.5,
         "labels": torch.randint(0, 4, (2, 3), generator=g), "idx": torch.arange(5, dtype=torch.int32),
         "empty": torch.zeros((2, 0))}
    got = TU.to_host(t)
    for k, v in t.items():
        assert got[k].dtype == v.numpy().dtype and got[k].shape == tuple(v.shape), k
        np.testing.assert_array_equal(got[k], v.numpy())
