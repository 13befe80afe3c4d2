"""The port's training host pipeline against the JAX package's, on a
synthetic on-disk KITTI tree written by each package: the infos, the train
and val gt databases, the best-match database and the coverage infos; every
`KittiDataset(training=True)[i]` of two epochs under the flagship yaml's
DATA_CONFIG (gt sampling with road planes, the best-match points, world
flip / scaling / rotation with SAVE_PRE_ROT, then the processors) and the
collated batch, bit for bit; and the augmentors off that path
(`SupGTSampling`, `BestMatchQuerier`, the ABLATION `filter_bm` with its vis
point sets) on the configs of tests/test_sup_gt_sampling.py and
tests/test_filter_bm.py."""

import copy
import filecmp
import json
import pickle

import numpy as np
import pytest
from test_filter_bm import make_querier as jax_filter_querier
from test_filter_bm import scene as filter_scene
from test_sup_gt_sampling import scene_dict, sup_cfg
from test_torch_kitti_pipeline import assert_same

from btcdet_tpu import config as jcfg
from btcdet_tpu.datasets import augmentor as JA
from btcdet_tpu.datasets import bestmatch as JB
from btcdet_tpu.datasets.kitti import kitti_infos as JI
from btcdet_tpu.datasets.kitti.kitti_dataset import KittiDataset as JaxKitti
from btcdet_tpu.datasets.synthetic_kitti import make_raw_kitti as jax_make_raw_kitti
from btcdet_tpu_torch import config as tcfg
from btcdet_tpu_torch.datasets import augmentor as TA
from btcdet_tpu_torch.datasets import bestmatch as TB
from btcdet_tpu_torch.datasets.kitti import kitti_infos as TI
from btcdet_tpu_torch.datasets.kitti.kitti_dataset import KittiDataset
from btcdet_tpu_torch.datasets.synthetic_kitti import make_raw_kitti
import torch_parity  # noqa: F401,E402  (caps torch's threads in this process)

N_FRAMES, N_TRAIN = 9, 6
BM_DIR = "bm_50maxdist_2num_car"


def build_offline(root, infos, groundtruth_database, best_match_db, with_coverage):
    """infos + train gt database, the val gt database, the best-match
    database of both splits, then the coverage infos."""
    infos(root, workers=2)
    groundtruth_database(root, root / "kitti_infos_val.pkl", split="val")
    best_match_db(root, class_names=("Car",), splits=("train", "val"))
    with_coverage(root, workers=2)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """The same raw tree twice, the offline databases made by the port in
    one and by the JAX package in the other."""
    port = tmp_path_factory.mktemp("train_port")
    ref = tmp_path_factory.mktemp("train_jax")
    kw = dict(n_frames=N_FRAMES, n_train=N_TRAIN, seed=11, cars_per_frame=3)
    make_raw_kitti(port, **kw)
    jax_make_raw_kitti(ref, **kw)
    build_offline(port, TI.create_kitti_infos, TI.create_groundtruth_database,
                  TB.create_best_match_db, TI.create_kitti_infos_with_coverage)
    build_offline(ref, JI.create_kitti_infos, JI.create_groundtruth_database,
                  JB.create_best_match_db, JI.create_kitti_infos_with_coverage)
    return port, ref


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("name", ["kitti_infos_train.pkl", "kitti_infos_val.pkl",
                                  "kitti_dbinfos_train.pkl", "kitti_dbinfos_val.pkl",
                                  "kitti_cvrg_infos_train.pkl", "kitti_cvrg_infos_val.pkl"])
def test_offline_infos_match(roots, name):
    port, ref = roots
    a, b = _load(port / name), _load(ref / name)
    assert len(a) > 0
    assert_same(a, b)
    if "cvrg" in name:
        rates = np.concatenate([np.asarray(i["annos"]["coverage_rates"]).reshape(-1)
                                for i in a])
        assert rates.size and (rates > 0).all() and np.isfinite(rates).all()


@pytest.mark.parametrize("sub", ["gt_database", "gt_database_val"])
def test_gt_databases_match(roots, sub):
    port, ref = roots
    files = sorted(p.name for p in (ref / sub).iterdir())
    assert files == sorted(p.name for p in (port / sub).iterdir()) and files
    _, mismatch, errors = filecmp.cmpfiles(port / sub, ref / sub, files, shallow=False)
    assert not mismatch and not errors


def test_best_match_databases_match(roots):
    port, ref = roots
    files = sorted(p.name for p in (ref / BM_DIR).iterdir())
    assert files == sorted(p.name for p in (port / BM_DIR).iterdir())
    assert len(files) == 3 * N_FRAMES
    for f in files:
        a, b = _load(port / BM_DIR / f), _load(ref / BM_DIR / f)
        assert_same(a, b, f)
        assert a.dtype == np.float32 and a.shape[1] == 3
    # strip-padded names: image 000004's gt 1 is "4_1.pkl"
    assert "4_1.pkl" in files
    assert TB.inspect_bm_db(port, "Car") == JB.inspect_bm_db(ref, "Car")


def flagship_data_cfgs(port_root, ref_root):
    """The flagship yaml's DATA_CONFIG (augmentor included) for both
    packages, each reading its own tree."""
    d = json.loads(json.dumps(tcfg.flagship().DATA_CONFIG))
    pd, jd = copy.deepcopy(d), copy.deepcopy(d)
    pd["DATA_PATH"], jd["DATA_PATH"] = str(port_root), str(ref_root)
    return tcfg.EasyDict(pd), jcfg.EasyDict(jd)


@pytest.fixture(scope="module")
def train_sets(roots):
    port_root, ref_root = roots
    pd, jd = flagship_data_cfgs(port_root, ref_root)
    port = KittiDataset(pd, ["Car"], training=True, root_path=port_root)
    ref = JaxKitti(jd, ["Car"], training=True, root_path=ref_root)
    assert [n for n, _ in port.data_augmentor.queue] == [
        "gt_sampling", "add_multi_best_match", "random_world_flip", "random_world_scaling",
        "random_world_rotation"]
    return port, ref


@pytest.fixture(scope="module")
def train_items(train_sets):
    """{(epoch, index): (port item, JAX item)} for every train frame."""
    port, ref = train_sets
    items = {}
    for epoch in (0, 1):
        port._epoch = ref._epoch = epoch
        for i in range(N_TRAIN):
            items[epoch, i] = (port[i], ref[i])
    return items


@pytest.mark.parametrize("epoch", [0, 1])
def test_training_items_match_bit_for_bit(train_items, epoch):
    labels = 3
    pasted = []
    for i in range(N_TRAIN):
        a, b = train_items[epoch, i]
        assert_same(a, b, f"epoch {epoch} frame {i}")
        assert {"rot_z", "bm_points", "occ_voxels", "det_voxels", "gt_boxes"} <= a.keys()
        assert len(a["bm_points"]) > 0 and a["rot_z"] != 0.0
        pasted.append(len(a["gt_boxes"]) - labels)
    # gt sampling pasted database cars into the scenes
    assert max(pasted) > 0, pasted


def test_epochs_draw_anew(train_items):
    a, b = train_items[0, 0][0], train_items[1, 0][0]
    assert a["rot_z"] != b["rot_z"]


def test_training_batch_collates_alike(train_sets, train_items):
    port, ref = train_sets
    pairs = [train_items[1, i] for i in (0, 3)]
    batch = port.collate_batch([a for a, _ in pairs])
    assert_same(batch, ref.collate_batch([b for _, b in pairs]))
    assert batch["bm_points_mask"].any(axis=1).all()


@pytest.mark.parametrize("gt_n,bm_n,no_stucking,rmv", [
    (2, 2, False, 0), (2, 2, True, 0), (3, 1, False, 2), (0, 3, False, 2)])
def test_sup_gt_sampling_matches(roots, gt_n, bm_n, no_stucking, rmv):
    port_root, ref_root = roots
    cfg = sup_cfg(gt_n, bm_n, no_stucking, rmv)
    outs = []
    for cls, root in ((TA.SupGTSampling, port_root), (JA.SupGTSampling, ref_root)):
        rng = np.random.RandomState(5)
        outs.append(cls(root, tcfg.EasyDict(copy.deepcopy(dict(cfg))), ["Car"])(
            scene_dict(rng), rng=rng))
    assert_same(outs[0], outs[1])
    # the scene's 3000 points fill every box: NO_STUCKING rejects them all
    assert outs[0].get("pre_aug_bm", False) == (not no_stucking)


def test_sup_gt_sampling_then_querier_matches(roots):
    """The whole augmentor with sup_gt_sampling then add_multi_best_match
    and the world transforms (the pre_aug_bm handshake)."""
    port_root, ref_root = roots
    cfg = {"AUG_CONFIG_LIST": [
        dict(sup_cfg(2, 2, False, 2)),
        {"NAME": "add_multi_best_match", "CAR_MLT_BM_ROOT": BM_DIR, "NUM_POINT_FEATURES": 3},
        {"NAME": "random_world_flip", "ALONG_AXIS_LIST": ["x"]},
        {"NAME": "random_world_rotation", "WORLD_ROT_ANGLE": [-0.78539816, 0.78539816],
         "SAVE_PRE_ROT": True}]}
    outs = []
    for mod, EasyDict, root in ((TA, tcfg.EasyDict, port_root), (JA, jcfg.EasyDict, ref_root)):
        rng = np.random.RandomState(8)
        aug = mod.DataAugmentor(root, EasyDict(copy.deepcopy(cfg)), ["Car"])
        outs.append(aug.forward(scene_dict(rng), rng=rng))
    assert_same(outs[0], outs[1])
    assert len(outs[0]["bm_points"]) > 0


def test_best_match_querier_matches(tmp_path):
    """The older single-best-match querier over a bmatch_infos pkl."""
    rng = np.random.RandomState(3)
    infos = {("000007", i): rng.randn(40 + i, 4).astype(np.float32) for i in range(3)}
    with open(tmp_path / "bmatch_infos.pkl", "wb") as f:
        pickle.dump(infos, f)
    boxes = np.concatenate([rng.rand(4, 3) * 10, np.full((4, 3), 2.0),
                            rng.uniform(-3, 3, (4, 1))], 1).astype(np.float32)
    outs = []
    for mod, EasyDict in ((TA, tcfg.EasyDict), (JA, jcfg.EasyDict)):
        q = mod.BestMatchQuerier(tmp_path, EasyDict({"NAME": "add_best_match"}), ["Car"])
        outs.append(q({"frame_id": "000007", "gt_boxes": boxes.copy()}))
    assert_same(outs[0], outs[1])
    assert outs[0]["bm_points"].shape == (40 + 41 + 42, 3)


@pytest.mark.parametrize("rmv_self,rmv_miss,vis", [
    (False, False, False), (True, False, False), (False, True, False), (True, True, True)])
def test_filter_bm_matches(rmv_self, rmv_miss, vis):
    """The ABLATION filtering (and, with VIS, the nine debug point sets it
    adds to the frame) on tests/test_filter_bm.py's scene."""
    points, box, bm = filter_scene()
    ref_q = jax_filter_querier(rmv_self, rmv_miss, vis)
    port_q = TA.MltBestMatchQuerier("/nonexistent", tcfg.EasyDict(copy.deepcopy(dict(ref_q.cfg))),
                                    ["Car"])
    outs = []
    for q in (port_q, ref_q):
        data = {"points": points.copy()}
        outs.append((q.filter_bm(data, box[None], [bm.copy()]), data))
    assert_same(outs[0], outs[1])
    if vis:
        assert set(TA.SPECIAL_NAMES[1:]) <= outs[0][1].keys()
