"""The 3-class config (`tools/cfgs/model_configs/btcdet_kitti_3classes.yaml`:
Car, Pedestrian and Cyclist, their anchors interleaved at each BEV
location) in the port against the JAX package on the CPU: the anchors of
the yaml at the flagship grid bit for bit; the micro model with the yaml's
three anchor sets in an eval forward (stages to 1e-4, roi and
post-processing labels bit for bit) and a train step (each gradient
within 1e-3 of its tensor's max) on the synthetic batch with its gt boxes
relabelled 1..3; the eval loop on a 3-class micro KITTI tree (per-class AP
to 1e-4); and the 3-class training items of a KITTI tree (gt sampling of
every class, the per-class best-match databases) bit for bit. Also the
JAX package's failure under ROI_HEAD.CLASS_AGNOSTIC False with several
classes (ROADMAP Queue 3), which the port refuses by name. CPU, float32,
exact ball queries."""

import copy
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (assert_close, f32_mode, full_micro_cfgs, init_jax, perturb_variables,
                          relabel, run_both)

CLASSES = ("Car", "Pedestrian", "Cyclist")
THREE_CLASS_YAML = "tools/cfgs/model_configs/btcdet_kitti_3classes.yaml"


@functools.cache
def three_class_yaml():
    """The 3-class yaml as plain dicts (the port's loader)."""
    from btcdet_tpu_torch import config as tcfg

    return json.loads(json.dumps(tcfg.cfg_from_yaml_file(tcfg.REPO_ROOT / THREE_CLASS_YAML)))


def three_class_micro_cfgs(**roi_overrides):
    """The JAX package's full micro config with the 3-class yaml's anchor
    sets (per-class sizes, heights and thresholds, stride 8)."""
    data_cfg, model_cfg = full_micro_cfgs(**roi_overrides)
    anchors = three_class_yaml()["MODEL"]["DENSE_HEAD"]["ANCHOR_GENERATOR_CONFIG"]
    model_cfg.DENSE_HEAD.ANCHOR_GENERATOR_CONFIG = copy.deepcopy(anchors)
    return data_cfg, model_cfg


def test_yaml_anchors_match_jax():
    """The 3-class yaml's anchors at the flagship grid: 6 a location (3
    classes x 2 rotations), interleaved class by class, bit for bit."""
    from btcdet_tpu.models.dense_heads import anchor_head as JAH

    from btcdet_tpu_torch.models.dense_heads import anchor_head as TAH
    from btcdet_tpu_torch.ops.voxelizer import compute_grid_size

    y = three_class_yaml()
    assert y["CLASS_NAMES"] == list(CLASSES)
    pcr = y["DATA_CONFIG"]["POINT_CLOUD_RANGE"]
    vs = next(p["VOXEL_SIZE"] for p in y["DATA_CONFIG"]["DATA_PROCESSOR"]
              if p["NAME"] == "det_transform_points_to_voxels")
    grid = compute_grid_size(pcr, vs)
    cfgs = y["MODEL"]["DENSE_HEAD"]["ANCHOR_GENERATOR_CONFIG"]
    ref = JAH.generate_anchors(pcr, grid, cfgs)
    out = TAH.generate_anchors(pcr, grid, cfgs)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    anchors, anchor_class, per_loc = out
    assert per_loc == 6 and anchors.shape == (grid[1] // 8 * grid[0] // 8 * 6, 7) == (211200, 7)
    assert list(anchor_class[:12]) == [0, 0, 1, 1, 2, 2] * 2
    np.testing.assert_array_equal(anchors[:6, :2], np.repeat(anchors[:1, :2], 6, 0))
    assert [float(anchors[i, 3]) for i in (0, 2, 4)] == pytest.approx([3.9, 0.8, 1.76])


@functools.cache
def eval_run():
    from btcdet_tpu.config import EasyDict

    data_cfg, model_cfg = three_class_micro_cfgs()
    return run_both(EasyDict({"DATA_CONFIG": data_cfg, "MODEL": model_cfg}), 2048, 6,
                    class_names=CLASSES)


def test_eval_forward_matches():
    """The 3-class micro eval forward: stages to 1e-4, the rois' slots and
    class labels, the kept detections with their labels bit for bit."""
    from test_torch_det_options import assert_eval_matches

    res = eval_run()
    assert_eval_matches(res)
    assert res["out"]["rpn_cls_preds"].shape[-1] == 3
    # the rois and the detections carry more than one class
    labels = res["out"]["roi_labels"][res["out"]["roi_valid"]]
    assert len(set(labels.tolist())) > 1 and set(labels.tolist()) <= {1, 2, 3}
    post = res["post"]
    assert set(post["pred_labels"][post["pred_valid"]].tolist()) <= {1, 2, 3}


@functools.cache
def train_run():
    from btcdet_tpu.datasets import make_synthetic_batch as jax_batch

    from test_torch_train import train_step_both

    data_cfg, model_cfg = three_class_micro_cfgs(DP_RATIO=0.0)
    with f32_mode():
        batch = relabel(jax_batch(data_cfg, batch_size=2, num_points=2048, num_gt=6, seed=0,
                                  mode="train"), 3)
    return train_step_both(data_cfg, model_cfg, 2048, 6, batch_np=batch, class_names=CLASSES)


def test_train_step_matches():
    """One 3-class micro train step: the per-class anchor targets feed the
    RPN losses (to 1e-4), every gradient within 1e-3 of its tensor's max."""
    from test_torch_train import assert_step_gradients_match

    res = train_run()
    ref, out = res["ref_metrics"], res["metrics"]
    assert set(ref) <= set(out)
    for k in ref:
        assert np.isfinite(out[k]), k
        assert_close(out[k], float(np.asarray(ref[k])), err_msg=k)
    assert ref["rpn_loss_loc"] > 0
    assert {1, 2, 3} <= set(np.unique(res["batch"]["gt_boxes"][..., 7]).tolist()) <= {0, 1, 2, 3}
    assert_step_gradients_match(res)


def test_targets_carry_every_class():
    """The port's RPN targets of the relabelled batch hold positive anchors
    of each class, each on an anchor of its own class."""
    from btcdet_tpu_torch import config as tcfg
    from btcdet_tpu_torch.models import build_network

    data_cfg, model_cfg = three_class_micro_cfgs()
    net = build_network(tcfg.EasyDict(model_cfg), tcfg.EasyDict(data_cfg), list(CLASSES),
                        device="cpu")
    head = net.det_modules.dense_head
    gt = torch.from_numpy(train_run()["batch"]["gt_boxes"])
    labels = head.assign_targets(gt)["box_cls_labels"]
    for c in (1, 2, 3):
        pos = labels == c
        assert pos.any(), c
        assert bool((head.anchor_class[None].expand_as(labels)[pos] == c - 1).all()), c


def test_class_agnostic_false_fails_in_jax_and_is_refused():
    """ROI_HEAD.CLASS_AGNOSTIC False with three classes: the JAX package's
    train forward fails in ConvHead.get_loss, where the BCE takes (R, 3)
    logits against (R,) labels, and its eval forward in
    generate_predicted_boxes, which reshapes the (R, 3 * 7) box residuals
    to 7 a roi (ROADMAP Queue 3); the port refuses the option at build
    time and names the fault."""
    from btcdet_tpu.datasets import make_synthetic_batch as jax_batch
    from btcdet_tpu.models import build_network as jax_build

    from btcdet_tpu_torch import config as tcfg
    from btcdet_tpu_torch.models import build_network

    data_cfg, model_cfg = three_class_micro_cfgs(CLASS_AGNOSTIC=False)
    with f32_mode():
        batch = relabel(jax_batch(data_cfg, batch_size=2, num_points=1024, num_gt=3, seed=0,
                                  mode="train"), 3)
        net = jax_build(model_cfg, data_cfg, list(CLASSES))
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        rngs = {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1),
                "dropout": jax.random.PRNGKey(2)}
        # both fail while tracing, before any compile
        with pytest.raises(TypeError, match="incompatible shapes for broadcasting"):
            jax.jit(lambda b: net.init(rngs, b, train=True))(jb)
        with pytest.raises(TypeError, match="cannot reshape"):
            jax.jit(lambda b: net.init(rngs, b, train=False))(jb)
    with pytest.raises(NotImplementedError, match="CLASS_AGNOSTIC False"):
        build_network(tcfg.EasyDict(model_cfg), tcfg.EasyDict(data_cfg), list(CLASSES),
                      device="cpu")


# ------------------------------------------------------ on a KITTI tree

N_FRAMES, N_TRAIN = 6, 3
OBJECTS = {"Car": 2, "Pedestrian": 2, "Cyclist": 2}


@functools.cache
def eval_loop_runs(root):
    """(JAX, port) `eval_one_epoch` of the 3-class micro model on the
    micro tree at `root`: (result_str, result_dict, det_annos)."""
    from btcdet_tpu.datasets.kitti.kitti_dataset import KittiDataset as JaxKitti
    from btcdet_tpu.datasets.loader import PyLoader
    from btcdet_tpu.models import build_network as jax_build
    from btcdet_tpu.train import eval_utils as JU

    from btcdet_tpu_torch import config as tcfg
    from btcdet_tpu_torch import weights
    from btcdet_tpu_torch.datasets.kitti.kitti_dataset import KittiDataset
    from btcdet_tpu_torch.datasets.loader import make_loader
    from btcdet_tpu_torch.models import build_network
    from btcdet_tpu_torch.train import eval_utils as TU
    from test_torch_eval_loop import kitti_micro_data_cfg

    data_cfg, model_cfg = three_class_micro_cfgs()
    dcfg = kitti_micro_data_cfg(root, data_cfg)
    dcfg["MAX_GT_BOXES"] = 6
    post_cfg = model_cfg.POST_PROCESSING
    with f32_mode():
        ds = JaxKitti(dcfg, list(CLASSES), training=False, root_path=root)
        loader = PyLoader(ds, 2, collate_fn=ds.collate_batch)
        first = {k: v for k, v in next(iter(loader)).items() if k != "frame_id"}
        net = jax_build(model_cfg, dcfg, list(CLASSES))
        variables = perturb_variables(init_jax(net, first))
        cls = variables["params"]["occ_subnet"]["conv_cls"]
        cls["bias"] = np.zeros_like(cls["bias"])
        variables = jax.tree_util.tree_map(jnp.asarray, variables)
        ref = JU.eval_one_epoch(net, variables, loader, ds, post_cfg, list(CLASSES),
                                recall_thresh_list=(0.0, 0.1))
        tdcfg, tmcfg = tcfg.EasyDict(dcfg), tcfg.EasyDict(model_cfg)
        tds = KittiDataset(tdcfg, list(CLASSES), training=False, root_path=root)
        port = build_network(tmcfg, tdcfg, list(CLASSES), device="cpu")
        port.load_state_dict(weights.from_jax_variables(
            jax.tree_util.tree_map(np.asarray, variables), dp_ratio=tmcfg.ROI_HEAD.DP_RATIO,
            upsample_strides=tmcfg.BACKBONE_2D.UPSAMPLE_STRIDES),
            strict=True)
        got = TU.eval_one_epoch(port, make_loader(tds, 2, collate_fn=tds.collate_batch), tds,
                                tcfg.EasyDict(post_cfg), list(CLASSES),
                                recall_thresh_list=(0.0, 0.1))
    return ref, got


@pytest.fixture(scope="module")
def micro_tree(tmp_path_factory):
    from btcdet_tpu.datasets.kitti import kitti_infos as JI
    from btcdet_tpu.datasets.synthetic_kitti import make_raw_kitti

    root = tmp_path_factory.mktemp("kitti_micro_3class")
    # one object of each class a frame inside the micro model's 6.4 m scene
    make_raw_kitti(root, n_frames=N_FRAMES, n_train=N_TRAIN, seed=4, n_background=6000,
                   x_range=(1.8, 4.6), y_range=(-2.0, 2.0),
                   objects_per_frame={"Car": 1, "Pedestrian": 1, "Cyclist": 1})
    JI.create_kitti_infos(root, workers=2)
    return root


def test_eval_loop_per_class_ap_matches(micro_tree):
    """The eval loop on a 3-class micro tree: the same detections per frame
    (names, boxes and scores to 1e-4) and every AP key of each class to
    1e-4."""
    ref, got = eval_loop_runs(micro_tree)
    assert [a["frame_id"] for a in got[2]] == [a["frame_id"] for a in ref[2]]
    for a, b in zip(got[2], ref[2]):
        np.testing.assert_array_equal(a["name"], b["name"])
        for k in ("boxes_lidar", "score"):
            assert_close(a[k], b[k], err_msg=f"{a['frame_id']} {k}")
    keys = [k for k in ref[1] if k not in ("sec_per_example", "frames_per_sec")
            and not k.startswith("time_ms")]
    for cls in CLASSES:
        assert any(k.startswith(f"{cls}_3d/") for k in keys), cls
    for k in keys:
        assert abs(float(got[1][k]) - float(ref[1][k])) <= 1e-4, (k, got[1][k], ref[1][k])
    assert len({n for a in got[2] for n in a["name"]}) > 1


@pytest.fixture(scope="module")
def train_trees(tmp_path_factory):
    """One 3-class tree (2 of each class a frame) written by each package,
    with its infos, gt database and the best-match database of every class
    made by that package."""
    from btcdet_tpu.datasets import bestmatch as JB
    from btcdet_tpu.datasets.kitti import kitti_infos as JI
    from btcdet_tpu.datasets.synthetic_kitti import make_raw_kitti as jax_make_raw_kitti

    from btcdet_tpu_torch.datasets import bestmatch as TB
    from btcdet_tpu_torch.datasets.kitti import kitti_infos as TI
    from btcdet_tpu_torch.datasets.synthetic_kitti import make_raw_kitti

    port = tmp_path_factory.mktemp("train3_port")
    ref = tmp_path_factory.mktemp("train3_jax")
    kw = dict(n_frames=N_FRAMES, n_train=N_TRAIN, seed=12, objects_per_frame=OBJECTS)
    make_raw_kitti(port, **kw)
    jax_make_raw_kitti(ref, **kw)
    for root, infos, bm in ((port, TI, TB), (ref, JI, JB)):
        infos.create_kitti_infos(root, workers=2)
        bm.create_best_match_db(root, class_names=CLASSES, splits=("train",))
    return port, ref


def test_training_items_match_bit_for_bit(train_trees):
    """Every training item of one epoch under the 3-class yaml's DATA_CONFIG
    (gt sampling of Car / Pedestrian / Cyclist, the per-class best-match
    roots, the world transforms, the processors) and their collated batch,
    bit for bit; the pasted boxes cover every class."""
    from btcdet_tpu import config as jcfg
    from btcdet_tpu.datasets.kitti.kitti_dataset import KittiDataset as JaxKitti

    from btcdet_tpu_torch import config as tcfg
    from btcdet_tpu_torch.datasets.kitti.kitti_dataset import KittiDataset
    from test_torch_kitti_pipeline import assert_same

    port_root, ref_root = train_trees
    d = three_class_yaml()["DATA_CONFIG"]
    bm = next(a for a in d["DATA_AUGMENTOR"]["AUG_CONFIG_LIST"]
              if a["NAME"] == "add_multi_best_match")
    assert bm["PED_MLT_BM_ROOT"] == "bm_5maxdist_2num_Pedestrian"
    assert bm["CYC_MLT_BM_ROOT"] == "bm_5maxdist_2num_Cyclist"
    pd, jd = copy.deepcopy(d), copy.deepcopy(d)
    pd["DATA_PATH"], jd["DATA_PATH"] = str(port_root), str(ref_root)
    port = KittiDataset(tcfg.EasyDict(pd), list(CLASSES), training=True, root_path=port_root)
    ref = JaxKitti(jcfg.EasyDict(jd), list(CLASSES), training=True, root_path=ref_root)
    items = [(port[i], ref[i]) for i in range(N_TRAIN)]
    pasted = set()
    for i, (a, b) in enumerate(items):
        assert_same(a, b, f"frame {i}")
        assert len(a["bm_points"]) > 0
        labels = sum(OBJECTS.values())
        pasted |= set(a["gt_boxes"][labels:, 7].astype(int).tolist())
        assert set(a["gt_boxes"][:, 7].astype(int).tolist()) == {1, 2, 3}
    assert pasted == {1, 2, 3}, pasted
    assert_same(port.collate_batch([a for a, _ in items]),
                ref.collate_batch([b for _, b in items]))
