"""The port's evaluation entry point, `tools/test_torch.py`: on the micro
config (a reference-format `.pth` through `--ckpt`, port checkpoints
through `--ckpt_dir --eval_all`; the yaml as shipped, with its approximate
ball query, against the JAX package's forward), its refusal to fall back
to the CPU, the one-command KITTI-val script
(`tools/run_kitti_val_torch.sh`) at batch 8 on the CPU, and
under `-m slow` the flagship geometry at reduced capacities against the
JAX package's KITTI-val runbook (`tools/run_kitti_val.sh`: reference
checkpoint import, then `tools/test.py`'s evaluation) on one synthetic
tree and one reference `.pth`: the AP and occ keys to 1e-4, the
detections per frame (count and names exact, boxes and scores to 1e-4 as
sets). At the 70 m geometry the two packages' rois agree to about 1e-5,
not bit for bit, and a ConvHead ball whose membership flips at its radius
refines its box anew: at most 5 % of the detections may move, each by at
most 0.25 m and 0.01 in score (ROADMAP, Queue 3)."""

import importlib.util
import json
import os
import subprocess
import sys
from argparse import Namespace
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from btcdet_tpu_torch import weights
from btcdet_tpu_torch.config import EasyDict, cfg_from_yaml_file
from btcdet_tpu_torch.datasets import mini_config
from btcdet_tpu_torch.datasets.kitti import kitti_infos as TI
from btcdet_tpu_torch.datasets.synthetic_kitti import make_raw_kitti
from btcdet_tpu_torch.models import build_network
from btcdet_tpu_torch.train import checkpoint as C
import torch_parity  # noqa: F401,E402  (caps torch's threads in this process)

REPO = Path(__file__).resolve().parent.parent
MANIFEST = Path(__file__).parent / "fixtures" / "reference_state_dict_manifest.json"


def _load_cli(path=REPO / "tools" / "test_torch.py", name="test_torch_cli"):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _plain(tree):
    return json.loads(json.dumps(tree))


@pytest.fixture(scope="module")
def micro_tree(tmp_path_factory):
    """A micro-scale KITTI tree, its infos, and the micro config as a yaml
    file reading it (points outside the 6.4 m scene dropped first)."""
    tmp = tmp_path_factory.mktemp("cli_micro")
    root = tmp / "kitti"
    make_raw_kitti(root, n_frames=5, n_train=2, seed=6, cars_per_frame=1, n_background=3000,
                   x_range=(3.0, 3.4), y_range=(-0.4, 0.4))
    TI.create_kitti_infos(root, workers=2)
    d = mini_config.micro_data_cfg(with_occ=True)
    d.update({"DATASET": "KittiDataset", "DATA_PATH": str(root),
              "DATA_SPLIT": {"train": "train", "test": "val"},
              "INFO_PATH": {"train": ["kitti_infos_train.pkl"], "test": ["kitti_infos_val.pkl"]},
              "FOV_POINTS_ONLY": False, "MAX_POINTS_PER_FRAME": 2048, "MAX_GT_BOXES": 4})
    d["DATA_PROCESSOR"] = [{"NAME": "mask_points_and_boxes_outside_range",
                            "REMOVE_OUTSIDE_BOXES": True}] + list(d["DATA_PROCESSOR"])
    cfg = {"CLASS_NAMES": ["Car"], "DATA_CONFIG": _plain(d),
           "MODEL": _plain(mini_config.micro_model_cfg(with_occ=True))}
    cfg_file = tmp / "micro_kitti.yaml"
    cfg_file.write_text(yaml.safe_dump(cfg, sort_keys=False))
    return tmp, cfg_file


def test_cli_micro_reference_pth_and_ckpt_dir(micro_tree):
    """`--ckpt` with a reference-format file, then `--ckpt_dir --eval_all`
    over two port checkpoints of the same weights: every val frame is
    evaluated, the AP keys are present and finite, both give the same
    detections, and the best-mAP tracker sees both steps."""
    tmp, cfg_file = micro_tree
    cfg = cfg_from_yaml_file(cfg_file, EasyDict())
    cfg.MODEL.ROI_HEAD.APPROX_QUERY = False
    net = build_network(cfg.MODEL, cfg.DATA_CONFIG, ["Car"], device="cpu")
    sd = weights.synth_state_dict(net)
    pth = tmp / "reference.pth"
    torch.save({"model_state": sd, "epoch": 3, "it": 77}, pth)
    net.load_state_dict(sd)
    mgr = C.CheckpointManager(tmp / "ckpt")
    mgr.save(5, net)
    mgr.save(9, net)
    cli = _load_cli()
    common = ["--cfg_file", str(cfg_file), "--batch_size", "2", "--workers", "0",
              "--device", "cpu", "--output_dir", str(tmp / "out")]
    over = ["--set", "MODEL.ROI_HEAD.APPROX_QUERY", "False"]
    (one,) = cli.main(common + ["--ckpt", str(pth), "--save_to_file"] + over)
    steps = cli.main(common + ["--ckpt_dir", str(tmp / "ckpt"), "--eval_all",
                               "--max_waiting_mins", "0"] + over)
    assert one[0] == 77 and [s[0] for s in steps] == [5, 9]
    for step, _, result, annos in [one] + steps:
        assert [a["frame_id"] for a in annos] == ["000002", "000003", "000004"]
        assert "Car_3d/moderate_R40" in result and "occ_precision@0.5" in result
        assert all(np.isfinite(float(v)) for k, v in result.items() if k.startswith("Car_"))
        for a, b in zip(annos, one[3]):
            np.testing.assert_array_equal(a["boxes_lidar"], b["boxes_lidar"])
    assert sorted(p.name for p in (tmp / "out" / "step_77" / "val").glob("*.txt")) == [
        "000002.txt", "000003.txt", "000004.txt"]
    assert (tmp / "out" / "eval_list_val.txt").read_text().split() == ["77", "5", "9"]


def test_cli_micro_yaml_as_shipped_matches_the_jax_forward(micro_tree, tmp_path):
    """The micro yaml leaves APPROX_QUERY unset, which both packages read as
    the roi-grouped approximate query. `tools/test_torch.py` on it with no
    `--set`, from JAX weights (init, BN moved off identity) carried across
    by `weights.from_jax_variables` into a reference-format `.pth`: each
    batch's detections equal the JAX package's eval forward +
    post-processing on the same batch with the same weights (f32, valid
    flags and labels exact, scores and boxes to 1e-4)."""
    import jax
    from btcdet_tpu.config import EasyDict as JaxEasyDict
    from btcdet_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml
    from btcdet_tpu.datasets import make_synthetic_batch as jax_batch
    from btcdet_tpu.models import build_network as jax_build
    from btcdet_tpu.models.detectors.btcnet import post_processing as jax_post
    from torch_parity import assert_close, f32_mode, init_jax, perturb_variables, to_np_tree

    _, cfg_file = micro_tree
    jcfg = jax_cfg_from_yaml(str(cfg_file), JaxEasyDict())
    assert "APPROX_QUERY" not in jcfg.MODEL.ROI_HEAD
    seen = []
    with f32_mode():
        net = jax_build(jcfg.MODEL, jcfg.DATA_CONFIG, ["Car"])
        example = jax_batch(jcfg.DATA_CONFIG, batch_size=2, num_points=2048, num_gt=4, seed=0,
                            mode="test")
        variables = perturb_variables(init_jax(net, example))
        cls = variables["params"]["occ_subnet"]["conv_cls"]
        cls["bias"] = np.zeros_like(cls["bias"])
        sd = weights.from_jax_variables(variables, dp_ratio=jcfg.MODEL.ROI_HEAD.DP_RATIO,
                                        upsample_strides=jcfg.MODEL.BACKBONE_2D.UPSAMPLE_STRIDES)
        pth = tmp_path / "from_jax.pth"
        torch.save({"model_state": {k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()},
                    "epoch": 1, "it": 11}, pth)
        (run,) = _load_cli().main(
            ["--cfg_file", str(cfg_file), "--ckpt", str(pth), "--batch_size", "2",
             "--workers", "0", "--device", "cpu", "--output_dir", str(tmp_path / "out")],
            on_batch=lambda i, batch, post: seen.append((batch, post)))

        @jax.jit
        def forward(v, b):
            return net.apply(v, b, train=False)

        for batch, post in seen:
            jb = {k: jax.numpy.asarray(v) for k, v in batch.items()
                  if isinstance(v, np.ndarray) and v.dtype.kind in "biuf"}
            ref = to_np_tree(jax_post(forward(variables, jb), jcfg.MODEL.POST_PROCESSING, 1))
            np.testing.assert_array_equal(post["pred_valid"], ref["pred_valid"])
            np.testing.assert_array_equal(post["pred_labels"], ref["pred_labels"])
            assert_close(post["pred_scores"], ref["pred_scores"])
            assert_close(post["pred_boxes"], ref["pred_boxes"])
    assert run[0] == 11 and len(seen) == 2
    assert sum(int(p["pred_valid"].sum()) for _, p in seen) > 0


def test_cli_without_a_card_fails_with_resolve_devices_error(micro_tree, tmp_path):
    _, cfg_file = micro_tree
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    r = subprocess.run([sys.executable, "tools/test_torch.py", "--cfg_file", str(cfg_file),
                        "--ckpt", "unused.pth", "--output_dir", str(tmp_path)],
                       capture_output=True, text=True, cwd=str(REPO), env=env, timeout=300)
    assert r.returncode != 0
    assert "no CUDA device is available" in r.stderr, r.stderr[-2000:]


def test_run_kitti_val_torch_script(micro_tree, tmp_path):
    """`tools/run_kitti_val_torch.sh` on a copy of the micro tree without its
    infos, with a reference-format `.pth`, `DEVICE=cpu` and batch 8 (the
    tree's 3 val frames in one partial batch): it generates the infos, then
    evaluates every val frame with the official AP."""
    import shutil

    tmp, cfg_file = micro_tree
    root = tmp_path / "kitti"
    shutil.copytree(tmp / "kitti", root,
                    ignore=lambda d, names: [n for n in names if n.endswith(".pkl")
                                             or n.startswith("gt_database")])
    assert not list(root.glob("*.pkl"))
    cfg = cfg_from_yaml_file(cfg_file, EasyDict())
    net = build_network(cfg.MODEL, cfg.DATA_CONFIG, ["Car"], device="cpu")
    pth = tmp_path / "reference.pth"
    torch.save({"model_state": weights.synth_state_dict(net), "epoch": 2, "it": 31}, pth)
    out = tmp_path / "out"
    env = dict(os.environ, DEVICE="cpu", WORKERS="0", OUTPUT_DIR=str(out),
               OMP_NUM_THREADS="1")
    r = subprocess.run(["bash", "tools/run_kitti_val_torch.sh", str(root), str(pth),
                        str(cfg_file), "8"], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "generating kitti infos" in r.stdout and (root / "kitti_infos_val.pkl").exists()
    (log,) = out.glob("eval_*.log")
    txt = log.read_text()
    assert "evaluating " + str(pth) + " (step 31)" in txt
    assert "eval: 3 frames over 1 rank(s)" in txt
    assert "Car AP_R40@0.70, 0.70, 0.70:" in txt, txt[-2000:]


# ------------------------------------------------- the flagship geometry

def _reduced_flagship(path, root):
    """The flagship yaml at the reduced capacities of
    tests/test_run_kitti_val.py, exact ball queries, reading `root`."""
    d = _plain(cfg_from_yaml_file(REPO / "tools/cfgs/model_configs/btcdet_kitti_car.yaml"))
    d["DATA_CONFIG"]["DATA_PATH"] = str(root)
    for proc in d["DATA_CONFIG"]["DATA_PROCESSOR"]:
        if "MAX_NUMBER_OF_VOXELS" in proc:
            proc["MAX_NUMBER_OF_VOXELS"] = {"train": 4000, "test": 4000}
    d["MODEL"]["BACKBONE_3D"]["LEVEL_CAPACITIES"] = {
        "train": [8000, 5000, 2500, 2000], "test": [8000, 5000, 2500, 2000]}
    d["MODEL"]["OCC"]["PARAMS"]["MAX_NUM_OCC_PNTS"] = 1024
    d["MODEL"]["OCC"]["PARAMS"]["EVAL_MAX_NUM_OCC_PNTS"] = 1024
    d["MODEL"]["ROI_HEAD"]["APPROX_QUERY"] = False
    path.write_text(yaml.safe_dump(d, sort_keys=False))
    return path


@pytest.mark.slow
def test_cli_flagship_matches_the_jax_runbook(tmp_path):
    from torch_parity import f32_mode

    root = tmp_path / "kitti"
    make_raw_kitti(root, n_frames=4, n_train=2, seed=3, cars_per_frame=2)
    TI.create_kitti_infos(root, workers=2)
    cfg_file = _reduced_flagship(tmp_path / "flagship_reduced.yaml", root)
    manifest = json.load(open(MANIFEST))
    pth = tmp_path / "reference.pth"
    torch.save({"model_state": {k: torch.from_numpy(weights.synth_tensor(k, s))
                                for k, s in manifest.items()}, "epoch": 7, "it": 123}, pth)

    # the JAX runbook's import, as tools/run_kitti_val.sh runs it
    env = dict(os.environ, BTCDET_PLATFORM="cpu", BTCDET_F32="1")
    r = subprocess.run([sys.executable, "tools/import_reference_ckpt.py", "--ckpt", str(pth),
                        "--cfg_file", str(cfg_file), "--out", str(tmp_path / "jax_ckpt"),
                        "--strict"], cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=3600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "saved imported checkpoint (step 123)" in r.stdout

    with f32_mode():
        # the runbook's evaluation: tools/test.py's steps, in process
        import jax

        jt = _load_cli(REPO / "tools" / "test.py", "jax_test_cli")
        from btcdet_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml
        from btcdet_tpu.train import checkpoint as jax_ckpt
        from btcdet_tpu.train import trainer as jax_trainer

        jt.cfg.clear()
        jax_cfg_from_yaml(str(cfg_file), jt.cfg)
        args = Namespace(batch_size=2, workers=0, save_to_file=False, vis_stride=0,
                         data_parallel=False)
        logger = jt.create_logger()
        jnet, jdl, jds = jt.build_eval(args, jt.cfg, logger)
        example = {k: jax.numpy.asarray(v) for k, v in next(iter(jdl)).items()
                   if k != "frame_id"}
        state, _ = jax_trainer.create_train_state(
            jnet, example, jax.random.PRNGKey(0), det_opt_cfg=jt.cfg.OPTIMIZATION,
            occ_opt_cfg=jt.cfg.get("OCC_OPTIMIZATION", None), total_steps=1)
        restored, step = jax_ckpt.CheckpointManager(tmp_path / "jax_ckpt").restore(state)
        assert step == 123
        _, want, want_annos = jt.eval_ckpt(jnet, jdl, jds, restored, args, tmp_path, logger)

        (got,) = _load_cli().main([
            "--cfg_file", str(cfg_file), "--ckpt", str(pth), "--batch_size", "2",
            "--workers", "0", "--device", "cpu", "--output_dir", str(tmp_path / "port"),
            "--set", "MODEL.ROI_HEAD.APPROX_QUERY", "False"])
    step, _, result, annos = got
    assert step == 123
    keys = [k for k in want if k.startswith("Car_")]
    assert len(keys) >= 18
    for k in keys:
        assert abs(float(result[k]) - float(want[k])) <= 1e-4, (k, result[k], want[k])
    for k in [k for k in want if k.startswith("occ_")]:
        assert abs(result[k] - want[k]) <= 1e-4, k
    assert [a["frame_id"] for a in annos] == [a["frame_id"] for a in want_annos]
    assert sum(len(a["name"]) for a in annos) > 0
    n_all = n_off = 0
    for a, b in zip(annos, want_annos):
        assert len(a["name"]) == len(b["name"]), a["frame_id"]
        np.testing.assert_array_equal(a["name"], b["name"])
        off = _unmatched(a, b)
        n_all += len(a["name"])
        n_off += len(off)
        # the few that move: a roi-pooling ball whose membership flips at its
        # radius (rois agree to ~1e-5, not bit for bit) refines that box anew
        for i, (dist, dscore) in off.items():
            assert dist <= 0.25 and dscore <= 0.01, (a["frame_id"], i, dist, dscore)
    assert n_off <= 0.05 * n_all, (n_off, n_all)


def _unmatched(a, b, tol=1e-4):
    """{index of a detection of `a` with no counterpart in `b` within tol
    (box, score, image box, location): (centre distance, score difference)
    to the nearest detection of `b`}; detections are compared as sets,
    since near-tied scores may be visited in another order."""
    def rows(anno):
        return np.concatenate([np.asarray(anno[k], np.float64).reshape(len(anno["name"]), -1)
                               for k in ("boxes_lidar", "score", "bbox", "location")], axis=1)

    ra, rb = rows(a), rows(b)
    out = {}
    for i, r in enumerate(ra):
        if not np.any(np.all(np.abs(rb - r) <= tol + tol * np.abs(rb), axis=1)):
            j = int(np.argmin(np.linalg.norm(rb[:, :3] - r[:3], axis=1)))
            out[i] = (float(np.linalg.norm(rb[j, :3] - r[:3])), float(abs(rb[j, 7] - r[7])))
    return out
