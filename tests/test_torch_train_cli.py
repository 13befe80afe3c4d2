"""The port's training entry point, `tools/train_torch.py`, on the micro
config over a small synthetic KITTI tree (the yaml's augmentor chain: gt
sampling with road planes, best-match points, world flip / scaling /
rotation) with `--device cpu`: it trains, logs, dumps clouds and occ-vis
views, saves and rotates checkpoints and evaluates the newest on val with
finite AP keys; two epochs straight equal one epoch, a cut and an
auto-resumed epoch, bit for bit in weights, BN statistics and optimizer
state; `--pre_occ` with the occ LR at 0 leaves the occ parameters as
loaded; without a card and without `--device cpu` it fails with
`resolve_device`'s error; a `--launcher` without its launcher's
environment is refused; and the first
train step's loss terms on the port's training batch match the JAX
package's `make_train_step` on the JAX package's batch of the same frames,
with bridged weights (tests/test_torch_train.py's harness), to 1e-3."""

import copy
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from btcdet_tpu_torch import config as tcfg
from btcdet_tpu_torch.datasets import bestmatch as TB
from btcdet_tpu_torch.datasets import mini_config
from btcdet_tpu_torch.datasets.kitti import kitti_infos as TI
from btcdet_tpu_torch.datasets.synthetic_kitti import make_raw_kitti
from btcdet_tpu_torch.train import checkpoint as C
import torch_parity  # noqa: F401,E402  (caps torch's threads in this process)

REPO = Path(__file__).resolve().parent.parent
N_FRAMES, N_TRAIN = 7, 4          # 2 steps an epoch at B=2
OCC_PREFIX = "occ_modules."


def _load_cli(path=REPO / "tools" / "train_torch.py", name="train_torch_cli"):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _plain(tree):
    return json.loads(json.dumps(tree))


def micro_train_data_cfg(root):
    """The micro config's DATA_CONFIG reading the tree at `root`, points
    and boxes outside its 6.4 m scene dropped first, with the flagship
    yaml's DATA_AUGMENTOR."""
    d = mini_config.micro_data_cfg(with_occ=True)
    d.update({"DATASET": "KittiDataset", "DATA_PATH": str(root),
              "DATA_SPLIT": {"train": "train", "test": "val"},
              "INFO_PATH": {"train": ["kitti_infos_train.pkl"], "test": ["kitti_infos_val.pkl"]},
              "FOV_POINTS_ONLY": False, "MAX_POINTS_PER_FRAME": 2048, "MAX_GT_BOXES": 8,
              "MAX_BM_POINTS": 2048,
              "DATA_AUGMENTOR": _plain(tcfg.flagship().DATA_CONFIG.DATA_AUGMENTOR)})
    d["DATA_PROCESSOR"] = [{"NAME": "mask_points_and_boxes_outside_range",
                            "REMOVE_OUTSIDE_BOXES": True}] + list(d["DATA_PROCESSOR"])
    return _plain(d)


@pytest.fixture(scope="module")
def micro_train(tmp_path_factory):
    """A micro-scale KITTI tree with its infos, gt and best-match
    databases, and the micro config as a yaml reading it (the occ-vis
    views every 2 steps)."""
    tmp = tmp_path_factory.mktemp("train_cli")
    root = tmp / "kitti"
    make_raw_kitti(root, n_frames=N_FRAMES, n_train=N_TRAIN, seed=6, cars_per_frame=1,
                   n_background=3000, x_range=(3.0, 3.4), y_range=(-0.4, 0.4))
    TI.create_kitti_infos(root, workers=2)
    TB.create_best_match_db(root, class_names=("Car",), splits=("train",))
    model = _plain(mini_config.micro_model_cfg(with_occ=True))
    model["OCC"]["OCC_PNT_UPDATE"]["VIS"] = {"STEP_STRIDE": 2, "OCC_VOX": True,
                                             "PRED_FORE_VIEW": True, "OUTPUT_CLOUD": True}
    cfg = {"CLASS_NAMES": ["Car"], "DATA_CONFIG": micro_train_data_cfg(root), "MODEL": model,
           "OPTIMIZATION": _plain(mini_config.mini_opt_cfg(0.01)),
           "OCC_OPTIMIZATION": _plain(mini_config.mini_opt_cfg(0.003))}
    cfg_file = tmp / "micro_kitti_train.yaml"
    cfg_file.write_text(yaml.safe_dump(cfg, sort_keys=False))
    return tmp, cfg_file


def run(cfg_file, out, *extra, sets=(), **hooks):
    argv = ["--cfg_file", str(cfg_file), "--device", "cpu", "--workers", "0", "--batch_size",
            "2", "--output_dir", str(out), *extra,
            "--set", "MODEL.ROI_HEAD.APPROX_QUERY", "False", *sets]
    return _load_cli().main(argv, **hooks)


def ckpt_state(out, step):
    return C.load_file(C.CheckpointManager(Path(out) / "ckpt").path(step))


def assert_states_equal(a, b, path="state"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            assert_states_equal(a[k], b[k], f"{path}.{k}")
    elif torch.is_tensor(a):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    else:
        assert a == b, path


@pytest.fixture(scope="module")
def straight(micro_train):
    """Two epochs in one run (the reference to resume against)."""
    tmp, cfg_file = micro_train
    return run(cfg_file, tmp / "straight", "--epochs", "2", "--num_epochs_to_eval", "0",
               "--steps", "2")


def test_cli_trains_saves_rotates_and_evaluates(micro_train):
    tmp, cfg_file = micro_train
    out = tmp / "full"
    res = run(cfg_file, out, "--epochs", "3", "--max_ckpt_save_num", "2",
              "--num_epochs_to_eval", "1", "--vis_stride", "1", "--steps", "2")
    assert res["steps_per_epoch"] == 2 and res["steps_run"] == 6 and res["start_step"] == 0
    assert [s for s, _ in res["history"]] == list(range(6))
    for _, m in res["history"]:
        assert all(np.isfinite(v) for v in m.values()), m
        assert {"loss", "occ_loss", "rpn_loss", "rcnn_loss", "grad_norm_det",
                "grad_norm_occ"} <= m.keys()
    assert C.CheckpointManager(out / "ckpt").all_steps() == [4, 6]
    (step, result), = res["eval"]
    assert step == 6
    ap = {k: v for k, v in result.items() if k.startswith("Car_")}
    assert "Car_3d/moderate_R40" in ap and all(np.isfinite(float(v)) for v in ap.values())
    assert (out / "eval" / "eval_with_train" / "eval_list_val.txt").read_text().split() == ["6"]
    val_txt = sorted(p.name for p in (out / "eval" / "eval_with_train" / "step_6" / "val")
                     .glob("*.txt"))
    assert val_txt == [f"{i:06d}.txt" for i in range(N_TRAIN, N_FRAMES)]
    assert (out / "micro_kitti_train.yaml").exists() and list(out.glob("train_*.log"))
    assert len(list((out / "cloud").glob("pc_*.npy"))) == 6
    vis = sorted((out / "cloud").glob("occ_vis_*.npy"))
    assert [p.name for p in vis] == ["occ_vis_2.npy", "occ_vis_4.npy", "occ_vis_6.npy"]
    pc = np.load(vis[0], allow_pickle=True).item()
    assert {"occ_center", "proboccpoints", "gt_points", "gt_boxes"} <= pc.keys()
    assert set(res["time_ms"]) == {"loader", "step", "host"}


def test_resume_equals_an_unbroken_run(micro_train, straight):
    """Epoch 0, a cut after its checkpoint, then an auto-resumed epoch 1:
    the same weights, BN statistics and optimizer state as two epochs in
    one run, bit for bit, and the same metrics at the resumed steps."""
    tmp, cfg_file = micro_train
    out = tmp / "resumed"
    cut = run(cfg_file, out, "--epochs", "2", "--num_epochs_to_eval", "0", "--steps", "2",
              on_epoch_end=lambda epoch, step: True)
    assert cut["stopped"] and cut["steps_run"] == 2
    assert C.CheckpointManager(out / "ckpt").all_steps() == [2]
    res = run(cfg_file, out, "--epochs", "2", "--num_epochs_to_eval", "0", "--steps", "2")
    assert res["start_step"] == 2 and res["steps_run"] == 2
    assert C.CheckpointManager(out / "ckpt").all_steps() == [2, 4]
    assert_states_equal(ckpt_state(out, 4), ckpt_state(tmp / "straight", 4))
    assert_states_equal(ckpt_state(out, 2), ckpt_state(tmp / "straight", 2))
    assert straight["steps_run"] == 4
    assert cut["history"] + res["history"] == straight["history"]


def test_pre_occ_with_occ_lr_zero_freezes_the_occ_partition(micro_train, straight):
    tmp, cfg_file = micro_train
    out = tmp / "pre_occ"
    run(cfg_file, out, "--epochs", "1", "--num_epochs_to_eval", "0", "--pre_occ",
        str(tmp / "straight" / "ckpt"), sets=("OCC_OPTIMIZATION.LR", "0.0"))
    loaded = ckpt_state(tmp / "straight", 4)["model_state"]
    after = ckpt_state(out, 2)["model_state"]
    from btcdet_tpu_torch.models import build_network

    cfg = tcfg.cfg_from_yaml_file(cfg_file)
    cfg.MODEL.ROI_HEAD.APPROX_QUERY = False
    params = {n for n, _ in build_network(cfg.MODEL, cfg.DATA_CONFIG, ["Car"],
                                          device="cpu").named_parameters()}
    occ = sorted(n for n in params if n.startswith(OCC_PREFIX))
    det = sorted(n for n in params if not n.startswith(OCC_PREFIX))
    assert occ and det
    for n in occ:
        assert torch.equal(after[n], loaded[n]), n
    assert sum(not torch.equal(after[n], loaded[n]) for n in det) > 0.9 * len(det)


def test_cli_trains_on_synthetic_batches(micro_train):
    """`--synthetic`: no dataset, `make_synthetic_batch` frames, no
    trailing eval."""
    tmp, cfg_file = micro_train
    res = run(cfg_file, tmp / "synthetic", "--synthetic", "--epochs", "1", "--steps", "2")
    assert res["steps_run"] == 2 and res["eval"] == []
    assert all(np.isfinite(m["loss"]) for _, m in res["history"])
    assert C.CheckpointManager(tmp / "synthetic" / "ckpt").all_steps() == [2]


def test_cli_profiles_a_window_of_steps(micro_train):
    """`--profile_steps A-B` traces global steps A..B-1, and a window the
    run ends inside is closed at its last step."""
    tmp, cfg_file = micro_train
    for window, name in (("1-3", "steps_1_3.json"), ("3-99", "steps_3_4.json")):
        out = tmp / f"profile_{window}"
        res = run(cfg_file, out, "--synthetic", "--epochs", "1", "--steps", "4",
                  "--profile_steps", window)
        prof, wall = res["profile"]
        assert wall > 0 and [p.name for p in (out / "profile").iterdir()] == [name]


def test_cli_without_a_card_fails_with_resolve_devices_error(micro_train, tmp_path):
    _, cfg_file = micro_train
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    r = subprocess.run([sys.executable, "tools/train_torch.py", "--cfg_file", str(cfg_file),
                        "--output_dir", str(tmp_path)],
                       capture_output=True, text=True, cwd=str(REPO), env=env, timeout=300)
    assert r.returncode != 0
    assert "no CUDA device is available" in r.stderr, r.stderr[-2000:]


@pytest.mark.parametrize("launcher", ["slurm", "pytorch"])
def test_launchers_other_than_none_are_refused(micro_train, tmp_path, launcher, monkeypatch):
    """Without its launcher's environment (srun's SLURM_* or torchrun's
    RANK / WORLD_SIZE / ...) a --launcher run is refused, naming what is
    missing (tests/test_torch_dist.py runs them under their launchers)."""
    _, cfg_file = micro_train
    for k in [k for k in os.environ if k.startswith("SLURM_")] + [
            "RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"]:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match=f"--launcher {launcher} reads .* missing: "):
        run(cfg_file, tmp_path, "--launcher", launcher)


def test_first_step_loss_terms_match_jax(micro_train):
    """The port's training batch (frames 0 and 1, epoch 0) and the JAX
    package's batch of the same frames from the same tree are equal; one
    train step of each package on it, from bridged weights with the same
    roi draws, gives the same loss terms to 1e-3."""
    from test_torch_train import train_step_both
    from torch_parity import assert_close, full_micro_cfgs

    from btcdet_tpu import config as jcfg
    from btcdet_tpu.datasets.kitti.kitti_dataset import KittiDataset as JaxKitti
    from btcdet_tpu_torch.datasets.kitti.kitti_dataset import KittiDataset

    tmp, _ = micro_train
    root = tmp / "kitti"
    d = micro_train_data_cfg(root)
    port = KittiDataset(tcfg.EasyDict(copy.deepcopy(d)), ["Car"], training=True)
    ref = JaxKitti(jcfg.EasyDict(copy.deepcopy(d)), ["Car"], training=True)
    batch = port.collate_batch([port[0], port[1]])
    jbatch = ref.collate_batch([ref[0], ref[1]])
    for k, v in batch.items():
        if k != "frame_id":
            assert v.dtype == jbatch[k].dtype and np.array_equal(v, jbatch[k]), k
    assert batch["bm_points_mask"].any()
    data_cfg, model_cfg = full_micro_cfgs(DP_RATIO=0.0)
    for k in ("MAX_POINTS_PER_FRAME", "MAX_GT_BOXES", "MAX_BM_POINTS", "DATA_PROCESSOR"):
        data_cfg[k] = d[k]
    res = train_step_both(data_cfg, model_cfg, 0, 0,
                          batch_np={k: v for k, v in jbatch.items() if k != "frame_id"})
    ref_m, out = res["ref_metrics"], res["metrics"]
    assert set(ref_m) <= set(out), set(ref_m) - set(out)
    for k in ref_m:
        assert np.isfinite(out[k]), k
        assert_close(out[k], ref_m[k], rtol=1e-3, atol=1e-3, err_msg=k)
    assert ref_m["occ_loss"] > 0 and ref_m["rpn_loss_loc"] > 0
