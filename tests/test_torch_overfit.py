"""The port's overfit-to-convergence proof, `tools/overfit_proof_torch.py`,
against the JAX package's `tools/overfit_proof.py`: its `write_cfg` gives
the same merged config for the car and the 3-class yaml, its `build_data`
writes the same tree, infos, gt database and best-match database bit for
bit; the script end to end on the CPU on the micro config (a few steps,
the summary's keys, finite AP keys at both occ populations, the per-gt box
errors of `tools/overfit_box_errors_torch.py`, the diagnosis of
`tools/overfit_diag_torch.py`), where `--fresh` wipes a finished run dir,
so that training runs again instead of auto-resuming past its last epoch,
and a run cut halfway and resumed equals a straight one; and the item
cache of `--cache_items` (`loader.CachedDataset`). The proof itself runs
on the card:
`python3 chip_smoke.py --overfit [--three_classes]`."""

import importlib.util
import math
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml
from test_torch_kitti_pipeline import assert_same
from test_torch_train_cli import _plain, micro_train_data_cfg

from btcdet_tpu_torch import config as tcfg
from btcdet_tpu_torch.datasets import loader, mini_config, set_epoch
import torch_parity  # noqa: F401,E402  (caps torch's threads in this process)

REPO = Path(__file__).resolve().parent.parent
# the micro config's 6.4 m scene (tests/test_torch_train_cli.py's tree)
MICRO_TREE = dict(x_range=(3.0, 3.4), y_range=(-0.4, 0.4), n_background=3000)
SUMMARY_KEYS = {"epochs", "frames", "classes", "cars_per_frame", "first_loss", "final_loss",
                "min_loss", "ap", "ap_occ2048", "epoch_loss", "wall_s", "steps_per_s", "card",
                "drops"}


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def port():
    return _load(REPO / "tools" / "overfit_proof_torch.py", "overfit_proof_torch")


@pytest.fixture
def jax_proof(monkeypatch):
    """tools/overfit_proof.py, which changes into the repo at import: the
    working directory is restored afterwards."""
    monkeypatch.chdir(REPO)
    mod = _load(REPO / "tools" / "overfit_proof.py", "overfit_proof_jax")
    monkeypatch.delitem(sys.modules, "overfit_proof_jax", raising=False)
    return mod


@pytest.mark.parametrize("base_yaml", ["btcdet_kitti_car.yaml", "btcdet_kitti_3classes.yaml"])
def test_write_cfg_matches_jax(port, jax_proof, tmp_path, base_yaml):
    rel = f"tools/cfgs/model_configs/{base_yaml}"
    root = tmp_path / "data"
    ref = yaml.safe_load(jax_proof.write_cfg(root, tmp_path / "jax.yaml", rel).read_text())
    out = yaml.safe_load(port.write_cfg(root, tmp_path / "port.yaml", rel).read_text())
    assert out == ref
    assert out["MODEL"]["BACKBONE_3D"]["LEVEL_CAPACITIES"]["test"] == [36000, 26000, 13000,
                                                                        10000]
    assert "APPROX_QUERY" not in out["MODEL"]["ROI_HEAD"]   # the yaml's default: approximate


def _tree(root: Path) -> dict:
    return {str(p.relative_to(root)): p for p in sorted(root.rglob("*")) if p.is_file()}


def test_build_data_matches_jax_bit_for_bit(port, jax_proof, tmp_path):
    """3 frames x 2 cars: the raw tree, the infos, the gt database and the
    best-match database, file by file (pickles loaded and compared)."""
    ref_root, out_root = tmp_path / "jax", tmp_path / "port"
    jax_proof.build_data(ref_root, 3, 2)
    port.build_data(out_root, 3, 2)
    ref, out = _tree(ref_root), _tree(out_root)
    assert out.keys() == ref.keys()
    assert {"kitti_infos_train.pkl", "kitti_infos_val.pkl", "kitti_dbinfos_train.pkl"} <= ref.keys()
    assert sum(k.startswith("bm_") for k in ref) == 6
    for name, p in ref.items():
        if name.endswith(".pkl"):
            with open(p, "rb") as f, open(out[name], "rb") as g:
                assert_same(pickle.load(g), pickle.load(f), name)
        else:
            assert out[name].read_bytes() == p.read_bytes(), name


@pytest.fixture(scope="module")
def micro_yaml(tmp_path_factory):
    """The micro config (the flagship's topology on a 6.4 m scene) as a
    yaml with the flagship yaml's augmentor chain and its point shuffle (a
    draw that gt sampling and the world augmentations being off leave in
    a training item)."""
    tmp = tmp_path_factory.mktemp("overfit_micro")
    data = micro_train_data_cfg(tmp / "unused")
    shuffle, = [p for p in tcfg.flagship().DATA_CONFIG.DATA_PROCESSOR
                if p["NAME"] == "shuffle_points"]
    data["DATA_PROCESSOR"].insert(1, _plain(shuffle))
    cfg = {"CLASS_NAMES": ["Car"], "DATA_CONFIG": data,
           "MODEL": _plain(mini_config.micro_model_cfg(with_occ=True)),
           "OPTIMIZATION": _plain(mini_config.mini_opt_cfg(0.01)),
           "OCC_OPTIMIZATION": _plain(mini_config.mini_opt_cfg(0.003))}
    path = tmp / "micro.yaml"
    path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    return tmp, path


def test_script_end_to_end_on_the_cpu_and_fresh_wipes_a_finished_run(port, micro_yaml):
    """Two epochs of 2 steps, then the diagnosis of every frame holding a
    matched gt (the CPU and the device are one here); the same again
    without --fresh trains nothing; with --fresh and a cut after the first
    epoch, resumed in a second call, it trains again and equals the
    straight run bit for bit."""
    tmp, cfg = micro_yaml
    root = tmp / "output"
    argv = ["--epochs", "2", "--frames", "4", "--cars_per_frame", "1", "--workers", "0",
            "--device", "cpu", "--root", str(root), "--base_yaml", str(cfg),
            "--set", "MODEL.BACKBONE_3D.LEVEL_CAPACITIES", "None"]
    first = port.main(["--fresh"] + argv, tree=MICRO_TREE)
    assert SUMMARY_KEYS <= first.keys()
    assert first["start_step"] == 0 and first["steps_run"] == 4 and first["steps_per_epoch"] == 2
    assert first["resumed_at_step"] is None
    assert len(first["epoch_loss"]) == 2 and first["card"] == "cpu"
    for key in ("ap", "ap_occ2048"):
        ap = first[key]
        assert "Car_3d/moderate_R40" in ap and "Car_aos/hard_R40" in ap, key
        assert len(ap) == 12 and all(math.isfinite(v) for v in ap.values()), (key, ap)
    assert all(math.isfinite(first[k]) for k in ("first_loss", "final_loss", "min_loss"))
    phases = {"train", "eval", "eval_occ2048", "eval_default"}
    assert phases <= first["drops"]["merged_table"].keys()
    headings = first["heading_errors"]["occ2048"]
    assert headings["gt"] == 4 and len(headings["worst"]) == headings["gt"] - headings["unmatched"]
    work, run_dir = root / "overfit_torch", root / "btcdet_overfit_torch"
    assert (work / "summary.json").exists() and (work / "ap_tables.log").exists()
    boxes = _load(REPO / "tools" / "overfit_box_errors_torch.py", "overfit_box_errors").main(
        ["--dets", str(run_dir / "eval" / "eval_with_train" / "step_4" / "val"),
         "--labels", str(work / "data" / "training" / "label_2")])
    assert boxes["gt"] == 4 and boxes["below"] + boxes["missed"] <= 4
    assert all(r["iou3d"] < 0.7 for r in boxes["below_min_iou"])
    diag = _load(REPO / "tools" / "overfit_diag_torch.py", "overfit_diag").main(
        ["--device", "cpu", "--root", str(root), "--workers", "0",
         "--set", "MODEL.BACKBONE_3D.LEVEL_CAPACITIES", "None"])
    assert diag["step"] == 4 and diag["default"]["box_errors"] == [boxes]
    assert diag["low_frames"] == sorted({r["frame"] for r in boxes["below_min_iou"]})
    assert diag["low_frames"], boxes
    for key in ("device_bf16", "cpu_bf16", "device_f32"):
        assert set(diag[key]["against_device_bf16"]) == set(diag["low_frames"]), key
    for d in diag["cpu_bf16"]["against_device_bf16"].values():   # the same run here
        assert d["max_abs_box_diff"] in (0.0, None), d
    for key in ("default_train_headroom", "occ2048_full_headroom"):
        assert diag[key]["ap"].keys() == first["ap"].keys(), key
    # without --fresh the CLI auto-resumes at the last step: nothing trains
    again = port.main(argv, tree=MICRO_TREE)
    assert again["start_step"] == 4 and again["steps_run"] == 0
    for marker in (work / "data" / "stale", run_dir / "stale"):
        marker.write_text("")
    fresh = port.main(["--fresh", "--cut_and_resume"] + argv, tree=MICRO_TREE)
    assert fresh["start_step"] == 0 and fresh["resumed_at_step"] == 2
    assert fresh["steps_run"] == 4
    assert not (work / "data" / "stale").exists() and not (run_dir / "stale").exists()
    for k in ("epoch_loss_terms", "ap", "ap_occ2048", "heading_errors"):
        assert fresh[k] == first[k], k


class _Draws:
    """Items made of their epoch's draw, as `KittiDataset`'s point shuffle
    (`RandomState` of the dataset's `_epoch` and the index)."""

    def __init__(self, n: int):
        self.n, self._epoch = n, 0

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.random.RandomState(self._epoch * 131071 + i * 8191).rand(3)


def _cached_run(epochs, n=5):
    """The items of each epoch's batches through `CachedDataset` and the
    training loader (shuffled, the last partial batch dropped), and the cache."""
    ds = _Draws(n)
    cached = loader.CachedDataset(ds)
    dl = loader.make_loader(cached, 2, shuffle=True, collate_fn=list, drop_last=True)
    out = {}
    for epoch in epochs:
        set_epoch(ds, dl, epoch)
        out[epoch] = [[item.tolist() for item in b] for b in dl]
        assert ds._epoch == epoch    # restored after each fill
    return out, cached


def test_cached_items_take_epoch_0_draws_and_resume_as_unbroken():
    """An item first read at a later epoch (one that epoch 0's dropped
    batch skipped) is cached with its epoch-0 draws, and a run resumed at
    epoch 2 reads the batches an unbroken run reads there. The JAX
    package's `tools/train.py --cache_items` caches an item with the draws
    of the epoch that first reads it."""
    unbroken, cache = _cached_run(range(4))
    skipped = set(range(5)) - {i for b in loader.make_loader(
        list(range(5)), 2, shuffle=True, drop_last=True) for i in b.tolist()}
    assert skipped   # epoch 0's order leaves one item out
    epoch0 = _Draws(5)
    for i in range(5):
        np.testing.assert_array_equal(cache._cache[i], epoch0[i])
    resumed, _ = _cached_run(range(2, 4))
    assert resumed == {e: unbroken[e] for e in (2, 3)}
