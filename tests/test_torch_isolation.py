"""The port stands alone: importing `btcdet_tpu_torch` (every submodule),
`chip_smoke.py`, `tools/test_torch.py` or `tools/train_torch.py` loads
neither JAX, flax, orbax
nor the JAX package; the smoke script refuses to run without a card or
outside the repository."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_CHECK = """
import importlib, pkgutil, sys
sys.path.insert(0, {repo!r})
import btcdet_tpu_torch
names = [m.name for m in pkgutil.walk_packages(btcdet_tpu_torch.__path__, "btcdet_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
import importlib.util
for cli in ("test_torch", "train_torch"):
    spec = importlib.util.spec_from_file_location(cli + "_cli", {repo!r} + "/tools/" + cli + ".py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "flax", "orbax", "btcdet_tpu"))
print(len(names), "modules")
print(" ".join(names))
assert not bad, bad
"""


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_port_imports_no_jax():
    r = subprocess.run([sys.executable, "-c", _CHECK.format(repo=str(REPO))],
                       capture_output=True, text=True, env=_env(), cwd=str(REPO), timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    lines = r.stdout.splitlines()
    assert int(lines[0].split()[0]) >= 50
    for m in ("utils.coords", "models.occ.occ_targets", "models.occ.occ_subnet",
              "ops.voxelizer", "ops.cuda_pool", "utils.loss_utils", "train.optim",
              "train.trainer", "datasets.mini_config", "datasets.kitti.kitti_dataset",
              "datasets.kitti.kitti_infos", "datasets.processor", "datasets.loader",
              "datasets.synthetic_kitti", "eval.kitti_eval", "train.checkpoint",
              "train.eval_utils", "datasets.augmentor", "datasets.bestmatch",
              "utils.vis_utils"):
        assert f"btcdet_tpu_torch.{m}" in lines[1].split(), m


def test_chip_smoke_fails_without_a_card():
    r = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True, text=True,
                       env={**_env(), "CUDA_VISIBLE_DEVICES": ""}, cwd=str(REPO), timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True, text=True,
                       env=_env(), cwd=str(tmp_path), timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
