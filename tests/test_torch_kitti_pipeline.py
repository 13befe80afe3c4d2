"""The port's KITTI host pipeline against the JAX package's, on a synthetic
on-disk KITTI tree: the written tree, the infos and gt database, every
val frame's `KittiDataset[i]` and the collated batch bit for bit, and the
host voxelizer (C++ core and numpy twin) on a KITTI-size cloud."""

import copy
import filecmp
import pickle

import numpy as np
import pytest
import torch
from test_kitti_pipeline import data_cfg as jax_data_cfg

from btcdet_tpu.datasets.kitti import kitti_infos as JI
from btcdet_tpu.datasets.kitti.kitti_dataset import KittiDataset as JaxKitti
from btcdet_tpu.datasets.synthetic_kitti import make_raw_kitti as jax_make_raw_kitti
from btcdet_tpu.ops import voxelizer as JV
from btcdet_tpu_torch import config as tcfg
from btcdet_tpu_torch.datasets import make_synthetic_batch
from btcdet_tpu_torch.datasets.kitti import kitti_infos as TI
from btcdet_tpu_torch.datasets.kitti.kitti_dataset import KittiDataset, to_device
from btcdet_tpu_torch.datasets.synthetic_kitti import make_raw_kitti
from btcdet_tpu_torch.ops import voxelizer as TV
import torch_parity  # noqa: F401,E402  (caps torch's threads in this process)

N_FRAMES, N_TRAIN = 6, 3


def assert_same(a, b, path="root"):
    """Equal bit for bit: same structure, keys, types, dtypes and values."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (path, a.keys(), b.keys())
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, (
            path, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and (a == b or (a != a and b != b)), (path, a, b)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """The same raw tree twice, infos and gt database made by the port in
    one and by the JAX package in the other."""
    port = tmp_path_factory.mktemp("kitti_port")
    ref = tmp_path_factory.mktemp("kitti_jax")
    make_raw_kitti(port, n_frames=N_FRAMES, n_train=N_TRAIN, seed=4, cars_per_frame=3)
    jax_make_raw_kitti(ref, n_frames=N_FRAMES, n_train=N_TRAIN, seed=4, cars_per_frame=3)
    TI.create_kitti_infos(port, workers=2)
    JI.create_kitti_infos(ref, workers=2)
    return port, ref


def test_synthetic_tree_is_the_jax_packages(roots):
    port, ref = roots
    for sub in ("training/velodyne", "training/calib", "training/label_2", "training/planes",
                "ImageSets"):
        names = sorted(p.name for p in (ref / sub).iterdir())
        assert names == sorted(p.name for p in (port / sub).iterdir()), sub
        match, mismatch, errors = filecmp.cmpfiles(port / sub, ref / sub, names, shallow=False)
        assert not mismatch and not errors, (sub, mismatch, errors)


@pytest.mark.parametrize("name", ["kitti_infos_train.pkl", "kitti_infos_val.pkl",
                                  "kitti_infos_trainval.pkl", "kitti_dbinfos_train.pkl"])
def test_infos_and_gt_database_match(roots, name):
    port, ref = roots
    with open(port / name, "rb") as f:
        a = pickle.load(f)
    with open(ref / name, "rb") as f:
        b = pickle.load(f)
    assert len(a) > 0
    assert_same(a, b)
    if name.startswith("kitti_dbinfos"):
        files = sorted(p.name for p in (ref / "gt_database").iterdir())
        assert len(files) == N_TRAIN * 3
        _, mismatch, errors = filecmp.cmpfiles(port / "gt_database", ref / "gt_database", files,
                                               shallow=False)
        assert not mismatch and not errors


def _cfgs(root, fov: bool, caps: bool):
    d = jax_data_cfg(root)
    d["FOV_POINTS_ONLY"] = fov
    if caps:
        # below the frames' sizes: collate truncates points, the voxelizers drop voxels
        d["MAX_POINTS_PER_FRAME"] = 2500
        d["MAX_GT_BOXES"] = 2
        for proc in d["DATA_PROCESSOR"]:
            if "MAX_NUMBER_OF_VOXELS" in proc:
                proc["MAX_NUMBER_OF_VOXELS"] = {"train": 700, "test": 700}
    return d, tcfg.EasyDict(copy.deepcopy(dict(d)))


@pytest.mark.parametrize("fov,caps", [(True, False), (False, False), (True, True)],
                         ids=["fov", "all_points", "small_caps"])
def test_val_batches_match_bit_for_bit(roots, fov, caps):
    port_root, ref_root = roots
    jcfg, pcfg = _cfgs(ref_root, fov, caps)
    ref = JaxKitti(jcfg, ["Car"], training=False, root_path=ref_root)
    port = KittiDataset(pcfg, ["Car"], training=False, root_path=port_root)
    assert len(port) == len(ref) == N_FRAMES - N_TRAIN
    items = []
    for i in range(len(ref)):
        a, b = port[i], ref[i]
        assert_same(a, b, f"frame {i}")
        items.append((a, b))
    if caps:
        assert all(len(a["points"]) > port.max_points for a, _ in items)
        assert all(int((a["occ_voxel_num_points"] > 0).sum()) == 700 for a, _ in items)
    batch = port.collate_batch([a for a, _ in items])
    assert_same(batch, ref.collate_batch([b for _, b in items]))
    assert batch["frame_id"] == [f"{i:06d}" for i in range(N_TRAIN, N_FRAMES)]


def test_to_device_matches_the_synthetic_batch(roots):
    """A collated batch on the device has the synthetic batch's keys,
    dtypes and ranks (plus frame_id, kept on the host)."""
    port_root, _ = roots
    _, pcfg = _cfgs(port_root, True, False)
    ds = KittiDataset(pcfg, ["Car"], training=False, root_path=port_root)
    got = to_device(ds.collate_batch([ds[0], ds[1]]), "cpu")
    want = make_synthetic_batch(pcfg, batch_size=2, num_points=512, num_gt=3, mode="test",
                                device="cpu")
    assert got.keys() - {"frame_id"} == want.keys()
    assert got["frame_id"] == ["000003", "000004"]
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].ndim == v.ndim, k
        assert got[k].shape[0] == v.shape[0] and got[k].shape[2:] == v.shape[2:], k


def test_training_with_the_augmentor_is_refused(roots):
    """A training dataset builds the yaml's augmentor queue
    (`datasets/augmentor.py`, held to the JAX package in
    tests/test_torch_train_pipeline.py); an augmentor neither package has
    is refused."""
    port_root, _ = roots
    _, pcfg = _cfgs(port_root, True, False)
    ds = KittiDataset(pcfg, ["Car"], training=True, root_path=port_root)
    assert [n for n, _ in ds.data_augmentor.queue][:2] == ["gt_sampling", "add_multi_best_match"]
    pcfg.DATA_AUGMENTOR.AUG_CONFIG_LIST.append(tcfg.EasyDict({"NAME": "random_world_shear"}))
    with pytest.raises(NotImplementedError, match="random_world_shear"):
        KittiDataset(pcfg, ["Car"], training=True, root_path=port_root)


@pytest.mark.parametrize("max_voxels", [200_000, 30_000], ids=["above", "below"])
def test_host_voxelizer_matches(max_voxels):
    """C++ core == numpy twin == the JAX package's `voxelize_np`, bit for
    bit, on a 120 000-point cloud with the flagship's det grid, with the
    voxel cap above and below the cloud's voxel count."""
    rng = np.random.RandomState(0)
    pts = np.concatenate([rng.uniform([0, -40, -3], [70.4, 40, 1], (120_000, 3)),
                          rng.rand(120_000, 1)], axis=1).astype(np.float32)
    # points on cell boundaries, and outside the range
    pts[:500, :3] = np.round(pts[:500, :3] * 20) / 20
    pts[500:600, 0] = -1.0
    args = (pts, [0, -40, -3, 70.4, 40, 1], [0.05, 0.05, 0.1], 5, max_voxels)
    got = TV.voxelize_np(*args)
    n_vox = int((got[2] > 0).sum())
    assert (n_vox == max_voxels) == (max_voxels < 120_000)
    for want in (TV.voxelize_np_plain(*args), JV.voxelize_np(*args)):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_host_voxelizer_builds_or_raises(monkeypatch, tmp_path):
    """A failed g++ build raises; it never gives way to numpy."""
    from btcdet_tpu_torch.ops import kernel_build

    monkeypatch.setattr(kernel_build, "_LIBS", {})
    monkeypatch.setattr(kernel_build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for voxelizer_core.cpp"):
        TV.voxelize_np(np.zeros((4, 4), np.float32), [0, 0, 0, 1, 1, 1], [0.5, 0.5, 0.5], 2, 8)


def test_synthetic_batch_uses_the_host_voxelizer():
    """The synthetic batch's voxel tables come out of `voxelize_np`."""
    from btcdet_tpu_torch.datasets import synthetic

    assert synthetic.voxelize_np is TV.voxelize_np
    d = tcfg.EasyDict(jax_data_cfg("/nonexistent"))
    b = synthetic.make_synthetic_batch_np(d, batch_size=1, num_points=2048, num_gt=2, mode="test")
    v, c, n = TV.voxelize_np_plain(b["points"][0], d.POINT_CLOUD_RANGE, [0.1, 0.1, 0.1], 5, 6000)
    np.testing.assert_array_equal(b["det_voxels"], v)
    np.testing.assert_array_equal(b["det_voxel_coords"][:, 1:], c)
    np.testing.assert_array_equal(b["det_voxel_num_points"], n)
    assert torch.is_tensor(to_device(b, "cpu")["det_voxels"])
