"""`bench.py`'s batch of 8 frames, and the fast-eval yaml.

The full micro config with the yaml's approximate ball query (the
shipped flagship's default), eval forward + post-processing at B=8: the
port against the JAX package on the same batch and weights (f32, at the
tolerances of tests/test_torch_model.py), and each frame of the port's
B=8 run against the port's run of a smaller batch holding that frame, bit
for bit against the B=2 batch of the same seed for frames 0-1 (the
synthetic batch draws its frames in sequence, so they are the same
frames). Frame 7 against a B=1 batch sliced from the B=8 one: its
discrete outputs (occ points kept, rois, detections kept, labels) exactly
and its floats to 1e-4. On the CPU they part in the last bits: torch's
vectorised elementwise loops and oneDNN's conv blocking depend on where a
frame lies in the tensor (frames 6-7 at B=2 give frame 7's scores 1 ulp
apart from B=8's, frame 7 alone the occ probabilities 1 ulp apart), not on
the other frames' values. Every capacity is a frame's own, so no frame
sees another.

Also `config.fast20k()`: the port's loading of
`btcdet_kitti_car_fast20k.yaml` equals the JAX package's, key for key."""

import functools

import numpy as np
import pytest
import torch

from torch_parity import assert_close, f32_mode, full_micro_cfgs, run_both

B = 8


@functools.cache
def b8_run() -> dict:
    from btcdet_tpu.config import EasyDict

    data_cfg, model_cfg = full_micro_cfgs(APPROX_QUERY=True)
    return run_both(EasyDict({"DATA_CONFIG": data_cfg, "MODEL": model_cfg}), 2048, 4,
                    batch_size=B)


def frame_rows(batch: dict, n: int, key: str) -> int:
    """The rows a frame holds in `batch[key]`: every key is (frames, ...) or
    frames x a fixed number of rows (the voxel tables)."""
    return batch[key].shape[0] // n


def take_frames(batch: dict, n: int, frames) -> dict:
    """The frames `frames` (in order) of a numpy batch of `n` frames, as a
    batch of its own: each key's blocks of rows, the voxel tables'
    frame column renumbered."""
    out = {}
    for k, v in batch.items():
        r = frame_rows(batch, n, k)
        v = np.concatenate([v[f * r:(f + 1) * r] for f in frames])
        if k.endswith("voxel_coords"):
            new = np.repeat(np.arange(len(frames), dtype=v.dtype), r)
            v = v.copy()
            v[:, 0] = np.where(v[:, 0] >= 0, new, v[:, 0])
        out[k] = v
    return out


def port_run(net, batch_np: dict, post_cfg) -> dict:
    """The port's eval forward + post-processing on a numpy batch, in f32:
    every array of both, as numpy."""
    from btcdet_tpu_torch.models.detectors.btcnet import post_processing

    tb = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch_np.items()}
    with f32_mode(), torch.no_grad():
        out = net(tb)
        post = post_processing(out, post_cfg, 1, device="cpu")
    arrays = {k: v.numpy() for k, v in out.items() if torch.is_tensor(v)}
    arrays.update({"post." + k: v.numpy() for k, v in post.items()})
    return arrays


# rows of a sparse table: each frame's sites in key order, packed from the
# top (a frame's rows start where the frame before it ends)
PACKED = ("encoded_features",)


def per_frame(arrays: dict, n: int) -> dict:
    """{key: (n, rows a frame, ...)} of every array laid out frame by frame:
    the dense outputs and the roi head's (frames x rois) rows."""
    return {k: v.reshape(n, v.shape[0] // n, *v.shape[1:]) for k, v in arrays.items()
            if v.ndim and v.shape[0] % n == 0 and k not in PACKED}


def assert_frames_equal(big: dict, n_big: int, frames, small: dict, n_small: int,
                        bitwise: bool = True):
    """Frames `frames` of the `n_big`-frame run equal the `n_small`-frame
    run frame for frame in every output: bit for bit, or with `bitwise`
    off the discrete outputs exactly and the float ones to 1e-4."""
    a, b = per_frame(big, n_big), per_frame(small, n_small)
    assert a.keys() == b.keys() and {"post.pred_boxes", "occ_points", "rcnn_cls"} <= a.keys()
    for k in a:
        if bitwise or not np.issubdtype(b[k].dtype, np.floating):
            np.testing.assert_array_equal(a[k][list(frames)], b[k], err_msg=k)
        else:
            assert_close(a[k][list(frames)], b[k], err_msg=k)


def test_b8_matches_jax():
    """B=8: rois, rcnn outputs and detections to 1e-4, discrete outputs
    exact, as tests/test_torch_model.py holds B=2."""
    res = b8_run()
    ref, out, ref_post, post = res["ref"], res["out"], res["ref_post"], res["post"]
    assert not res["missing"].missing_keys and not res["missing"].unexpected_keys
    assert out["rois"].shape[0] == B and post["pred_boxes"].shape[0] == B
    np.testing.assert_array_equal(out["roi_valid"], ref["roi_valid"])
    np.testing.assert_array_equal(out["occ_points_mask"], ref["occ_points_mask"])
    assert_close(out["rois"], ref["rois"])
    assert_close(out["batch_cls_preds"], ref["batch_cls_preds"])
    assert_close(out["batch_box_preds"], ref["batch_box_preds"])
    np.testing.assert_array_equal(post["pred_valid"], ref_post["pred_valid"])
    np.testing.assert_array_equal(post["pred_labels"], ref_post["pred_labels"])
    assert_close(post["pred_scores"], ref_post["pred_scores"])
    assert_close(post["pred_boxes"], ref_post["pred_boxes"])
    assert post["pred_valid"].any(axis=1).all(), "every frame detects something"


def test_b8_frames_0_1_equal_the_b2_run_bit_for_bit():
    """A fresh B=2 draw of the same seed is frames 0-1 of the B=8 batch,
    and the port gives those frames the same bits at either batch."""
    from btcdet_tpu_torch import config as tcfg
    from btcdet_tpu_torch.datasets import make_synthetic_batch_np

    res = b8_run()
    cfg = tcfg.EasyDict(full_micro_cfgs(APPROX_QUERY=True)[0])
    b2 = make_synthetic_batch_np(cfg, batch_size=2, num_points=2048, num_gt=4, seed=0,
                                 mode="test")
    first = take_frames(res["batch"], B, [0, 1])
    assert b2.keys() == first.keys()
    for k in b2:
        np.testing.assert_array_equal(b2[k], first[k], err_msg=k)
    post_cfg = full_micro_cfgs()[1].POST_PROCESSING
    big = port_run(res["port"], res["batch"], post_cfg)
    # the port's run here is the one run_both made
    np.testing.assert_array_equal(big["post.pred_boxes"], res["post"]["pred_boxes"])
    assert_frames_equal(big, B, [0, 1], port_run(res["port"], b2, post_cfg), 2)


def test_b8_frame_7_equals_its_b1_run():
    res = b8_run()
    post_cfg = full_micro_cfgs()[1].POST_PROCESSING
    big = port_run(res["port"], res["batch"], post_cfg)
    one = port_run(res["port"], take_frames(res["batch"], B, [7]), post_cfg)
    assert one["post.pred_valid"].any()
    assert_frames_equal(big, B, [7], one, 1, bitwise=False)


def test_binding_level_capacities_cut_each_frame_alone():
    """The micro config with level capacities that cut sites (LEVEL_CAPACITIES
    below what the synthetic frames want): at B=8 the frames keep fewer
    sites than without the caps, and frames 0-1 still equal the B=2 run
    (discrete outputs exactly, floats to 1e-4; here the detections' scores
    part in their last bit), since each frame's capacity is its own
    (capacity // B a frame, the JAX package's rule)."""
    from btcdet_tpu_torch import config as tcfg
    from btcdet_tpu_torch.datasets import make_synthetic_batch_np
    from btcdet_tpu_torch.models import build_network

    res = b8_run()
    data_cfg, model_cfg = (tcfg.EasyDict(c) for c in full_micro_cfgs(APPROX_QUERY=True))
    model_cfg.BACKBONE_3D.LEVEL_CAPACITIES = {"train": [120, 80, 40, 24],
                                              "test": [120, 80, 40, 24]}
    net = build_network(model_cfg, data_cfg, ["Car"], device="cpu")
    net.load_state_dict(res["port"].state_dict())
    net.eval()
    big = port_run(net, res["batch"], model_cfg.POST_PROCESSING)
    with f32_mode(), torch.no_grad():
        tb = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in res["batch"].items()}
        nnz = net(tb)["nnz"]
    cut = {k: (nnz[k], v) for k, v in res["out"]["nnz"].items() if nnz[k] < v}
    assert {"x_conv2", "x_conv3"} <= cut.keys(), (nnz, res["out"]["nnz"])
    b2 = make_synthetic_batch_np(data_cfg, batch_size=2, num_points=2048, num_gt=4, seed=0,
                                 mode="test")
    assert_frames_equal(big, B, [0, 1], port_run(net, b2, model_cfg.POST_PROCESSING), 2,
                        bitwise=False)


def test_fast20k_loads_as_the_jax_package_does():
    """`config.fast20k()` equals the JAX package's `cfg_from_yaml_file` of
    the same yaml key for key: the flagship yaml inherited through
    `_BASE_CONFIG_`, the eval voxel caps at 20 000, the approximate query
    left unset."""
    import json

    from btcdet_tpu.config import cfg_from_yaml_file

    from btcdet_tpu_torch import config as tcfg

    port, ref = tcfg.fast20k(), cfg_from_yaml_file(tcfg.FAST20K_CFG)
    assert json.dumps(port, sort_keys=True) == json.dumps(ref, sort_keys=True)
    caps = {p.NAME: p.MAX_NUMBER_OF_VOXELS for p in port.DATA_CONFIG.DATA_PROCESSOR
            if "MAX_NUMBER_OF_VOXELS" in p}
    assert caps == {"transform_points_to_sphere_voxels": {"train": 20000, "test": 20000},
                    "det_transform_points_to_voxels": {"train": 16000, "test": 20000}}, caps
    flag = tcfg.flagship_shipped()
    assert "APPROX_QUERY" not in port.MODEL.ROI_HEAD
    assert port.MODEL == flag.MODEL and port.OPTIMIZATION == flag.OPTIMIZATION
    assert "_BASE_CONFIG_" not in port.DATA_CONFIG
    assert {k: v for k, v in port.DATA_CONFIG.items() if k != "DATA_PROCESSOR"} == {
        k: v for k, v in flag.DATA_CONFIG.items() if k != "DATA_PROCESSOR"}
