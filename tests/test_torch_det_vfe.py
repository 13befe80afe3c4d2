"""The micro model's eval forward in the port against the JAX package
under the det VFE options and the BEV options: OCC_PNT_UPDATE.FUSED_VFE
False (the materialized merged table, MERGE_IMPL v1 and v2, reduced by
OccVFE), VFE.NAME MeanVFE with the occ subnet (no occ code, no side
branch), a fractional BACKBONE_2D.UPSAMPLE_STRIDES (a strided 1x1 conv,
anchors at the coarser stride) and DATA_CONFIG.CLAMP tanh. CPU, float32,
exact ball queries, one JAX run per config (`torch_parity.run_both`)."""

import functools

import numpy as np
import pytest

from test_torch_det_options import assert_eval_matches
from torch_parity import assert_close, full_micro_cfgs, run_both


def _unfused(model_cfg, data_cfg, impl):
    model_cfg.OCC.OCC_PNT_UPDATE.FUSED_VFE = False
    model_cfg.OCC.OCC_PNT_UPDATE.MERGE_IMPL = impl


def _mean_vfe(model_cfg, data_cfg):
    model_cfg.VFE.NAME = "MeanVFE"


def _fractional(model_cfg, data_cfg):
    model_cfg.BACKBONE_2D.UPSAMPLE_STRIDES = [0.5, 1]
    for a in model_cfg.DENSE_HEAD.ANCHOR_GENERATOR_CONFIG:
        a["feature_map_stride"] = 16


def _clamp_tanh(model_cfg, data_cfg):
    data_cfg.CLAMP = "tanh"


OPTIONS = {
    "unfused_v1": lambda m, d: _unfused(m, d, "v1"),
    "unfused_v2": lambda m, d: _unfused(m, d, "v2"),
    "mean_vfe": _mean_vfe,
    "fractional_upsample": _fractional,
    "clamp_tanh": _clamp_tanh,
}


@functools.cache
def option_run(option: str) -> dict:
    from btcdet_tpu.config import EasyDict

    data_cfg, model_cfg = full_micro_cfgs()
    OPTIONS[option](model_cfg, data_cfg)
    return run_both(EasyDict({"DATA_CONFIG": data_cfg, "MODEL": model_cfg}), 2048, 4)


@pytest.mark.parametrize("option", list(OPTIONS))
def test_option_eval_matches(option):
    """Stages to 1e-4, roi slots and labels and the kept detections as in
    the JAX package; the occ points as in the JAX package, per frame as
    sets (near-tied probabilities may leave top-K in another order, ROADMAP
    Queue 3)."""
    res = option_run(option)
    assert_eval_matches(res)
    out, ref = res["out"], res["ref"]
    np.testing.assert_array_equal(out["occ_points_mask"], ref["occ_points_mask"])
    for f in range(out["occ_points"].shape[0]):
        keep = out["occ_points_mask"][f]
        assert_close(np.unique(out["occ_points"][f][keep], axis=0),
                     np.unique(ref["occ_points"][f][keep], axis=0), err_msg=f"frame {f}")


@pytest.mark.parametrize("option", ["unfused_v1", "unfused_v2", "mean_vfe"])
def test_materialized_table_matches(option):
    """The merged point table the det VFE reduces (`det_voxels`): the same
    rows, counts and coords as the JAX package's, its points to 1e-4 (the
    occ points' residuals are f32 conv outputs)."""
    res = option_run(option)
    occ, ref = res["occ"], res["ref_occ"]
    assert "det_voxel_features" not in occ and "det_voxels" in occ
    for k in ("det_voxel_coords", "det_voxel_num_points"):
        np.testing.assert_array_equal(occ[k], ref[k], err_msg=k)
    assert occ["det_voxels"].shape == ref["det_voxels"].shape
    assert_close(occ["det_voxels"], ref["det_voxels"])
    # occ points joined det rows and made new ones
    per_frame = res["per_frame"]
    num = occ["det_voxel_num_points"].reshape(2, -1)
    assert (num[:, per_frame:] > 0).any()


def test_fractional_upsample_map_and_anchors():
    """With UPSAMPLE_STRIDES [0.5, 1] and feature_map_stride 16 the BEV
    output is the stride-16 map and the anchors cover it."""
    res = option_run("fractional_upsample")
    base = default_micro_shapes()
    h, w = base["spatial_features_2d"][1:3]
    assert res["out"]["spatial_features_2d"].shape[1:3] == ((h + 1) // 2, (w + 1) // 2)
    assert res["out"]["rpn_box_preds"].shape[1] == base["rpn_box_preds"][1] // 4


def default_micro_shapes() -> dict:
    """The shapes of the default micro model's BEV map and RPN boxes (the
    port alone: no JAX run)."""
    from btcdet_tpu.config import EasyDict

    from btcdet_tpu_torch.datasets import make_synthetic_batch
    from btcdet_tpu_torch.models import build_network

    data_cfg, model_cfg = full_micro_cfgs()
    cfg = EasyDict({"DATA_CONFIG": data_cfg, "MODEL": model_cfg})
    net = build_network(cfg.MODEL, cfg.DATA_CONFIG, ["Car"], device="cpu")
    out = net(make_synthetic_batch(cfg.DATA_CONFIG, batch_size=2, num_points=2048, num_gt=4,
                                   seed=0, mode="test", device="cpu"))
    return {k: tuple(out[k].shape) for k in ("spatial_features_2d", "rpn_box_preds")}
