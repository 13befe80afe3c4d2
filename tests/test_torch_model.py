"""The whole model: the JAX BtcNet eval forward + post-processing against
the PyTorch port on the same synthetic batch and the same weights (JAX
init, BN moved off identity, carried across with
`weights.from_jax_variables`), for the full config (occ subnet on), its
det-only variant and its `fix` occ-code variant. CPU, float32, exact ball
queries."""

import numpy as np
import pytest

from torch_parity import (assert_close, det_only_micro_cfgs, full_micro_cfgs, full_micro_run,
                          run_both)


def _parts(res):
    return tuple(res[k] for k in ("ref", "ref_post", "out", "post", "missing"))


def _det_only(data_cfg, model_cfg):
    from btcdet_tpu.config import EasyDict

    from btcdet_tpu_torch import config as tcfg

    return tcfg.det_only(EasyDict({"DATA_CONFIG": data_cfg, "MODEL": model_cfg}))


def _full_fix():
    """The full micro config with the det backbone's `fix` occ-code variant
    (the code sum-pooled, K2 sum, and concatenated at every level, OCC_ATT
    at levels 0 and 1)."""
    from btcdet_tpu.config import EasyDict

    from btcdet_tpu_torch import config as tcfg

    data_cfg, model_cfg = full_micro_cfgs()
    tcfg.set_occ_variant(model_cfg.BACKBONE_3D, "fix")
    return EasyDict({"DATA_CONFIG": data_cfg, "MODEL": model_cfg})


@pytest.fixture(scope="module", params=["det_only", "full", "full_fix"])
def micro(request):
    """(ref, ref_post, out, post, missing) of `torch_parity.run_both`; the
    full case is the run the occupancy tests share."""
    if request.param == "full":
        res = full_micro_run()
    elif request.param == "full_fix":
        res = run_both(_full_fix(), num_points=2048, num_gt=4)
    else:
        res = run_both(_det_only(*det_only_micro_cfgs()), num_points=2048, num_gt=4)
    return _parts(res)


def test_weights_cover_the_port(micro):
    missing = micro[4]
    assert not missing.missing_keys and not missing.unexpected_keys


def test_encoded_features_match(micro):
    ref, _, out, _, _ = micro
    assert out["encoded_features"].shape == ref["encoded_features"].shape
    assert_close(out["encoded_features"], ref["encoded_features"])


def test_spatial_features_match(micro):
    ref, _, out, _, _ = micro
    for k in ("spatial_features", "spatial_features_2d"):
        assert out[k].shape == ref[k].shape, k
        assert_close(out[k], ref[k], err_msg=k)


def test_rpn_preds_match(micro):
    ref, _, out, _, _ = micro
    assert_close(out["rpn_cls_preds"], ref["rpn_cls_preds"])
    assert_close(out["rpn_box_preds"], ref["rpn_box_preds"])


def test_rois_match(micro):
    ref, _, out, _, _ = micro
    np.testing.assert_array_equal(out["roi_valid"], ref["roi_valid"])
    np.testing.assert_array_equal(out["roi_labels"], ref["roi_labels"])
    assert_close(out["rois"], ref["rois"])


def test_rcnn_outputs_match(micro):
    ref, _, out, _, _ = micro
    assert_close(out["batch_cls_preds"], ref["batch_cls_preds"])
    assert_close(out["batch_box_preds"], ref["batch_box_preds"])


def test_detections_match(micro):
    _, ref_post, _, post, _ = micro
    np.testing.assert_array_equal(post["pred_valid"], ref_post["pred_valid"])
    np.testing.assert_array_equal(post["pred_labels"], ref_post["pred_labels"])
    assert_close(post["pred_scores"], ref_post["pred_scores"])
    assert_close(post["pred_boxes"], ref_post["pred_boxes"])
    assert post["pred_valid"].any(), "the parity case should keep some detections"


def test_occ_outputs_match(micro):
    ref, _, out, _, _ = micro
    assert sorted(k for k in out if k.startswith("occ_")) == sorted(
        k for k in ref if k.startswith("occ_"))
    if "occ_probs" not in ref:
        return
    assert_close(out["occ_probs"], ref["occ_probs"])
    np.testing.assert_array_equal(out["occ_points_mask"], ref["occ_points_mask"])
    assert out["occ_points_mask"].sum(1).min() > 0
    assert_close(out["occ_points"], ref["occ_points"])
    for k in ("occ_pos_mask", "occ_cls_mask"):
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)


@pytest.mark.slow
def test_mini_det_only_matches():
    """The mini det-only config (16 m scene, 0.1 m voxels)."""
    from btcdet_tpu.datasets.mini_config import mini_data_cfg, mini_model_cfg

    ref, ref_post, out, post, _ = _parts(run_both(
        _det_only(mini_data_cfg(False), mini_model_cfg(False)), num_points=4096, num_gt=4))
    for k in ("encoded_features", "spatial_features_2d", "rpn_box_preds", "rois",
              "batch_cls_preds", "batch_box_preds"):
        assert_close(out[k], ref[k], err_msg=k)
    np.testing.assert_array_equal(post["pred_valid"], ref_post["pred_valid"])
    assert_close(post["pred_boxes"], ref_post["pred_boxes"])


@pytest.mark.slow
def test_mini_full_matches():
    """The mini config with the occ subnet (16 m scene, 0.1 m voxels)."""
    from btcdet_tpu.config import EasyDict
    from btcdet_tpu.datasets.mini_config import mini_data_cfg, mini_model_cfg

    model_cfg = mini_model_cfg(True)
    model_cfg.ROI_HEAD.APPROX_QUERY = False
    cfg = EasyDict({"DATA_CONFIG": mini_data_cfg(True), "MODEL": model_cfg})
    ref, ref_post, out, post, _ = _parts(run_both(cfg, num_points=4096, num_gt=4))
    np.testing.assert_array_equal(out["occ_points_mask"], ref["occ_points_mask"])
    for k in ("occ_probs", "occ_points", "encoded_features", "spatial_features_2d",
              "rpn_box_preds", "rois", "batch_cls_preds", "batch_box_preds"):
        assert_close(out[k], ref[k], err_msg=k)
    np.testing.assert_array_equal(post["pred_valid"], ref_post["pred_valid"])
    assert_close(post["pred_boxes"], ref_post["pred_boxes"])


@pytest.mark.slow
def test_mini_fix_matches():
    """The mini config with the `fix` occ-code variant. Its occ points are
    compared per frame as sets: with these weights two of them have
    probabilities that tie in the JAX package (0.49795768) and differ by
    3e-8 in the port, so top-K lists the pair in the other order; every
    stage after it matches."""
    from btcdet_tpu.config import EasyDict
    from btcdet_tpu.datasets.mini_config import mini_data_cfg, mini_model_cfg

    from btcdet_tpu_torch import config as tcfg

    model_cfg = mini_model_cfg(True)
    model_cfg.ROI_HEAD.APPROX_QUERY = False
    tcfg.set_occ_variant(model_cfg.BACKBONE_3D, "fix")
    cfg = EasyDict({"DATA_CONFIG": mini_data_cfg(True), "MODEL": model_cfg})
    ref, ref_post, out, post, _ = _parts(run_both(cfg, num_points=4096, num_gt=4))
    np.testing.assert_array_equal(out["occ_points_mask"], ref["occ_points_mask"])
    for f in range(out["occ_points"].shape[0]):
        mask = out["occ_points_mask"][f]
        assert_close(np.unique(out["occ_points"][f][mask], axis=0),
                     np.unique(ref["occ_points"][f][mask], axis=0), err_msg=f"frame {f}")
    for k in ("occ_probs", "encoded_features", "spatial_features_2d", "rpn_box_preds", "rois",
              "batch_cls_preds", "batch_box_preds"):
        assert_close(out[k], ref[k], err_msg=k)
    np.testing.assert_array_equal(post["pred_valid"], ref_post["pred_valid"])
    assert_close(post["pred_boxes"], ref_post["pred_boxes"])
