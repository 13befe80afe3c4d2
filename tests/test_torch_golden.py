"""The port against the executed reference BtcDet: `tests/fixtures/golden_full.npz`
holds the reference's eval forward at the golden-mini geometry (flagship
widths on a 16 m scene) with deterministic weights made by name. The port
runs the fixture's input batch on the CPU in float32 with the same weights
(`weights.synth_state_dict`) and is held to `tests/test_golden_full.py`'s
tolerances, stage by stage."""

from pathlib import Path

import numpy as np
import pytest
import torch

from torch_parity import f32_mode

FIXTURE = Path(__file__).parent / "fixtures" / "golden_full.npz"


@pytest.fixture(scope="module")
def golden():
    from btcdet_tpu.train.golden_synth import apply_golden_mini

    from btcdet_tpu_torch import config as tcfg
    from btcdet_tpu_torch import weights
    from btcdet_tpu_torch.models import build_network

    fx = np.load(FIXTURE)
    batch = {k[4:]: torch.from_numpy(fx[k]) for k in fx.files if k.startswith("in::")}
    ref = {k[5:]: fx[k] for k in fx.files if k.startswith("ref::")}
    cfg = tcfg.flagship()
    apply_golden_mini(cfg, is_reference=False)
    cfg.MODEL.ROI_HEAD.COMPUTE_DTYPE = "f32"
    with f32_mode():
        net = build_network(cfg.MODEL, cfg.DATA_CONFIG, ["Car"], device="cpu")
        net.load_state_dict(weights.synth_state_dict(net), strict=True)
        occ = net.occ_modules(batch)
        out = net(batch)
    out = {k: v.numpy() if torch.is_tensor(v) else v for k, v in out.items()}
    occ = {k: v.numpy() for k, v in occ.items() if v is not None}
    return ref, out, occ


def test_occ_prob_grid_matches(golden):
    ref, out, _ = golden
    assert out["occ_probs"].shape == ref["occ_prob"].shape
    np.testing.assert_allclose(out["occ_probs"], ref["occ_prob"], rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("key", ["vcc_mask", "voxelwise_mask", "occ_voxelwise_mask",
                                 "general_cls_loss_mask"])
def test_occ_target_masks_match(golden, key):
    ref, _, occ = golden
    np.testing.assert_array_equal(occ[key], ref[f"tgt_{key}"].astype(bool))


def test_merged_det_voxel_set_matches(golden):
    """The merged det voxel table as a set of (b, z, y, x), with each
    voxel's OccVFE features."""
    ref, _, occ = golden
    c = occ["det_voxel_coords"]
    v = c[:, 0] >= 0
    ours = {tuple(r): i for i, r in zip(np.nonzero(v)[0], c[v].tolist())}
    want = {tuple(r): i for i, r in enumerate(ref["merged_voxel_coords"].astype(np.int64).tolist())}
    assert ours.keys() == want.keys(), (len(ours.keys() - want.keys()),
                                        len(want.keys() - ours.keys()))
    oi = np.array([ours[k] for k in want])
    wi = np.array(list(want.values()))
    np.testing.assert_allclose(occ["det_voxel_features"][oi], ref["det_vfe_features"][wi],
                               rtol=2e-3, atol=2e-3)


def test_bev_features_match(golden):
    ref, out, _ = golden
    rf = ref["spatial_features"]                               # (B, C*D, H, W) C-major
    B, CD, H, W = rf.shape
    C = 128
    want = rf.reshape(B, C, CD // C, H, W).transpose(0, 3, 4, 2, 1).reshape(B, H, W, CD)
    np.testing.assert_allclose(out["spatial_features"].astype(np.float32), want,
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(out["spatial_features_2d"],
                               ref["spatial_features_2d"].transpose(0, 2, 3, 1),
                               rtol=5e-3, atol=5e-3)


def test_rpn_preds_match(golden):
    ref, out, _ = golden
    np.testing.assert_allclose(out["rpn_cls_preds"], ref["rpn_cls_preds"], rtol=5e-3, atol=5e-3)
    got, want = out["rpn_box_preds"], ref["rpn_box_preds"]
    np.testing.assert_allclose(got[..., :6], want[..., :6], rtol=5e-3, atol=5e-3)
    dh = np.abs(got[..., 6] - want[..., 6]) % (2 * np.pi)
    assert np.minimum(dh, 2 * np.pi - dh).max() < 5e-3


def test_proposals_match(golden):
    ref, out, _ = golden
    for b in range(ref["rois"].shape[0]):
        n_ref = int((np.abs(ref["rois"][b]).sum(-1) > 0).sum())
        n_our = int(out["roi_valid"][b].sum())
        assert n_our == n_ref, (b, n_our, n_ref)
        np.testing.assert_allclose(out["rois"][b, :n_our, :6], ref["rois"][b, :n_ref, :6],
                                   rtol=5e-3, atol=5e-3)


def test_rcnn_outputs_match(golden):
    """Quantile-bounded like the JAX package's golden test: the occ-point
    list is cut at a top-512 probability rank, and ~2e-3 probability
    differences near the cut change a few over-full balls' neighbours."""
    ref, out, _ = golden
    valid = out["roi_valid"]
    dc = np.abs(out["batch_cls_preds"] - ref["rcnn_cls"])[valid]
    db = np.abs(out["batch_box_preds"][..., :6] - ref["rcnn_box_preds"][..., :6])[valid]
    assert np.quantile(dc, 0.9) < 1e-2, np.quantile(dc, 0.9)
    assert dc.max() < 0.2, dc.max()
    assert np.quantile(db, 0.9) < 2e-2, np.quantile(db, 0.9)
    assert db.max() < 1.0, db.max()
