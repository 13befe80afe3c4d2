"""Inputs and weights carried across: the port's synthetic batch equals the
JAX package's bit for bit (occupancy keys included), `from_jax_variables`
inverts the JAX package's reference import exactly (occ subnet, deconv
flip, SA_occpoints and the det backbone's variant blocks included), the
flagship model's state dict is the
reference BtcDet's, and the port's synthetic weights are the JAX
package's golden ones."""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from btcdet_tpu.config import EasyDict as JaxEasyDict
from btcdet_tpu.config import cfg_from_yaml_file
from btcdet_tpu.datasets import make_synthetic_batch as jax_batch
from btcdet_tpu.train import golden_synth, ref_import
from btcdet_tpu_torch import config as tcfg
from btcdet_tpu_torch import weights
from btcdet_tpu_torch.datasets import make_synthetic_batch, make_synthetic_batch_np
from torch_parity import (det_only_micro_cfgs, f32_mode, full_micro_cfgs, perturb_variables,
                          shaped_jax_variables)

MANIFEST = Path(__file__).parent / "fixtures" / "reference_state_dict_manifest.json"


def _data_cfg(which):
    if which == "micro":
        return det_only_micro_cfgs()[0]
    if which == "micro-occ":
        return full_micro_cfgs()[0]
    full = cfg_from_yaml_file(tcfg.FLAGSHIP_CFG)
    return full.DATA_CONFIG if which == "flagship-occ" else tcfg.det_only(full).DATA_CONFIG


@pytest.mark.parametrize("which,kw", [
    ("micro", dict(batch_size=2, num_points=2048, num_gt=4, seed=0, mode="test")),
    ("micro", dict(batch_size=3, num_points=3000, num_gt=6, seed=7, mode="train")),
    ("flagship", dict(batch_size=2, num_points=16384, num_gt=10, seed=1, mode="test")),
    ("micro-occ", dict(batch_size=2, num_points=2048, num_gt=4, seed=0, mode="test")),
    ("micro-occ", dict(batch_size=3, num_points=3000, num_gt=0, seed=7, mode="train")),
    ("flagship-occ", dict(batch_size=2, num_points=16384, num_gt=10, seed=1, mode="test")),
], ids=["micro-test", "micro-train", "flagship-test", "micro-occ-test", "micro-occ-train-nogt",
        "flagship-occ-test"])
def test_synthetic_batch_is_bit_identical(which, kw):
    data_cfg = _data_cfg(which)
    ref = jax_batch(data_cfg, **kw)
    out = make_synthetic_batch_np(tcfg.EasyDict(data_cfg), **kw)
    assert sorted(out) == sorted(ref)
    for k in ref:
        assert out[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    tb = make_synthetic_batch(tcfg.EasyDict(data_cfg), **kw, device="cpu")
    for k in ref:
        np.testing.assert_array_equal(tb[k].numpy(), ref[k], err_msg=k)


def test_det_only_edits_the_flagship_config():
    full = cfg_from_yaml_file(tcfg.FLAGSHIP_CFG)
    cfg = tcfg.det_only(full)
    assert "OCC" in full.MODEL, "det_only must not touch its input"
    assert "OCC" not in cfg.MODEL and "OCC" not in cfg.DATA_CONFIG
    assert [p.NAME for p in cfg.DATA_CONFIG.DATA_PROCESSOR] == [
        "mask_points_and_boxes_outside_range", "shuffle_points", "det_transform_points_to_voxels"]
    assert cfg.MODEL.VFE.NAME == "MeanVFE"
    assert cfg.MODEL.BACKBONE_3D.OCC_CONV_TYPE == [] == cfg.MODEL.BACKBONE_3D.OCC_CONV_EXECUTE
    assert cfg.MODEL.ROI_HEAD.CONV_GRID_POOL.FEATURES_SOURCE == ["x_combine", "raw_points"]
    assert cfg.MODEL.ROI_HEAD.APPROX_QUERY is False
    # everything else stays the flagship's
    assert cfg.MODEL.BACKBONE_3D.LEVEL_CAPACITIES == full.MODEL.BACKBONE_3D.LEVEL_CAPACITIES
    assert cfg.DATA_CONFIG.DATA_PROCESSOR[-1].MAX_NUMBER_OF_VOXELS["test"] == 40000
    assert cfg.MODEL.ROI_HEAD.SHARED_FC == [256, 128]
    ported = tcfg.flagship_det_only()
    assert ported.MODEL.ROI_HEAD.NMS_CONFIG == cfg.MODEL.ROI_HEAD.NMS_CONFIG


@pytest.fixture(scope="module", params=["det_only", "full"])
def roundtrip_variables(request):
    """The variables of a micro model (det-only, or full with the occ
    subnet; the init's tree and shapes, `torch_parity.shaped_jax_variables`)
    inside the reference import's assumptions: 128-channel conv_out (its
    BEV interleave width), two-layer cls / reg heads (its FC index map)."""
    from btcdet_tpu.models import build_network

    data_cfg, model_cfg = (full_micro_cfgs() if request.param == "full"
                           else det_only_micro_cfgs())
    model_cfg.BACKBONE_3D.CHANNELS = [8, 8, 8, 8, 128]
    model_cfg.MAP_TO_BEV.NUM_BEV_FEATURES = 256
    model_cfg.ROI_HEAD.CLS_FC = [16, 16]
    model_cfg.ROI_HEAD.REG_FC = [16, 16]
    with f32_mode():
        batch = jax_batch(data_cfg, batch_size=2, num_points=2048, num_gt=4, mode="test")
        net = build_network(model_cfg, data_cfg, ["Car"])
        v = perturb_variables(shaped_jax_variables(net, batch))
    grid = int(np.prod(model_cfg.ROI_HEAD.CONV_GRID_POOL.GRID_SIZE))
    return {"params": v["params"], "batch_stats": v["batch_stats"]}, model_cfg, data_cfg, grid


def test_from_jax_variables_inverts_ref_import(roundtrip_variables, monkeypatch):
    v, model_cfg, _, grid = roundtrip_variables
    sd = weights.from_jax_variables(
        v, dp_ratio=model_cfg.ROI_HEAD.DP_RATIO,
        upsample_strides=model_cfg.BACKBONE_2D.UPSAMPLE_STRIDES)
    monkeypatch.setattr(ref_import, "ROI_GRID_NUM", grid)
    back, report = ref_import.map_reference_state(
        {k: x.numpy() for k, x in sd.items()}, v,
        n_per_block=tuple(model_cfg.BACKBONE_2D.LAYER_NUMS))
    assert report["unmapped_ref"] == []
    assert report["uncovered_flax"] == []
    assert report["shape_mismatch"] == []
    flat_v = {"/".join(map(str, p)): x for p, x in _flatten(v)}
    flat_b = {"/".join(map(str, p)): x for p, x in _flatten(back)}
    assert flat_v.keys() == flat_b.keys()
    for k in flat_v:
        np.testing.assert_array_equal(np.asarray(flat_b[k]), np.asarray(flat_v[k]), err_msg=k)


def test_from_jax_variables_loads_strictly(roundtrip_variables):
    v, model_cfg, data_cfg, _ = roundtrip_variables
    from btcdet_tpu_torch.models import build_network

    tc = tcfg.EasyDict(JaxEasyDict({"MODEL": model_cfg, "DATA_CONFIG": data_cfg}))
    with f32_mode():
        port = build_network(tc.MODEL, tc.DATA_CONFIG, ["Car"], device="cpu")
    sd = weights.from_jax_variables(
        v, dp_ratio=model_cfg.ROI_HEAD.DP_RATIO,
        upsample_strides=model_cfg.BACKBONE_2D.UPSAMPLE_STRIDES)
    res = port.load_state_dict(sd, strict=True)
    assert not res.missing_keys and not res.unexpected_keys
    prefixes = {k.split(".")[0] for k in sd}
    assert prefixes == ({"det_modules", "occ_modules"} if "OCC" in model_cfg else {"det_modules"})
    if "OCC" in model_cfg:
        assert any(".SA_occpoints." in k for k in sd)
        assert "occ_modules.backbone_3d.deconv5.0.0.weight" in sd


def test_variant_backbone_names_round_trip():
    """The det backbone's variant names through `det_backbone_3d_state` and
    back through the JAX package's reference import: `att_conv1/2` (conv +
    BN), the BN-less `weight` occ convs `occ_conv2..4` and OUT_FEAT_TYPE
    `combine`'s `down_combine.2` (`from_jax_variables` maps the det
    backbone through the same function); the port's backbone loads them
    strictly."""
    import jax
    import jax.numpy as jnp

    from btcdet_tpu.models import backbones_3d as JB
    from btcdet_tpu.ops import sparse as S
    from btcdet_tpu_torch.models import backbones_3d as TB

    rng = np.random.RandomState(0)
    coords = np.concatenate([np.unique(np.stack([np.zeros(40), rng.randint(0, 41, 40),
                                                 rng.randint(0, 16, 40), rng.randint(0, 16, 40)],
                                                1), axis=0),
                             np.full((24, 4), -1)]).astype(np.int32)[:64]
    st = S.from_coords(jnp.asarray(rng.randn(64, 6).astype(np.float32)), jnp.asarray(coords),
                       (41, 16, 16), 1)
    kw = dict(occ_code_num=2, occ_conv_type=("identity",) + ("weight",) * 3,
              occ_conv_exec=(True,) * 4, out_att=(True, True, False, False))
    jbb = JB.VoxelBackBone8xOcc(input_channels=6, channels=(4, 4, 4, 4, 8),
                                out_feat_type=("None",) * 4 + ("combine",), **kw)
    v = perturb_variables(jax.jit(lambda s: jbb.init(jax.random.PRNGKey(0), s,
                                                     s.features[:, -2:]))(st))
    sd = weights.det_backbone_3d_state(v["params"], v["batch_stats"], "det_modules.backbone_3d.")
    for k in ("att_conv1.0.0.weight", "att_conv1.0.1.running_mean", "occ_conv3.0.0.weight",
              "down_combine.2.0.weight", "down_combine.2.1.weight"):
        assert f"det_modules.backbone_3d.{k}" in sd, k
    assert not any(".occ_conv2.0.1." in k for k in sd)
    tree = {"params": {"det_backbone_3d": v["params"]},
            "batch_stats": {"det_backbone_3d": v["batch_stats"]}}
    back, report = ref_import.map_reference_state(sd, tree)
    assert report["unmapped_ref"] == report["uncovered_flax"] == report["shape_mismatch"] == []
    flat_v = {"/".join(map(str, p)): x for p, x in _flatten(tree)}
    flat_b = {"/".join(map(str, p)): x for p, x in _flatten(back)}
    assert flat_v.keys() == flat_b.keys()
    for k in flat_v:
        np.testing.assert_array_equal(np.asarray(flat_b[k]), np.asarray(flat_v[k]), err_msg=k)
    port = TB.VoxelBackBone8xOcc(6, (4, 4, 4, 4, 8), out_feat_type=("None",) * 4 + ("combine",),
                                 **kw)
    prefix = len("det_modules.backbone_3d.")
    res = port.load_state_dict({k[prefix:]: torch.from_numpy(np.array(x)) for k, x in sd.items()},
                               strict=True)
    assert not res.missing_keys and not res.unexpected_keys


def test_flagship_state_dict_is_the_reference_one():
    """Every tensor of the reference BtcDet's flagship state dict (names
    and shapes from the committed manifest) and nothing else, except the
    reference's constant dilation kernel, which the port has no use for,
    and its training step counter."""
    from btcdet_tpu_torch.models import build_network

    manifest = json.load(open(MANIFEST))
    manifest.pop("occ_modules.occ_targets.fix_conv_2dzy.weight")
    manifest.pop("global_step")
    cfg = tcfg.flagship()
    port = build_network(cfg.MODEL, cfg.DATA_CONFIG, ["Car"], device="cpu")
    got = {k: list(v.shape) for k, v in port.state_dict().items()}
    assert got.keys() == manifest.keys(), (sorted(got.keys() - manifest.keys())[:5],
                                           sorted(manifest.keys() - got.keys())[:5])
    for k, shape in manifest.items():
        assert got[k] == list(shape), k
    sd = weights.synth_state_dict(port)
    np.testing.assert_array_equal(sd["occ_modules.backbone_3d.deconv4.0.0.weight"].numpy(),
                                  golden_synth.synth_tensor(
                                      "occ_modules.backbone_3d.deconv4.0.0.weight",
                                      (3, 3, 3, 64, 32)))


def _flatten(tree, prefix=()):
    for k, x in tree.items():
        if isinstance(x, dict):
            yield from _flatten(x, prefix + (k,))
        else:
            yield prefix + (k,), x


def test_synth_tensor_matches_golden_synth():
    manifest = {"det_modules.backbone_3d.conv1.0.weight": (3, 3, 3, 4, 16),
                "det_modules.backbone_3d.conv1.1.running_var": (16,),
                "det_modules.backbone_3d.conv1.1.running_mean": (16,),
                "det_modules.backbone_3d.conv1.1.weight": (16,),
                "det_modules.roi_head.cls_layers.7.bias": (1,),
                "det_modules.roi_head.shared_fc_layer.0.weight": (256, 6480, 1),
                "det_modules.backbone_3d.conv1.1.num_batches_tracked": ()}
    for name, shape in manifest.items():
        np.testing.assert_array_equal(weights.synth_tensor(name, shape),
                                      golden_synth.synth_tensor(name, shape))
    model = torch.nn.Linear(3, 2)
    sd = weights.synth_state_dict(model)
    assert sd.keys() == model.state_dict().keys()


@pytest.mark.parametrize("option,edit", [
    ("OccHead2D", ("conv_cls", "kernel")),
    ("VoxelBackBoneDeconvRes", ("backbone_3d", "lat1", "kernel")),
    ("VoxelBackBoneInverseRes", ("backbone_3d", "inv4", "ConvTranspose_0", "kernel")),
])
def test_occ_option_weights_map_and_reach_the_output(option, edit):
    """The JAX `OccSubnet` of an occ option (OccHead2D, the residual and
    inverse backbones) through `weights.occ_subnet_state`: the port's
    subnet loads it strictly, `synth_state_dict` covers the same names and
    shapes, and a change of one new weight in the JAX tree moves the port's
    occupancy probabilities."""
    import jax
    import jax.numpy as jnp

    from btcdet_tpu.config import CfgBox
    from btcdet_tpu.models.occ import occ_subnet as JOS
    from btcdet_tpu_torch.models.occ import occ_subnet as TOS

    data_cfg, model_cfg = full_micro_cfgs()
    if option == "OccHead2D":
        model_cfg.OCC.OCC_DENSE_HEAD.NAME = option
    else:
        model_cfg.OCC.BACKBONE_3D.NAME = option
    det_vs = (0.2, 0.2, 0.1)
    batch_np = jax_batch(data_cfg, batch_size=2, num_points=2048, num_gt=4, seed=0, mode="test")
    with f32_mode():
        jnet = JOS.OccSubnet(model_cfg=CfgBox(model_cfg.OCC), data_cfg=CfgBox(data_cfg),
                             point_cloud_range=tuple(data_cfg.POINT_CLOUD_RANGE),
                             det_voxel_size=det_vs, fused_vfe_nrf=4)
        v = perturb_variables(jax.jit(lambda b: jnet.init(
            {"params": jax.random.PRNGKey(0)}, b, train=False))(
                {k: jnp.asarray(x) for k, x in batch_np.items()}))
        v["params"]["conv_cls"]["bias"] = np.zeros_like(v["params"]["conv_cls"]["bias"])
        tc = tcfg.EasyDict({"DATA_CONFIG": data_cfg, "MODEL": model_cfg})
        port = TOS.OccSubnet(tc.MODEL.OCC, tc.DATA_CONFIG, tuple(data_cfg.POINT_CLOUD_RANGE),
                             det_vs, 4).eval()
        synth = weights.synth_state_dict(port)
        batch = {k: torch.from_numpy(np.ascontiguousarray(x)) for k, x in batch_np.items()}
        probs = []
        for scale in (1.0, 1.5):
            node = v["params"]
            for k in edit[:-1]:
                node = node[k]
            node[edit[-1]] = np.asarray(node[edit[-1]]) * scale
            sd = weights.occ_subnet_state(v["params"], v["batch_stats"], prefix="")
            assert {k: tuple(x.shape) for k, x in sd.items()} == {
                k: tuple(x.shape) for k, x in synth.items()}
            res = port.load_state_dict({k: torch.from_numpy(np.array(x)) for k, x in sd.items()},
                                       strict=True)
            assert not res.missing_keys and not res.unexpected_keys
            probs.append(port(batch)["probs"])
    assert probs[0].max() > 0 and not torch.equal(probs[0], probs[1])


def _det_option(option, model_cfg):
    """The micro model config edited for a det-side option of the weights
    cases below."""
    bb, b2 = model_cfg.BACKBONE_3D, model_cfg.BACKBONE_2D
    if option in ("None", "combine"):
        bb.OUT_FEAT_TYPE = ["None"] * 4 + [option]
    elif option == "mean_vfe":
        model_cfg.VFE.NAME = "MeanVFE"
    elif option == "fractional_upsample":
        b2.UPSAMPLE_STRIDES = [0.5, 1]
        for a in model_cfg.DENSE_HEAD.ANCHOR_GENERATOR_CONFIG:
            a["feature_map_stride"] = 16
    elif option == "three_class":
        y = tcfg.cfg_from_yaml_file(tcfg.REPO_ROOT / "tools" / "cfgs" / "model_configs"
                                    / "btcdet_kitti_3classes.yaml")
        model_cfg.DENSE_HEAD.ANCHOR_GENERATOR_CONFIG = json.loads(json.dumps(
            y.MODEL.DENSE_HEAD.ANCHOR_GENERATOR_CONFIG))
    return ["Car", "Pedestrian", "Cyclist"] if option == "three_class" else ["Car"]


@pytest.mark.parametrize("option", ["None", "combine", "mean_vfe", "fractional_upsample",
                                    "three_class"])
def test_det_option_weights_map_strictly(option):
    """The JAX micro model of a det-side option (the init's tree and shapes,
    `torch_parity.shaped_jax_variables`) through `from_jax_variables`: OUT_FEAT_TYPE `None` (no down2 / down3 /
    squeezeBev / down_combine, no x_combine conv stack, a narrower first
    rcnn FC), `combine` (the strided down_combine.1 and subm down_combine.2),
    MeanVFE with the occ subnet (no occ side branch, conv1 over the merged
    points' 6 channels), a fractional upsample stride (its deblock a
    Conv2d) and the 3-class dense head. The port loads it strictly, and
    `synth_state_dict` covers the same names and shapes."""
    from btcdet_tpu.models import build_network as jax_build

    from btcdet_tpu_torch.models import build_network

    data_cfg, model_cfg = full_micro_cfgs()
    classes = _det_option(option, model_cfg)
    with f32_mode():
        batch = jax_batch(data_cfg, batch_size=2, num_points=2048, num_gt=4, mode="test")
        v = shaped_jax_variables(jax_build(model_cfg, data_cfg, classes), batch)
    v = {"params": v["params"], "batch_stats": v["batch_stats"]}
    tc = tcfg.EasyDict(JaxEasyDict({"MODEL": model_cfg, "DATA_CONFIG": data_cfg}))
    sd = weights.from_jax_variables(
        jax.tree_util.tree_map(np.asarray, v), dp_ratio=tc.MODEL.ROI_HEAD.DP_RATIO,
        upsample_strides=tc.MODEL.BACKBONE_2D.UPSAMPLE_STRIDES)
    port = build_network(tc.MODEL, tc.DATA_CONFIG, classes, device="cpu")
    res = port.load_state_dict(sd, strict=True)
    assert not res.missing_keys and not res.unexpected_keys
    synth = weights.synth_state_dict(port)
    assert {k: tuple(x.shape) for k, x in sd.items()} == {
        k: tuple(x.shape) for k, x in synth.items()}
    bb = "det_modules.backbone_3d."
    if option == "None":
        assert not any(k.startswith(bb + "down") or ".conv_layers." in k for k in sd)
    if option == "combine":
        assert sd[bb + "down_combine.1.0.weight"].shape[:3] == (3, 3, 3)
    if option == "mean_vfe":
        assert sd[bb + "conv1.0.weight"].shape[3] == 6
        assert not any(".att_conv" in k or ".occ_conv" in k for k in sd)
        assert sd[bb + "conv2_combine.0.0.weight"].shape[3] == model_cfg.BACKBONE_3D.CHANNELS[1]
    if option == "fractional_upsample":
        w = sd["det_modules.backbone_2d.deblocks.0.0.weight"]
        assert tuple(w.shape[2:]) == (1, 1)
        assert w.shape[0] == model_cfg.BACKBONE_2D.NUM_UPSAMPLE_FILTERS[0]
    if option == "three_class":
        assert sd["det_modules.dense_head.conv_cls.weight"].shape[0] == 6 * 3
