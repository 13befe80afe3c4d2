"""The point-feature path of the port against the JAX package: the
pointnet2 surface (`gather_points`, `grouping_operation`, `three_nn`,
`three_interpolate`, `furthest_point_sample`), `PointSAModuleMSG`'s max
and avg pooling, `get_voxel_centers` / `bilinear_interpolate`,
`VoxelSetAbstraction`, and the slice as a whole: `VoxelResBackBone8x` ->
`HeightCompression` -> `VoxelSetAbstraction` on one batch, the weights
carried by `weights.res_backbone_3d_state` / `pfe_state`. Inputs from a
numpy seed, float32 (`BTCDET_F32=1`), CPU, micro widths on a 4 x 4.8 m
scene.

Tolerances: indices (FPS picks, nearest neighbours, keypoints' sources)
exact; f32 outputs 1e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from btcdet_tpu.models import backbones_3d as JB
from btcdet_tpu.models import map_to_bev as JM
from btcdet_tpu.models import pfe as JP
from btcdet_tpu.ops import group_ops as JG
from btcdet_tpu.ops import sparse as JS
from btcdet_tpu.utils import common as JC
from btcdet_tpu_torch import weights
from btcdet_tpu_torch.models import backbones_3d as TB
from btcdet_tpu_torch.models import map_to_bev as TM
from btcdet_tpu_torch.models import pfe as TP
from btcdet_tpu_torch.ops import group_ops as TG
from btcdet_tpu_torch.ops import sparse as TS
from btcdet_tpu_torch.utils import common as TC
from torch_parity import assert_close, f32_mode, perturb_variables

PCR = (0.0, -2.4, -3.0, 4.0, 2.4, 1.1)
VOXEL = (0.2, 0.2, 0.1)
GRID = (41, 24, 20)            # (nz, ny, nx) of PCR / VOXEL
BATCH = 2
CHANNELS = (4, 8, 8, 16, 16)
SOURCES = ("bev", "x_conv3", "x_conv4", "raw_points")
RADII = ((0.4, 0.8), (0.8, 1.6), (1.6, 2.4))
NSAMPLES = ((8, 8), (8, 16), (8, 16))
MLPS = (((8, 8), (8, 8)), ((16, 16), (16, 16)), ((16, 16), (16, 16)))
KEYPOINTS = 48
OUT = 24


def t(x):
    return torch.from_numpy(np.array(x))


def _cloud(seed=0, n=700, n_valid=(640, 510)):
    """(xyz (B, n, 3), mask (B, n), intensity (B, n, 1)) in PCR, padding
    rows at the end of each frame."""
    rng = np.random.RandomState(seed)
    lo, hi = np.asarray(PCR[:3]), np.asarray(PCR[3:])
    xyz = (lo + (hi - lo) * rng.rand(BATCH, n, 3) * 0.999).astype(np.float32)
    mask = np.arange(n)[None, :] < np.asarray(n_valid)[:, None]
    xyz[~mask] = 0
    inten = rng.rand(BATCH, n, 1).astype(np.float32)
    return xyz, mask, inten


# ------------------------------------------------------ pointnet2 surface


@pytest.mark.parametrize("npoint,n_valid", [(32, (640, 510)), (40, (25, 700))],
                         ids=["masked", "fewer-valid"])
def test_furthest_point_sample_matches_jax(npoint, n_valid):
    """The FPS picks, index for index (a frame with fewer valid points
    than picks repeats as the JAX loop does)."""
    xyz, mask, _ = _cloud(1, n_valid=n_valid)
    ref = np.asarray(jax.jit(JG.furthest_point_sample, static_argnums=2)(
        jnp.asarray(xyz), jnp.asarray(mask), npoint))
    out = TG.furthest_point_sample(t(xyz), t(mask), npoint).numpy()
    np.testing.assert_array_equal(out, ref)
    for b in range(BATCH):
        assert len(np.unique(out[b])) == min(npoint, n_valid[b])


def test_three_nn_and_interpolate_match_jax():
    """`three_nn` with duplicated known points (ties to the lower index)
    and masked known points; `three_interpolate`, `gather_points` and
    `grouping_operation` on the result."""
    rng = np.random.RandomState(2)
    known = rng.rand(BATCH, 30, 3).astype(np.float32)
    known[:, 10:20] = known[:, 0:10]                     # exact ties
    kmask = rng.rand(BATCH, 30) > 0.2
    unknown = rng.rand(BATCH, 50, 3).astype(np.float32)
    unknown[:, :5] = known[:, 12:17]                     # distance 0, twice each
    umask = np.ones((BATCH, 50), bool)
    jd, ji = JG.three_nn(jnp.asarray(unknown), jnp.asarray(umask), jnp.asarray(known),
                         jnp.asarray(kmask))
    td, ti = TG.three_nn(t(unknown), t(umask), t(known), t(kmask))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert_close(td.numpy(), np.asarray(jd))
    feats = rng.randn(BATCH, 30, 6).astype(np.float32)
    w = rng.rand(BATCH, 50, 3).astype(np.float32)
    assert_close(TG.three_interpolate(t(feats), ti, t(w)).numpy(),
                 np.asarray(JG.three_interpolate(jnp.asarray(feats), ji, jnp.asarray(w))))
    idx = rng.randint(0, 30, (BATCH, 7))
    np.testing.assert_array_equal(TG.gather_points(t(feats), t(idx)).numpy(),
                                  np.asarray(JG.gather_points(jnp.asarray(feats),
                                                              jnp.asarray(idx))))
    gidx = rng.randint(0, 30, (BATCH, 7, 4))
    np.testing.assert_array_equal(TG.grouping_operation(t(feats), t(gidx)).numpy(),
                                  np.asarray(JG.grouping_operation(jnp.asarray(feats),
                                                                   jnp.asarray(gidx))))


@pytest.mark.parametrize("pool_method", ["max_pool", "avg_pool"])
def test_sa_pool_methods_match_jax(pool_method):
    """`PointSAModuleMSG` pooling each ball by max or by the mean over its
    nsample slots (repeats included), eval BN statistics off identity;
    weights through `weights.sa_module_state`."""
    xyz, mask, inten = _cloud(3)
    new = xyz[:, 5:45] + 0.01
    new_mask = mask[:, 5:45].copy()
    new_mask[1, -3:] = False
    kw = dict(radii=[(0.0, 0.5), 0.9], nsamples=[6, 12], mlps=[[4, 8, 8], [4, 16]])
    with f32_mode():
        jsa = JG.PointSAModuleMSG(pool_method=pool_method, **kw)
        args = (jnp.asarray(xyz), jnp.asarray(mask), jnp.asarray(new), jnp.asarray(new_mask))
        v = perturb_variables(jsa.init(jax.random.PRNGKey(0), *args,
                                       features=jnp.asarray(inten)))
        ref = np.asarray(jsa.apply(v, *args, features=jnp.asarray(inten)))
        tsa = TG.PointSAModuleMSG(kw["radii"], kw["nsamples"], kw["mlps"],
                                  pool_method=pool_method).eval()
        sd = weights.sa_module_state(v["params"], v["batch_stats"])
        tsa.load_state_dict({k: t(np.array(x)) for k, x in sd.items()}, strict=True)
        with torch.no_grad():
            out = tsa(t(xyz), t(mask), t(new), t(new_mask), features=t(inten)).numpy()
    assert_close(out, ref)
    assert np.abs(ref).max() > 0.1 and not out[1, -3:].any()


def test_voxel_centers_and_bilinear_match_jax():
    rng = np.random.RandomState(4)
    zyx = rng.randint(0, 20, (60, 3)).astype(np.int32)
    ref = np.asarray(JC.get_voxel_centers(jnp.asarray(zyx), 4, VOXEL, PCR))
    assert_close(TC.get_voxel_centers(t(zyx), 4, VOXEL, PCR).numpy(), ref, rtol=0, atol=1e-6)
    im = rng.randn(6, 5, 3).astype(np.float32)
    x, y = (rng.rand(2, 40) * 8 - 1.5).astype(np.float32)        # some off the image
    assert_close(TC.bilinear_interpolate(t(im), t(x), t(y)).numpy(),
                 np.asarray(JC.bilinear_interpolate(jnp.asarray(im), jnp.asarray(x),
                                                    jnp.asarray(y))))


# ------------------------------------------------ VoxelSetAbstraction

def _voxels(xyz, mask, inten):
    """Unique voxel coords of the cloud, with (x, y, z, intensity) means
    replaced by the first point's values: the backbone's input table."""
    c = np.floor((xyz - np.asarray(PCR[:3])) / np.asarray(VOXEL)).astype(np.int32)[..., ::-1]
    rows = []
    for b in range(BATCH):
        cb = np.concatenate([np.full((mask[b].sum(), 1), b), c[b][mask[b]]], 1)
        _, first = np.unique(cb, axis=0, return_index=True)
        rows.append((cb[first], np.concatenate([xyz[b][mask[b]][first],
                                                inten[b][mask[b]][first]], 1)))
    coords = np.concatenate([r[0] for r in rows]).astype(np.int32)
    feats = np.concatenate([r[1] for r in rows]).astype(np.float32)
    cap = len(coords) + 40
    coords = np.concatenate([coords, np.full((40, 4), -1, np.int32)])
    feats = np.concatenate([feats, np.zeros((40, 4), np.float32)])
    assert cap == len(coords)
    return feats, coords


def _jax_vsa():
    return JP.VoxelSetAbstraction(
        num_keypoints=KEYPOINTS, features_source=SOURCES, sa_radii=RADII, sa_nsamples=NSAMPLES,
        sa_mlps=MLPS, bev_stride=8, point_cloud_range=PCR, voxel_size=VOXEL,
        num_out_features=OUT)


def _port_vsa(bev_channels):
    return TP.VoxelSetAbstraction(
        {"x_conv3": CHANNELS[2], "x_conv4": CHANNELS[3]}, raw_channels=1,
        bev_channels=bev_channels, num_keypoints=KEYPOINTS, features_source=SOURCES,
        sa_radii=RADII, sa_nsamples=NSAMPLES, sa_mlps=MLPS, bev_stride=8,
        point_cloud_range=PCR, voxel_size=VOXEL, num_out_features=OUT)


def _port_st(jst):
    return TS.SparseTensor(t(jst.features), t(jst.coords), t(jst.keys), t(jst.nnz).long(),
                           tuple(jst.spatial_shape), jst.batch_size)


@functools.cache
def _slice_run() -> dict:
    """The JAX chain (VoxelResBackBone8x -> HeightCompression ->
    VoxelSetAbstraction, eval, BN statistics off identity) and the port's
    on the same batch: the port's VSA on the JAX levels (the module alone)
    and on its own backbone's (the slice)."""
    xyz, mask, inten = _cloud(5)
    feats, coords = _voxels(xyz, mask, inten)
    res = {}
    with f32_mode():
        jst = JS.from_coords(jnp.asarray(feats), jnp.asarray(coords), GRID, BATCH)
        jbb = JB.VoxelResBackBone8x(input_channels=4, channels=CHANNELS)
        vb = perturb_variables(jax.jit(jbb.init)(jax.random.PRNGKey(0), jst))
        jlv = jax.jit(lambda v, st: jbb.apply(v, st, train=False))(vb, jst)
        jbev = JM.HeightCompression()(jlv["encoded"])
        jvsa = _jax_vsa()
        jargs = (jnp.asarray(xyz), jnp.asarray(mask), jnp.asarray(inten),
                 {k: jlv[k] for k in ("x_conv3", "x_conv4")}, jbev)
        vp = perturb_variables(jax.jit(jvsa.init)(jax.random.PRNGKey(1), *jargs))
        (jkp, jf, jkm), inter = jax.jit(
            lambda v, *a: jvsa.apply(v, *a, capture_intermediates=True))(vp, *jargs)
        res["ref"] = (np.asarray(jkp), np.asarray(jf), np.asarray(jkm))
        res["ref_raw"] = np.asarray(inter["intermediates"]["sa_raw"]["__call__"][0])
        res["ref_levels"] = {k: np.asarray(jlv[k].features) for k in ("x_conv3", "x_conv4")}
        res["ref_bev"] = np.asarray(jbev)

        tbb = TB.VoxelResBackBone8x(4, CHANNELS).eval()
        tbb.load_state_dict({k: t(np.array(x)) for k, x in
                             weights.res_backbone_3d_state(vb["params"],
                                                           vb["batch_stats"]).items()})
        tvsa = _port_vsa(jbev.shape[-1]).eval()
        sd = weights.pfe_state(vp["params"], vp["batch_stats"], SOURCES)
        tvsa.load_state_dict({k: t(np.array(x)) for k, x in sd.items()}, strict=True)
        targs = (t(xyz), t(mask), t(inten))
        tvsa.SA_rawpoints.register_forward_hook(lambda m, i, o: res.update(raw=o.numpy()))
        res["cloud"], res["vsa"] = (xyz, mask, inten), tvsa
        with torch.no_grad():
            alone = tvsa(*targs, {k: _port_st(jlv[k]) for k in ("x_conv3", "x_conv4")},
                         t(jbev))
            tlv = tbb(TS.from_coords(t(feats), t(coords), GRID, BATCH))
            _, tbev = TM.HeightCompression()(tlv["encoded"])
            whole = tvsa(*targs, tlv, tbev)
        res["alone"] = tuple(x.numpy() for x in alone)
        res["whole"] = tuple(x.numpy() for x in whole)
        res["levels"] = {k: tlv[k].features.numpy() for k in ("x_conv3", "x_conv4")}
        res["bev"] = tbev.numpy()
    return res


def _self_dropped(r):
    """Keypoints whose raw-point SA row differs from the JAX one, each
    proven to differ only because the JAX ball query dropped the
    keypoint's own point: |q|^2 + |x|^2 - 2 q.x rounds below 0 there (how
    it rounds depends on XLA's fusion), where the port clamps it at 0 and
    keeps it. Recomputing such a row by the port with the points at
    distance 0 left out must give the JAX row. Returns a (B, K) mask."""
    xyz, mask, inten = r["cloud"]
    kp = r["ref"][0]
    differ = np.abs(r["raw"] - r["ref_raw"]).max(-1) > 1e-4
    for b, m in np.argwhere(differ):
        at_zero = ((xyz[b].astype(np.float64) - kp[b, m]) ** 2).sum(-1) == 0
        assert at_zero[mask[b]].any(), (b, m)
        with torch.no_grad():
            row = r["vsa"].SA_rawpoints(t(xyz[b:b + 1]), t(mask[b:b + 1] & ~at_zero[None]),
                                        t(kp[b:b + 1, m:m + 1]), t(np.ones((1, 1), bool)),
                                        features=t(inten[b:b + 1]))
        assert_close(row.numpy()[0, 0], r["ref_raw"][b, m], err_msg=f"keypoint {b}, {m}")
    return differ


@pytest.mark.parametrize("part", ["alone", "whole"])
def test_voxel_set_abstraction_matches_jax(part):
    """alone: the port's VSA on the JAX backbone's levels and BEV map;
    whole: the slice, the port's backbone and HeightCompression feeding
    its VSA. Keypoints and their mask exact, features 1e-4 on every
    keypoint but those where the JAX ball query dropped the keypoint's
    own point (`_self_dropped`, proven one by one)."""
    r = _slice_run()
    (kp, f, km), (jkp, jf, jkm) = r[part], r["ref"]
    if part == "whole":
        for k in r["levels"]:
            assert_close(r["levels"][k], r["ref_levels"][k], err_msg=k)
        assert_close(r["bev"], r["ref_bev"])
    np.testing.assert_array_equal(km, jkm)
    np.testing.assert_array_equal(kp, jkp)
    dropped = _self_dropped(r)
    assert dropped.mean() < 0.25, dropped.sum()
    assert_close(f[~dropped], jf[~dropped])
    assert np.abs(jf).max() > 0.1 and f.shape == (BATCH, KEYPOINTS, OUT)


def test_vsa_names():
    """The reference's names and the input width of the fusion layer
    (raw, then the levels in FEATURES_SOURCE order, then the BEV map)."""
    sd = _port_vsa(32).state_dict()
    assert "SA_rawpoints.mlps.1.0.weight" in sd and "SA_layers.1.mlps.0.3.weight" in sd
    assert tuple(sd["vsa_point_feature_fusion.0.weight"].shape) == (OUT, 16 + 32 + 32 + 32)
