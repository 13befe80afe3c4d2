"""The det backbone's occ-code variants: the port's `VoxelBackBone8xOcc` and
`FixedSparseConv3d` (K2 sum) against the JAX package's, on the grid
(41, 16, 16) and channels (4, 4, 4, 4, 8) of `tests/test_backbone_variants.py`,
inputs made from a numpy seed, float32 (`BTCDET_F32=1`), CPU.

Each variant downsamples the occ code by `fix`, `avgpool`, `weight` or
`maxpool` to every level, concatenates it at every level and runs the
OCC_ATT blocks at levels 0 and 1 (`config.set_occ_variant`). `avgpool` is
held to the JAX package's TPU path (Pallas in interpret mode): its CPU path
sums the 27 taps of the trunk conv's cached rulebook instead of the 8 of its
own k=2 kernel (ROADMAP Queue 3), which the port does not follow.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from btcdet_tpu.models import backbones_3d as JB
from btcdet_tpu.ops import pallas_conv as P
from btcdet_tpu.ops import sparse as S
from btcdet_tpu_torch import weights
from btcdet_tpu_torch.models import backbones_3d as TB
from btcdet_tpu_torch.ops import cuda_pool
from btcdet_tpu_torch.ops import sparse as TS
from torch_parity import f32_mode, perturb_variables

GRID = (41, 16, 16)
CHANNELS = (4, 4, 4, 4, 8)
IN_CH = 6            # 4 point features + the 2 occ code channels
OCC = 2
BATCH = 2
PER_FRAME = 60       # live voxels per frame
CAP = 512            # table capacity: no level drops a site
LEVELS = ("encoded", "x_conv1", "x_conv2", "x_conv3", "x_conv4", "x_combine")


def _inputs(seed=0):
    """(features (CAP, 6), coords (CAP, 4)) numpy; the last two feature
    channels are the occ code: probabilities on a 1/64 grid, exact in bf16
    (the TPU kernel's table type)."""
    rng = np.random.RandomState(seed)
    coords = []
    for b in range(BATCH):
        c = np.stack([np.full(4 * PER_FRAME, b), rng.randint(0, GRID[0], 4 * PER_FRAME),
                      rng.randint(0, GRID[1], 4 * PER_FRAME),
                      rng.randint(0, GRID[2], 4 * PER_FRAME)], 1)
        coords.append(np.unique(c, axis=0)[:PER_FRAME])
    coords = np.concatenate(coords + [np.full((CAP - BATCH * PER_FRAME, 4), -1)]).astype(np.int32)
    feats = rng.randn(CAP, IN_CH).astype(np.float32)
    feats[:, -OCC:] = rng.randint(0, 65, (CAP, OCC)) / 64.0
    return feats, coords


def _jax_st(feats, coords):
    return S.from_coords(jnp.asarray(feats), jnp.asarray(coords), GRID, BATCH)


def _torch_st(feats, coords):
    return TS.from_coords(torch.from_numpy(feats), torch.from_numpy(coords), GRID, BATCH)


def _config(down, comb):
    types = ("identity", down, down, down) if down else ("identity", "maxpool")
    execute = (True,) * 4 if down else (False, True)
    att = (True, True, False, False) if down else (False,) * 4
    return dict(occ_code_num=OCC, occ_conv_type=types, occ_conv_exec=execute,
                out_feat_type=("None",) * 4 + (comb,), out_att=att, channels=CHANNELS)


def _jax_outputs(out):
    return {k: np.asarray(out[k].features) for k in LEVELS if out.get(k) is not None}


@functools.cache
def _run(down, comb, train):
    """The JAX backbone and the port's on the same input and weights (JAX
    init, BN moved off identity). Eval: {"ref", "out"} per output level.
    Train: also the loss's (sum of squares of every level) gradients and
    the moved BN statistics, as port state dicts ("ref_grads" /
    "ref_stats") and the port's own ("grads" / "stats")."""
    cfg = _config(down, comb)
    feats, coords = _inputs()
    res = {}
    with f32_mode():
        jbb = JB.VoxelBackBone8xOcc(input_channels=IN_CH, **cfg)
        jst = _jax_st(feats, coords)
        jocc = jst.features[:, -OCC:]
        # eager, not jitted: after the first configuration most of the
        # operations are compiled already, so this is the faster way here
        v = perturb_variables(jbb.init({"params": jax.random.PRNGKey(0)}, jst, jocc))

        def loss_fn(params):
            out, upd = jbb.apply({"params": params, "batch_stats": v["batch_stats"]}, jst, jocc,
                                 train=True, mutable=["batch_stats"])
            return sum(jnp.sum(f ** 2) for f in
                       (out[k].features for k in LEVELS if out.get(k) is not None)), (out, upd)

        if train:
            (_, (out, upd)), grads = jax.value_and_grad(loss_fn, has_aux=True)(v["params"])
            grads = jax.tree_util.tree_map(np.asarray, grads)
            res["ref_grads"] = weights.det_backbone_3d_state(grads, v["batch_stats"])
            res["ref_stats"] = weights.det_backbone_3d_state(
                v["params"], jax.tree_util.tree_map(np.asarray, upd["batch_stats"]))
        else:
            out = jbb.apply(v, jst, jocc, train=False)
        res["ref"] = _jax_outputs(out)

        tbb = TB.VoxelBackBone8xOcc(IN_CH, CHANNELS, out_feat_type=cfg["out_feat_type"],
                                    occ_code_num=OCC, occ_conv_type=cfg["occ_conv_type"],
                                    occ_conv_exec=cfg["occ_conv_exec"], out_att=cfg["out_att"])
        sd = weights.det_backbone_3d_state(v["params"], v["batch_stats"])
        tbb.load_state_dict({k: torch.from_numpy(np.array(x)) for k, x in sd.items()},
                            strict=True)
        tbb.train(train)
        tst = _torch_st(feats, coords)
        with torch.set_grad_enabled(train):
            out = tbb(tst, tst.features[:, -OCC:])
        feats_out = [out[k].features for k in LEVELS if out.get(k) is not None]
        if train:
            sum(f.pow(2).sum() for f in feats_out).backward()
            res["grads"] = {n: p.grad.numpy() for n, p in tbb.named_parameters()}
            res["stats"] = {n: b.numpy() for n, b in tbb.named_buffers()
                            if n.endswith(("running_mean", "running_var"))}
        res["out"] = {k: out[k].features.detach().numpy() for k in LEVELS
                      if out.get(k) is not None}
    return res


def _close_to_max(a, b, rel, what):
    scale = max(float(np.abs(b).max()), 1e-12)
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * scale, err_msg=what)


# ------------------------------------------------------------ the module


@pytest.mark.parametrize("site_padding,kernel,padding,value", [
    ((1, 1, 1), 3, 1, 1.0 / 27),                # fix at levels 1-2
    ((1, 1, 1), 2, 1, 1.0),                     # avgpool: its own k=2 padding
    ((0, 1, 1), 3, (1, 1, 1), 1.0 / 27),        # level 3: conv4's (0,1,1) pair set
], ids=["k3p1", "k2p1", "level3"])
def test_fixed_sparse_conv_matches_jax(site_padding, kernel, padding, value):
    """`FixedSparseConv3d` over sites a k=3 stride-2 conv made with
    `site_padding`, against the JAX module with a fresh cache that holds
    those sites only (so it pairs with its own geometry). The port's asks
    for `padding`; where its kernel is the site conv's it pairs with the
    site conv's padding instead (level 3: (0,1,1), as both JAX paths do
    when the trunk conv shares the key)."""
    feats, coords = _inputs(1)
    feats = np.abs(feats)
    jst, tst = _jax_st(feats, coords), _torch_st(feats, coords)
    jsites = S.conv_output_sites(jst, 3, 2, site_padding, CAP)
    tsites = TS.conv_output_sites(tst, 3, 2, site_padding, CAP)
    np.testing.assert_array_equal(tsites[1].numpy(), np.asarray(jsites[1]))
    want_pad = site_padding if kernel == 3 else padding
    ref = S.FixedSparseConv3d(kernel, 2, want_pad, indice_key="k", default_value=value).apply(
        {}, jst, {("sites", "k"): jsites})
    cache = {("sites", "k"): tsites, ("sites_geometry", "k"): ((3, 3, 3), (2, 2, 2),
                                                               tuple(site_padding))}
    out = TS.FixedSparseConv3d(kernel, 2, padding, "k", value)(tst, cache)
    assert out.keys is tsites[0] and out.spatial_shape == tuple(jsites[3])
    np.testing.assert_allclose(out.features.numpy(), np.asarray(ref.features), rtol=0, atol=1e-6)
    assert np.abs(out.features.numpy()).max() > 0.1


@pytest.mark.parametrize("kernel", [3, 2])
def test_sum_pool_plain_matches_pallas_kernel(kernel):
    """K2 sum's plain version against the Pallas kernel (`fused_pool`, mode
    "sum", interpret mode) on bf16-exact inputs, so that the kernel's bf16
    table holds the same values."""
    feats, coords = _inputs(2)
    feats = np.round(feats * 16) / 16            # |x| < 16 on a 1/16 grid: exact in bf16
    jst, tst = _jax_st(feats, coords), _torch_st(feats, coords)
    jkeys, jcoords, _, _ = S.conv_output_sites(jst, 3, 2, 1, CAP)
    qk, G, TPG = P.qkeys_conv(jcoords, jkeys != S.INT32_MAX, GRID, BATCH, kernel, 2, 1, 128)
    pal = np.asarray(P.fused_pool(jst.features, jst.keys, qk, G, TPG, mode="sum",
                                  M=jkeys.shape[0], interpret=True))
    out = cuda_pool.sparse_sum_pool_plain(tst.features, tst.keys, torch.tensor(
        np.asarray(jcoords)), GRID, kernel, 2, 1).numpy()
    np.testing.assert_allclose(out, pal, rtol=0, atol=1e-5)
    assert np.abs(out).max() > 1.0


def test_jax_cpu_avgpool_sums_the_trunk_rulebook():
    """Trap recorded in ROADMAP Queue 3: the JAX package's CPU path caches a
    strided conv's rulebook under its indice_key alone, so an `avgpool`
    (k=2) after the trunk conv (k=3) of the same key sums the trunk's 27
    taps; with a fresh cache (and on its TPU path) it sums its own 8. The
    port sums the 8."""
    feats, coords = _inputs(3)
    feats = np.abs(feats)
    jst, tst = _jax_st(feats, coords), _torch_st(feats, coords)
    with f32_mode():
        trunk = S.SparseConv3d(4, 3, 2, 1, indice_key="spconv2")
        cache = {}
        trunk.apply(trunk.init(jax.random.PRNGKey(0), jst, {}), jst, cache)
        avg = S.FixedSparseConv3d(2, 2, 1, indice_key="spconv2", default_value=1.0)
        shared = np.asarray(avg.apply({}, jst, cache).features)
        fresh = np.asarray(avg.apply({}, jst, {("sites", "spconv2"): cache[("sites", "spconv2")]})
                           .features)
    coords_out = torch.tensor(np.asarray(cache[("sites", "spconv2")][1]))
    taps27 = cuda_pool.sparse_sum_pool_plain(tst.features, tst.keys, coords_out, GRID, 3, 2,
                                             1).numpy()
    taps8 = cuda_pool.sparse_sum_pool_plain(tst.features, tst.keys, coords_out, GRID, 2, 2,
                                            1).numpy()
    np.testing.assert_allclose(shared, taps27, rtol=0, atol=1e-5)
    np.testing.assert_allclose(fresh, taps8, rtol=0, atol=1e-5)
    assert np.abs(taps27 - taps8).max() > 0.5


# ------------------------------------------------------------ the backbone


@pytest.mark.parametrize("down", ["maxpool", "fix", "weight"])
def test_variant_eval_matches(down):
    """Every output level, eval (running statistics), to 1e-4."""
    res = _run(down, "big_bev_combine", False)
    assert sorted(res["out"]) == sorted(res["ref"]) == sorted(LEVELS)
    for k, ref in res["ref"].items():
        assert res["out"][k].shape == ref.shape, k
        np.testing.assert_allclose(res["out"][k], ref, rtol=1e-4, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("down", ["maxpool", "fix", "weight"])
def test_variant_train_matches(down):
    """Train mode (batch statistics): every output level, the moved running
    statistics and the gradients of the sum of squares of the outputs, each
    to 1e-3 of its tensor's max."""
    res = _run(down, "big_bev_combine", True)
    for k, ref in res["ref"].items():
        _close_to_max(res["out"][k], ref, 1e-3, k)
    assert res["stats"].keys() == {k for k in res["ref_stats"]
                                   if k.endswith(("running_mean", "running_var"))}
    for k, got in res["stats"].items():
        _close_to_max(got, res["ref_stats"][k], 1e-3, k)
    assert res["grads"].keys() == {k for k in res["ref_grads"]
                                   if not k.endswith(("running_mean", "running_var",
                                                      "num_batches_tracked"))}
    for k, got in res["grads"].items():
        _close_to_max(got, res["ref_grads"][k], 1e-3, k)
    moved = [k for k in ("att_conv1.0.0.weight", "att_conv2.0.0.weight",
                         "conv1_combine.0.0.weight") if np.abs(res["grads"][k]).max() > 0]
    assert len(moved) == 3, moved


def test_avgpool_matches_jax_tpu_path(monkeypatch):
    """`avgpool` against the JAX backbone on its TPU path (FixedSparseConv3d
    through the Pallas sum kernel, interpret mode), eval, every output
    level to 2e-2 of its max: the kernel rounds its table to bf16."""
    mode, fused_pool, calls = S._PALLAS_MODE, P.fused_pool, []

    def interpreted(*args, **kw):
        calls.append(kw["mode"])
        return fused_pool(*args, interpret=True, **kw)

    monkeypatch.setattr(P, "fused_pool", interpreted)
    S.set_pallas_mode("fix")
    try:
        res = _run.__wrapped__("avgpool", "big_bev_combine", False)
    finally:
        S.set_pallas_mode(mode)
    assert calls == ["sum"] * 6, calls           # the 3 levels, at init and at apply
    assert sorted(res["out"]) == sorted(LEVELS)
    for k, ref in res["ref"].items():
        _close_to_max(res["out"][k], ref, 2e-2, k)


@pytest.mark.parametrize("comb", ["None", "combine", "big_combine", "big_bev_combine"])
def test_out_feat_type_matches(comb):
    """Each OUT_FEAT_TYPE on the `fix` variant, eval, every level to 1e-4
    (`combine` ends on its own stride-(1,2,2) sites, spconv5)."""
    res = _run("fix", comb, False)
    assert ("x_combine" in res["out"]) == (comb != "None") == ("x_combine" in res["ref"])
    for k, ref in res["ref"].items():
        assert res["out"][k].shape == ref.shape, k
        np.testing.assert_allclose(res["out"][k], ref, rtol=1e-4, atol=1e-4, err_msg=k)


def test_refusals():
    with pytest.raises(NotImplementedError, match="identity"):
        TB.VoxelBackBone8xOcc(IN_CH, CHANNELS, occ_code_num=OCC,
                              occ_conv_type=("identity", "identity"), occ_conv_exec=(True, True))
    with pytest.raises(NotImplementedError, match="OUT_FEAT_TYPE"):
        TB.VoxelBackBone8xOcc(IN_CH, CHANNELS, out_feat_type=("None",) * 4 + ("bev",))
