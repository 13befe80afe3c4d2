"""The sparse side modules of the port against the JAX package: the
transpose conv's site set and map, `SparseConvTranspose3d` and
`SparseInverseConv3d` (forward, df and dW), `SparseConvBlock`'s `spdeconv`
and `inverseconv` types, and `VoxelResBackBone8x` (every level, the
gradients of a scalar loss in train mode, the weight bridge
`weights.res_backbone_3d_state`). Inputs from a numpy seed, float32
(`BTCDET_F32=1`), CPU: the kernels' plain versions (K1 forward and df, K3).

Tolerances: sites, keys, coords, maps and launch counts exact; f32 outputs
1e-4; gradients 1e-3 of each tensor's max. K1 and K3 at these geometries on
the card: `tests/test_torch_kernels.py -k transpose`.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from btcdet_tpu.models import backbones_3d as JB
from btcdet_tpu.ops import sparse as JS
from btcdet_tpu_torch import weights
from btcdet_tpu_torch.models import backbones_3d as TB
from btcdet_tpu_torch.ops import cuda_conv
from btcdet_tpu_torch.ops import sparse as TS
from torch_parity import assert_close, f32_mode, perturb_variables

GRID = (41, 24, 20)
BATCH = 2
TRANSPOSE_CASES = [((2, 2, 2), 2, 0), (3, 2, 1), ((3, 1, 1), (2, 1, 1), 0), (3, 2, (0, 1, 1))]
TRANSPOSE_IDS = ["k2s2", "k3s2p1", "k311", "k3p011"]


def _pair(seed, n=260, C=8, grid=(9, 12, 10), batch=BATCH, cap=None):
    """The same random sparse tensor in both packages (padding rows mixed in)."""
    rng = np.random.RandomState(seed)
    c = np.stack([rng.randint(0, batch, n)] + [rng.randint(0, g, n) for g in grid], 1)
    c = np.unique(c, axis=0).astype(np.int32)
    cap = cap or len(c) + 37
    c = np.concatenate([c, np.full((cap - len(c), 4), -1, np.int32)])
    c = c[rng.permutation(len(c))]
    f = rng.randn(len(c), C).astype(np.float32)
    f[c[:, 0] < 0] = 0
    jst = JS.from_coords(jnp.asarray(f), jnp.asarray(c), grid, batch)
    tst = TS.from_coords(torch.from_numpy(f), torch.from_numpy(c), grid, batch)
    return jst, tst


# one XLA compile per geometry instead of one per eager operation
_jax_tsites = jax.jit(JS.transpose_output_sites, static_argnums=(1, 2, 3, 4))


def _weights(seed, K, cin, cout):
    return (np.random.RandomState(seed).randn(K, cin, cout) / np.sqrt(K * cin)).astype(np.float32)


def _close_to_max(a, b, rel=1e-3, what=""):
    scale = max(float(np.abs(b).max()), 1e-12)
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * scale, err_msg=what)
    assert scale > 1e-6, what


# ------------------------------------------------- the transpose pairing


@pytest.mark.parametrize("kernel,stride,padding", TRANSPOSE_CASES, ids=TRANSPOSE_IDS)
@pytest.mark.parametrize("batch,cap_frac", [(2, None), (2, 0.3), (1, 0.4)],
                         ids=["full", "cut", "b1-cut"])
def test_transpose_sites_match_jax(kernel, stride, padding, batch, cap_frac):
    """`transpose_output_sites` row for row (keys, coords, nnz, grid),
    also where the capacity cuts (per frame at B=2, globally at B=1)."""
    jst, tst = _pair(1, batch=batch)
    K = int(np.prod(cuda_conv.triple(kernel)))
    full = K * tst.capacity
    cap = full if cap_frac is None else int(cap_frac * int(tst.nnz) * K) // batch * batch
    jk, jc, jn, jshape = _jax_tsites(jst, kernel, stride, padding, cap)
    tk, tc, tn, tshape = TS.transpose_output_sites(tst, kernel, stride, padding, cap)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert int(tn) == int(jn) and tuple(tshape) == tuple(jshape)
    total = int(_jax_tsites(jst, kernel, stride, padding, full)[2])
    if cap_frac is not None:
        assert int(tn) <= cap < total, (int(tn), cap, total)


@pytest.mark.parametrize("kernel,stride,padding", TRANSPOSE_CASES, ids=TRANSPOSE_IDS)
def test_plain_transpose_map_matches_transpose_rulebook(kernel, stride, padding):
    """K1's plain transpose-query map of a transpose conv (table: its
    input, queries: its output sites) equals `transpose_rulebook`."""
    jst, tst = _pair(2)
    jk, jc, _, _ = _jax_tsites(jst, kernel, stride, padding, 8 * jst.capacity)
    idx, found = JS.transpose_rulebook(jst, jc, jk != JS.INT32_MAX, kernel, stride, padding)
    want = np.where(np.asarray(found), np.asarray(idx), -1)
    nbr = cuda_conv.neighbor_map_plain(tst.keys, torch.tensor(np.asarray(jc)), tst.spatial_shape,
                                       kernel, stride, padding, transpose=True)
    np.testing.assert_array_equal(nbr.numpy(), want)
    assert (want >= 0).sum() > 0


def _jax_grads(module, params_tree, st, f, cache_fn):
    """(out features, d/df, d/dW) of sum(out ** 2) through a JAX conv."""
    def loss(ff, w):
        out = module.apply({"params": {"kernel": w}}, st.replace(features=ff), cache_fn())
        return jnp.sum(out.features ** 2), out

    (_, out), (gf, gw) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        f, params_tree)
    return out, np.asarray(gf), np.asarray(gw)


def _port_grads(module, st, w, cache):
    with torch.no_grad():
        module.weight.copy_(torch.from_numpy(w.reshape(module.weight.shape)))
    f = st.features.clone().requires_grad_()
    out = module(st.replace(features=f), cache)
    (out.features ** 2).sum().backward()
    return out, f.grad.numpy(), module.weight.grad.reshape(w.shape).numpy()


@pytest.mark.parametrize("kernel,stride,padding", TRANSPOSE_CASES, ids=TRANSPOSE_IDS)
def test_transpose_conv_matches_jax(kernel, stride, padding):
    """`SparseConvTranspose3d`: sites exact, forward 1e-4, df (K1 over the
    forward-query map of its output table) and dW (K3 over the forward's
    transpose map) against `jax.grad` at 1e-3 of each max."""
    jst, tst = _pair(3, C=6)
    K = int(np.prod(cuda_conv.triple(kernel)))
    w = _weights(4, K, 6, 5)
    with f32_mode():
        jout, jgf, jgw = _jax_grads(JS.SparseConvTranspose3d(5, kernel, stride, padding),
                                    jnp.asarray(w), jst, jst.features, dict)
        tmod = TS.SparseConvTranspose3d(6, 5, kernel, stride, padding)
        tout, tgf, tgw = _port_grads(tmod, tst, w, {})
    np.testing.assert_array_equal(tout.keys.numpy(), np.asarray(jout.keys))
    np.testing.assert_array_equal(tout.coords.numpy(), np.asarray(jout.coords))
    assert tout.spatial_shape == tuple(jout.spatial_shape) and int(tout.nnz) == int(jout.nnz)
    assert_close(tout.features.detach().numpy(), np.asarray(jout.features))
    _close_to_max(tgf, jgf, what="df")
    _close_to_max(tgw, jgw, what="dW")


@pytest.mark.parametrize("kernel,stride,padding", [(3, 2, 1), (3, 2, (0, 1, 1)),
                                                   ((2, 2, 2), 2, 0)], ids=["k3", "p011", "k2"])
def test_inverse_conv_matches_jax(kernel, stride, padding):
    """`SparseInverseConv3d` restores the sites a strided conv recorded
    under its key: sites exact, forward 1e-4, df and dW 1e-3 of each max
    against `jax.grad` of the JAX module on the same coarse tensor."""
    jst, tst = _pair(5, C=6)
    K = int(np.prod(cuda_conv.triple(kernel)))
    w1, w2 = _weights(6, K, 6, 7), _weights(7, K, 7, 6)
    with f32_mode():
        jcache = {}
        jconv = JS.SparseConv3d(7, kernel, stride, padding, indice_key="sp")
        jcoarse = jconv.apply({"params": {"kernel": jnp.asarray(w1)}}, jst, jcache)
        jout, jgf, jgw = _jax_grads(
            JS.SparseInverseConv3d(6, kernel, indice_key="sp", stride=stride, padding=padding),
            jnp.asarray(w2), jcoarse, jcoarse.features, lambda: jcache)
        tcache = {}
        tconv = TS.SparseConv3d(6, 7, kernel, stride, padding, indice_key="sp")
        with torch.no_grad():
            tconv.weight.copy_(torch.from_numpy(w1.reshape(tconv.weight.shape)))
            tcoarse = tconv(tst, tcache)
        tinv = TS.SparseInverseConv3d(7, 6, kernel, indice_key="sp", stride=stride,
                                      padding=padding)
        tout, tgf, tgw = _port_grads(tinv, tcoarse, w2, tcache)
    assert tout.keys is tst.keys and tout.coords is tst.coords
    np.testing.assert_array_equal(tout.keys.numpy(), np.asarray(jout.keys))
    assert tout.spatial_shape == tuple(jout.spatial_shape)
    assert_close(tout.features.detach().numpy(), np.asarray(jout.features))
    _close_to_max(tgf, jgf, what="df")
    _close_to_max(tgw, jgw, what="dW")


def test_inverse_conv_needs_the_recorded_sites():
    _, tst = _pair(8)
    with pytest.raises(RuntimeError, match="no input sites recorded"):
        TS.SparseInverseConv3d(8, 4, 3, indice_key="nowhere", stride=2, padding=1)(tst, {})


@pytest.mark.parametrize("conv_type", ["spdeconv", "inverseconv"])
def test_sparse_conv_block_types_match_jax(conv_type):
    """`SparseConvBlock` with the two conv types (conv + masked BN + ReLU,
    eval statistics moved off identity), its weights through
    `weights.sparse_block_state`."""
    jst, tst = _pair(9, C=6)
    kw = dict(out_channels=5, kernel_size=3, stride=2, padding=1, conv_type=conv_type,
              indice_key="sp")
    with f32_mode():
        jcache, tcache = {}, {}
        if conv_type == "inverseconv":
            w = _weights(10, 27, 6, 8)
            jst = JS.SparseConv3d(8, 3, 2, 1, indice_key="sp").apply(
                {"params": {"kernel": jnp.asarray(w)}}, jst, jcache)
            tconv = TS.SparseConv3d(6, 8, 3, 2, 1, indice_key="sp")
            with torch.no_grad():
                tconv.weight.copy_(torch.from_numpy(w.reshape(tconv.weight.shape)))
                tst = tconv(tst, tcache)
        jblk = JB.SparseConvBlock(**kw)
        v = perturb_variables(jblk.init(jax.random.PRNGKey(0), jst, dict(jcache)))
        jout = jblk.apply(v, jst, jcache)
        tblk = TB.SparseConvBlock(tst.features.shape[1], 5, 3, 2, 1, conv_type, "sp").eval()
        sd = weights.sparse_block_state(v["params"], v["batch_stats"], "")
        tblk.load_state_dict({k: torch.from_numpy(np.array(x)) for k, x in sd.items()},
                             strict=True)
        with torch.no_grad():
            tout = tblk(tst, tcache)
    np.testing.assert_array_equal(tout.keys.numpy(), np.asarray(jout.keys))
    assert_close(tout.features.numpy(), np.asarray(jout.features))
    assert np.abs(np.asarray(jout.features)).max() > 0.1


# ------------------------------------------------ the residual backbone

RES_CHANNELS = (4, 8, 8, 16, 16)
RES_IN = 4
RES_LEVELS = ("encoded", "x_conv1", "x_conv2", "x_conv3", "x_conv4")


def _res_inputs():
    rng = np.random.RandomState(11)
    per_frame, cap = 220, 512
    coords = []
    for b in range(BATCH):
        c = np.stack([np.full(3 * per_frame, b)] + [rng.randint(0, g, 3 * per_frame)
                                                    for g in GRID], 1)
        coords.append(np.unique(c, axis=0)[:per_frame])
    coords = np.concatenate(coords + [np.full((cap - BATCH * per_frame, 4), -1)]).astype(np.int32)
    return rng.randn(cap, RES_IN).astype(np.float32), coords


@functools.cache
def _res_variables():
    """The JAX `VoxelResBackBone8x`, its input and its variables (JAX
    init, BN moved off identity)."""
    feats, coords = _res_inputs()
    with f32_mode():
        jst = JS.from_coords(jnp.asarray(feats), jnp.asarray(coords), GRID, BATCH)
        jbb = JB.VoxelResBackBone8x(input_channels=RES_IN, channels=RES_CHANNELS)
        v = perturb_variables(jax.jit(jbb.init)(jax.random.PRNGKey(0), jst))
    return jbb, jst, v


@functools.cache
def _res_run(train: bool) -> dict:
    """The JAX `VoxelResBackBone8x` and the port's on one input (the
    weights carried by `weights.res_backbone_3d_state`). Eval: each
    level's features and keys. Train: also the gradients of the sum of
    squares of every level and the moved BN statistics."""
    feats, coords = _res_inputs()
    jbb, jst, v = _res_variables()
    res = {}
    with f32_mode():

        def loss_fn(params):
            out, upd = jbb.apply({"params": params, "batch_stats": v["batch_stats"]}, jst,
                                 train=True, mutable=["batch_stats"])
            return sum(jnp.sum(out[k].features ** 2) for k in RES_LEVELS), (out, upd)

        if train:
            (_, (out, upd)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
                v["params"])
            res["ref_grads"] = weights.res_backbone_3d_state(
                jax.tree_util.tree_map(np.asarray, grads), v["batch_stats"])
            res["ref_stats"] = weights.res_backbone_3d_state(
                v["params"], jax.tree_util.tree_map(np.asarray, upd["batch_stats"]))
        else:
            out = jax.jit(lambda vv, st: jbb.apply(vv, st, train=False))(v, jst)
        res["ref"] = {k: (np.asarray(out[k].features), np.asarray(out[k].keys),
                          tuple(out[k].spatial_shape)) for k in RES_LEVELS}

        tbb = TB.VoxelResBackBone8x(RES_IN, RES_CHANNELS)
        sd = weights.res_backbone_3d_state(v["params"], v["batch_stats"])
        tbb.load_state_dict({k: torch.from_numpy(np.array(x)) for k, x in sd.items()},
                            strict=True)
        tbb.train(train)
        tst = TS.from_coords(torch.from_numpy(feats), torch.from_numpy(coords), GRID, BATCH)
        with torch.set_grad_enabled(train):
            tout = tbb(tst)
        if train:
            sum(tout[k].features.pow(2).sum() for k in RES_LEVELS).backward()
            res["grads"] = {n: p.grad.numpy() for n, p in tbb.named_parameters()}
            res["stats"] = {n: b.numpy() for n, b in tbb.named_buffers()
                            if n.endswith(("running_mean", "running_var"))}
        res["out"] = {k: (tout[k].features.detach().numpy(), tout[k].keys.numpy(),
                          tout[k].spatial_shape) for k in RES_LEVELS}
        assert tout["x_combine"] is None and tout["encoded_stride"] == 8
    return res


@pytest.mark.parametrize("level", RES_LEVELS)
def test_res_backbone_levels_match_jax(level):
    """Each output level of the eval forward: keys and grid exact,
    features 1e-4."""
    r = _res_run(False)
    (f, k, shape), (jf, jk, jshape) = r["out"][level], r["ref"][level]
    np.testing.assert_array_equal(k, jk)
    assert shape == jshape
    assert_close(f, jf, err_msg=level)
    assert np.abs(jf).max() > 0.1


def test_res_backbone_train_gradients_match_jax():
    """Train mode (batch statistics): every parameter's gradient of the
    sum of squares of all levels at 1e-3 of its max, the moved running
    statistics at 1e-4, the levels at 1e-4."""
    r = _res_run(True)
    for level in RES_LEVELS:
        assert_close(r["out"][level][0], r["ref"][level][0], err_msg=level)
    assert set(r["grads"]) == {k for k in r["ref_grads"] if k.endswith(("weight", "bias"))}
    for name, g in r["grads"].items():
        _close_to_max(g, r["ref_grads"][name], what=name)
    for name, s in r["stats"].items():
        assert_close(s, r["ref_stats"][name], err_msg=name)


def test_res_backbone_names_and_synth_weights():
    """The reference's names, the bridge covering every entry, and
    `weights.synth_state_dict` loading by name."""
    tbb = TB.VoxelResBackBone8x(RES_IN, RES_CHANNELS)
    names = set(tbb.state_dict())
    for want in ("conv_input.0.weight", "conv_input.1.running_var", "conv1.0.conv1.weight",
                 "conv1.0.bn2.bias", "conv2.0.0.weight", "conv2.0.1.running_mean",
                 "conv2.1.conv2.weight", "conv4.1.bn1.weight", "conv_out.0.weight"):
        assert want in names, want
    assert tuple(tbb.state_dict()["conv_out.0.weight"].shape) == (3, 1, 1, 16, 16)
    tbb.load_state_dict(weights.synth_state_dict(tbb), strict=True)
    _, _, v = _res_variables()
    assert set(weights.res_backbone_3d_state(v["params"], v["batch_stats"])) == names


def test_res_backbone_pairs_13_convs_over_8_maps(monkeypatch):
    """One eval forward runs 13 gather-GEMMs over 8 neighbour maps: the
    level-1 table is shared by conv_input and res1's pair, each later
    level's by its residual pair; each strided conv builds its own."""
    counts = {"neighbor_map": 0, "sparse_conv": 0}
    for name in counts:
        orig = getattr(cuda_conv, name)

        def counted(*a, _orig=orig, _name=name, **kw):
            counts[_name] += 1
            return _orig(*a, **kw)
        monkeypatch.setattr(cuda_conv, name, counted)
    feats, coords = _res_inputs()
    tbb = TB.VoxelResBackBone8x(RES_IN, RES_CHANNELS).eval()
    tst = TS.from_coords(torch.from_numpy(feats), torch.from_numpy(coords), GRID, BATCH)
    with torch.no_grad():
        tbb(tst)
    assert counts == {"neighbor_map": 8, "sparse_conv": 13}
