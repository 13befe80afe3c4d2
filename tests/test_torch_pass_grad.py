"""OCC_PNT_UPDATE.PASS_GRAD in the port against the JAX package on the
CPU: K2's backward (the plain versions of `cuda_pool.sparse_pool_grad` /
`sparse_sum_pool_grad`) against torch.autograd of the plain forwards and
against the VJP that the JAX package takes of the pool's XLA twins
(`sparse.apply_rulebook_max` and the found-masked gather-sum,
`_pallas_pool_ad_bwd`), the fused merge's gradient where occ codes tie,
and one whole micro train step with PASS_GRAD through both packages
(`test_torch_train.train_step_both`)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close, f32_mode, full_micro_cfgs

# K2's backward against the JAX VJP, relative to the plain output's max
VJP_RTOL = 1e-6


def t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _table(seed, kind, n=900, shape=(11, 40, 36), batch=2):
    """A sparse table of 2-channel occ codes (padding rows appended):
    `flags` 0 / 1 codes (ties everywhere), `shared` a few shared
    probabilities, `random` distinct values; and strided (k=3, s=2, p=1)
    output sites (keys, coords, shape) of the table before a third of its
    rows became padding, so that some sites match no input."""
    from btcdet_tpu_torch.ops import sparse as TS

    rng = np.random.RandomState(seed)
    c = np.stack([rng.randint(0, batch, n), rng.randint(0, shape[0], n),
                  rng.randint(0, shape[1], n), rng.randint(0, shape[2], n)], 1)
    c = np.unique(c, axis=0).astype(np.int32)
    c = np.concatenate([c, np.full((37, 4), -1, np.int32)])
    if kind == "flags":
        f = rng.randint(0, 2, (len(c), 2)).astype(np.float32)
    elif kind == "shared":
        f = rng.choice(np.float32([0.3, 0.55, 0.8]), (len(c), 2))
    else:
        f = rng.rand(len(c), 2).astype(np.float32)
    f[c[:, 0] < 0] = 0
    keys, coords, _, out_shape = TS.conv_output_sites(TS.from_coords(t(f), t(c), shape, batch),
                                                      3, 2, 1, 8 * len(c))
    # a third of the rows dropped to padding: some output sites keep no input
    gone = rng.rand(len(c)) < 0.33
    c[gone], f[gone] = -1, 0
    return TS.from_coords(t(f), t(c), shape, batch), keys, coords, out_shape


def _maps(st, keys, coords, out_shape):
    from btcdet_tpu_torch.ops import cuda_conv

    nbr = cuda_conv.neighbor_map(st.keys, coords, st.spatial_shape, st.batch_size, 3, 2, 1)
    tnbr = cuda_conv.neighbor_map(keys, st.coords, out_shape, st.batch_size, 3, 2, 1,
                                  transpose=True)
    return nbr, tnbr


def _jax_rulebook(st, coords, keys):
    from btcdet_tpu.ops import sparse as S

    jst = S.from_coords(jnp.asarray(st.features.numpy()), jnp.asarray(st.coords.numpy()),
                        st.spatial_shape, st.batch_size)
    valid = jnp.asarray(keys.numpy()) != S.INT32_MAX
    idx, found = S.conv_rulebook(jst, jnp.asarray(coords.numpy()), valid, 3, 2, 1)
    return jst.features, idx, found


@pytest.mark.parametrize("kind", ["flags", "shared", "random"])
def test_sparse_pool_grad_plain_matches_autograd_and_jax(kind):
    """K2 max's backward: even shares for tied maxima, 0 for padding rows
    and for outputs no tap matched (their gradient is ignored)."""
    from btcdet_tpu.ops import sparse as S

    from btcdet_tpu_torch.ops import cuda_pool

    st, keys, coords, out_shape = _table(1, kind)
    nbr, tnbr = _maps(st, keys, coords, out_shape)
    f = st.features.clone().requires_grad_(True)
    out = cuda_pool.sparse_pool_plain(f, st.keys, coords, st.spatial_shape, 3, 2, 1, nbr)
    g = torch.from_numpy(np.random.RandomState(2).randn(*out.shape).astype(np.float32))
    empty = ~(nbr >= 0).any(0)
    assert empty.any() and (coords[:, 0] < 0).any()
    df = cuda_pool.sparse_pool_grad_plain(st.features, out.detach(), g, nbr, tnbr)
    (auto,) = torch.autograd.grad(out, f, g)
    tol = VJP_RTOL * float(out.detach().abs().max())
    np.testing.assert_allclose(df.numpy(), auto.numpy(), rtol=0, atol=tol)
    assert (df[st.coords[:, 0] < 0] == 0).all()

    feats, idx, found = _jax_rulebook(st, coords, keys)
    _, vjp = jax.vjp(lambda x: S.apply_rulebook_max(x, idx, found), feats)
    (ref,) = vjp(jnp.asarray(g.numpy()))
    np.testing.assert_allclose(df.numpy(), np.asarray(ref), rtol=0, atol=tol)
    # the tie-heavy tables hold maxima shared by 2 and more taps
    tied = ((nbr >= 0)[..., None] & (st.features[nbr.clamp(min=0).long()] == out.detach()[None]))
    assert (tied.sum(0) > 2).any() == (kind != "random")


@pytest.mark.parametrize("kind", ["flags", "random"])
def test_sparse_sum_pool_grad_plain_matches_autograd_and_jax(kind):
    from btcdet_tpu_torch.ops import cuda_pool

    st, keys, coords, out_shape = _table(3, kind)
    nbr, tnbr = _maps(st, keys, coords, out_shape)
    f = st.features.clone().requires_grad_(True)
    out = cuda_pool.sparse_sum_pool_plain(f, st.keys, coords, st.spatial_shape, 3, 2, 1, nbr)
    g = torch.from_numpy(np.random.RandomState(4).randn(*out.shape).astype(np.float32))
    df = cuda_pool.sparse_sum_pool_grad_plain(g, tnbr)
    (auto,) = torch.autograd.grad(out, f, g)
    tol = VJP_RTOL * float(out.detach().abs().max())
    np.testing.assert_allclose(df.numpy(), auto.numpy(), rtol=0, atol=tol)
    assert (df[st.coords[:, 0] < 0] == 0).all()

    feats, idx, found = _jax_rulebook(st, coords, keys)
    _, vjp = jax.vjp(lambda x: jnp.where(found[..., None], x[idx], 0.0).sum(axis=0), feats)
    (ref,) = vjp(jnp.asarray(g.numpy()))
    np.testing.assert_allclose(df.numpy(), np.asarray(ref), rtol=0, atol=tol)


@pytest.mark.parametrize("module", ["maxpool", "fix"])
def test_pool_modules_backward_through_the_function(module):
    """SparseMaxPool3d / FixedSparseConv3d with an input that needs a
    gradient run `SparsePoolFunction`: the gradient is the plain backward
    (times the fixed weight), and the transpose-query map is cached in the
    forward's cache."""
    from btcdet_tpu_torch.ops import cuda_pool
    from btcdet_tpu_torch.ops import sparse as TS

    st, _, _, _ = _table(5, "flags")
    cache = {}
    TS.SparseConv3d(2, 4, 3, 2, 1, indice_key="spconv2", frame_capacity=(400, 400))(st, cache)
    pool = (TS.SparseMaxPool3d(3, 2, 1, indice_key="spconv2") if module == "maxpool"
            else TS.FixedSparseConv3d(3, 2, 1, indice_key="spconv2", default_value=1.0 / 27))
    f = st.features.clone().requires_grad_(True)
    out = pool(st.replace(features=f), cache)
    g = torch.from_numpy(np.random.RandomState(6).randn(*out.features.shape).astype(np.float32))
    out.features.backward(g)
    tmaps = [v for k, v in cache.items() if k[0] == "tnbr"]
    assert len(tmaps) == 1
    keys, coords = out.keys, out.coords
    nbr, tnbr = _maps(st, keys, coords, out.spatial_shape)
    assert torch.equal(tmaps[0][2], tnbr)
    if module == "maxpool":
        want = cuda_pool.sparse_pool_grad_plain(st.features, out.features.detach(), g, nbr, tnbr)
    else:
        want = cuda_pool.sparse_sum_pool_grad_plain(g * (1.0 / 27), tnbr)
    assert torch.equal(f.grad, want)


# ------------------------------------------------------------ merge ties


def _tied_merge(n_tied):
    """One det voxel and `n_tied` occ points in one new cell, their occ
    codes (prob, 1) equal: the gradient of the merged row's occ code with
    respect to each point's code, both packages."""
    from btcdet_tpu.ops import voxelizer as JV

    from btcdet_tpu_torch.ops import voxelizer as TV

    dvox = np.zeros((1, 2, 5, 4), np.float32)
    dvox[0, 0, 0] = (0.5, 0.5, 0.5, 0.1)
    dc = np.array([[[0, 0, 0, 0], [-1, -1, -1, -1]]], np.int32)
    dn = np.array([[1, 0]], np.int32)
    opts = np.array([[[2.5 + 0.1 * i, 1.5, 0.5, 0.0, 0.6, 1.0] for i in range(n_tied)]],
                    np.float32)
    valid = np.ones((1, n_tied), bool)
    kw = dict(grid_size=(4, 4, 2), extra=2, max_points=8, num_raw_features=4)
    w = np.array([1.0, 0.0], np.float32)              # d(prob channel of the code)

    def jax_code(o):
        out = JV.merge_points_into_voxel_features(
            jnp.asarray(dvox[0]), jnp.asarray(dc[0]), jnp.asarray(dn[0]), o, jnp.asarray(valid[0]),
            lo=jnp.zeros(3), vs=jnp.ones(3), **kw)
        return (out[1] * w).sum()

    ref = np.asarray(jax.grad(jax_code)(jnp.asarray(opts[0])))[:, 4]
    o = t(opts).requires_grad_(True)
    out = TV.merge_points_into_voxel_features(t(dvox), t(dc), t(dn), o, t(valid),
                                              lo=torch.zeros(3), vs=torch.ones(3), **kw)
    (out[1] * t(w)).sum().backward()
    return o.grad[0, :, 4].numpy(), ref


def test_merge_occ_code_gradient_two_way_tie_matches():
    out, ref = _tied_merge(2)
    np.testing.assert_array_equal(out, [0.5, 0.5])
    np.testing.assert_array_equal(ref, [0.5, 0.5])


def test_merge_occ_code_gradient_three_way_tie_differs():
    """Recorded difference (ROADMAP Queue 3): the JAX package takes the
    merge's occ-code max with jnp.maximum inside an associative_scan, whose
    VJP halves a tie at each step, so three tied points share the gradient
    by the scan's tree; the port's scatter amax shares it evenly. Both
    give the row's whole gradient."""
    out, ref = _tied_merge(3)
    np.testing.assert_allclose(out, [1 / 3] * 3, rtol=1e-6)
    assert abs(ref.sum() - 1.0) < 1e-6
    np.testing.assert_array_equal(np.sort(ref), [0.25, 0.25, 0.5])


# ------------------------------------------------------------- whole step


@functools.cache
def pass_grad_step():
    """One micro train step with PASS_GRAD in both packages
    (`train_step_both`: same weights, batch and sampled rois), and the
    occ loss's own gradients in the occ subnet (the JAX `OccSubnet` alone
    on the same weights and batch: what PASS_GRAD False gives it)."""
    from btcdet_tpu.config import CfgBox
    from btcdet_tpu.models.occ import occ_subnet as JOS

    from btcdet_tpu_torch import weights as W
    from test_torch_train import train_step_both

    data_cfg, model_cfg = full_micro_cfgs(DP_RATIO=0.0)
    model_cfg.OCC.OCC_PNT_UPDATE.PASS_GRAD = True
    res = train_step_both(data_cfg, model_cfg, 2048, 4)
    v = res["variables"]
    det_vs = next(tuple(p.VOXEL_SIZE) for p in data_cfg.DATA_PROCESSOR
                  if p.NAME == "det_transform_points_to_voxels")
    with f32_mode():
        net = JOS.OccSubnet(model_cfg=CfgBox(model_cfg.OCC), data_cfg=CfgBox(data_cfg),
                            point_cloud_range=tuple(data_cfg.POINT_CLOUD_RANGE),
                            det_voxel_size=det_vs, fused_vfe_nrf=4)
        jb = {k: jnp.asarray(x) for k, x in res["batch"].items()}
        bs = v["batch_stats"]["occ_subnet"]

        def occ_loss(params):
            out, _ = net.apply({"params": params, "batch_stats": bs}, jb, train=True,
                               rngs={"sampling": jax.random.PRNGKey(3)}, mutable=["batch_stats"])
            return out["loss"]
        grads = jax.jit(jax.grad(occ_loss))(v["params"]["occ_subnet"])
    res["occ_only"] = {k: np.array(x) for k, x in W.occ_subnet_state(
        jax.tree_util.tree_map(np.asarray, grads), bs).items() if k in res["grads"]}
    return res


def test_pass_grad_step_matches():
    """Loss terms to 1e-4, every gradient within 1e-3 of its tensor's max
    (the occ subnet's included, which the det losses now reach)."""
    r = pass_grad_step()
    for k, v in r["ref_metrics"].items():
        if k in r["metrics"]:
            assert_close(r["metrics"][k], float(np.asarray(v)), err_msg=k)
    grads = {n: np.asarray(g) for n, g in r["ref_grads"].items() if n in r["grads"]}
    assert len(grads) == len(r["grads"])
    for n, g in grads.items():
        scale = max(float(np.abs(g).max()), 1e-12)
        assert float(np.abs(r["grads"][n] - g).max()) <= 1e-3 * scale, n


def test_pass_grad_det_losses_reach_the_occ_subnet():
    """On both sides the occ subnet's gradients differ from the occ loss's
    own (its gradients without PASS_GRAD) by far more than the tolerance."""
    r = pass_grad_step()
    for side in ("grads", "ref_grads"):
        moved = []
        for n, g in r["occ_only"].items():
            scale = max(float(np.abs(g).max()), 1e-12)
            moved.append(float(np.abs(np.asarray(r[side][n]) - g).max()) / scale)
        assert max(moved) > 1e-2, (side, max(moved))
        assert all(np.isfinite(moved))
