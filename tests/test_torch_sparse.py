"""Sparse engine parity: the port's `ops/sparse.py` and the plain version
of kernel K1 (`ops/cuda_conv.py`) against the JAX engine
(`btcdet_tpu/ops/sparse.py`, XLA rulebooks) and the Pallas conv kernel in
interpret mode. Discrete outputs (keys, site sets, rulebooks) exact;
f32 convs at 1e-4; bf16-rounded inputs against Pallas at 2e-2."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from btcdet_tpu.ops import pallas_conv as JP
from btcdet_tpu.ops import sparse as JS
from btcdet_tpu_torch.ops import cuda_conv
from btcdet_tpu_torch.ops import sparse as TS
from torch_parity import assert_close, f32_mode


def _coords(seed, n, shape, batch, cap=None):
    rng = np.random.RandomState(seed)
    nz, ny, nx = shape
    c = np.stack([rng.randint(0, batch, n), rng.randint(0, nz, n),
                  rng.randint(0, ny, n), rng.randint(0, nx, n)], 1)
    c = np.unique(c, axis=0).astype(np.int32)
    rng.shuffle(c)
    cap = cap or ((len(c) + 255) // 256) * 256
    # padding rows interleaved with live rows: from_coords must sort them out
    pad = np.full((cap - len(c), 4), -1, np.int32)
    c = np.concatenate([c, pad])
    return c[rng.permutation(len(c))]


def make_pair(seed=0, n=1500, shape=(11, 40, 36), batch=2, C=16, cap=None):
    """The same random sparse tensor in both packages."""
    coords = _coords(seed, n, shape, batch, cap)
    rng = np.random.RandomState(seed + 100)
    feats = rng.randn(len(coords), C).astype(np.float32)
    feats[coords[:, 0] < 0] = 0
    jst = JS.from_coords(jnp.asarray(feats), jnp.asarray(coords), shape, batch)
    tst = TS.from_coords(torch.from_numpy(feats), torch.from_numpy(coords), shape, batch)
    return jst, tst


def bf16(x):
    return torch.from_numpy(np.asarray(x)).to(torch.bfloat16).float().numpy()


def test_linear_key_is_y_major():
    shape = (5, 7, 9)
    coords = np.array([[1, 2, 3, 4], [0, 4, 6, 8], [-1, -1, -1, -1], [1, 0, 1, 0]], np.int32)
    keys = TS.linear_key(torch.from_numpy(coords), shape, 2).numpy()
    nz, ny, nx = shape
    b, z, y, x = coords[0]
    assert keys[0] == ((b * ny + y) * nz + z) * nx + x
    assert keys[2] == cuda_conv.INT32_MAX
    np.testing.assert_array_equal(keys, np.asarray(JS.linear_key(jnp.asarray(coords), shape, 2)))
    # one step in y moves a whole z-x slab, one step in z one x line
    k = lambda c: int(TS.linear_key(torch.tensor([c], dtype=torch.int32), shape, 2)[0])
    assert k([0, 0, 1, 0]) - k([0, 0, 0, 0]) == nz * nx
    assert k([0, 1, 0, 0]) - k([0, 0, 0, 0]) == nx
    back = TS.key_to_coords(torch.from_numpy(keys), shape).numpy()
    np.testing.assert_array_equal(back, coords)


def test_from_coords_with_aux():
    shape, batch = (11, 40, 36), 2
    coords = _coords(3, 900, shape, batch)
    rng = np.random.RandomState(4)
    feats = rng.randn(len(coords), 8).astype(np.float32)
    aux = rng.randn(len(coords), 2).astype(np.float32)
    jst, jaux = JS.from_coords(jnp.asarray(feats), jnp.asarray(coords), shape, batch,
                               aux=jnp.asarray(aux))
    tst, taux = TS.from_coords(torch.from_numpy(feats), torch.from_numpy(coords), shape, batch,
                               aux=torch.from_numpy(aux))
    np.testing.assert_array_equal(tst.keys.numpy(), np.asarray(jst.keys))
    np.testing.assert_array_equal(tst.coords.numpy(), np.asarray(jst.coords))
    live = int(jst.nnz)
    assert int(tst.nnz) == live
    np.testing.assert_array_equal(tst.features.numpy()[:live], np.asarray(jst.features)[:live])
    np.testing.assert_array_equal(taux.numpy()[:live], np.asarray(jaux)[:live])
    # the aux table rides the sort: row i of aux still belongs to row i
    src = {tuple(c): i for i, c in enumerate(coords) if c[0] >= 0}
    for i in range(live):
        j = src[tuple(tst.coords[i].tolist())]
        np.testing.assert_array_equal(taux[i].numpy(), aux[j])


def test_lookup_matches():
    jst, tst = make_pair(seed=8)
    rng = np.random.RandomState(8)
    live = np.asarray(jst.keys)[: int(jst.nnz)]
    # hits, near misses, padding keys and the -1 of an off-grid tap
    q = np.concatenate([rng.choice(live, 300), rng.choice(live, 300) + 1,
                        np.full(5, JS.INT32_MAX), np.full(5, -1)]).astype(np.int32)
    q = q[rng.permutation(len(q))].reshape(2, -1)
    ji, jf = (np.asarray(a) for a in JS.lookup(jst.keys, jnp.asarray(q)))
    ti, tf = cuda_conv.lookup(tst.keys, torch.from_numpy(q))
    np.testing.assert_array_equal(tf.numpy(), jf & (q >= 0))
    np.testing.assert_array_equal(ti.numpy()[jf], ji[jf])
    assert 300 <= jf.sum() < q.size


@pytest.mark.parametrize("batch,cap_frac", [(2, None), (2, 0.4), (1, 0.5)],
                         ids=["no-cap", "per-frame-cap-binds", "global-cap-binds"])
def test_output_sites(batch, cap_frac):
    jst, tst = make_pair(seed=5, batch=batch)
    full = jst.capacity * 4
    if cap_frac is None:
        cap = full
    else:
        _, _, nnz_full, _ = JS.conv_output_sites(jst, 3, 2, 1, full)
        cap = int(int(nnz_full) * cap_frac) // batch * batch
    jk, jc, jn, jshape = JS.conv_output_sites(jst, 3, 2, 1, cap)
    tk, tc, tn, tshape = TS.conv_output_sites(tst, 3, 2, 1, cap)
    assert tshape == jshape
    assert int(tn) == int(jn)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    if cap_frac is not None:
        assert int(tn) <= cap < int(JS.conv_output_sites(jst, 3, 2, 1, full)[2])


@pytest.mark.parametrize("kernel,stride,padding", [
    (3, 1, 1), (3, 2, 1), ((3, 1, 1), (2, 1, 1), 0), ((2, 1, 1), (2, 1, 1), 0),
    (3, 2, (0, 1, 1))])
def test_rulebook_matches(kernel, stride, padding):
    jst, tst = make_pair(seed=6)
    if stride == 1:
        ji, jf = JS.subm_rulebook(jst, kernel)
        ti, tf = TS.subm_rulebook(tst, kernel)
    else:
        keys, coords, _, _ = JS.conv_output_sites(jst, kernel, stride, padding, jst.capacity)
        ji, jf = JS.conv_rulebook(jst, coords, keys != JS.INT32_MAX, kernel, stride, padding)
        ti, tf = TS.conv_rulebook(tst, torch.tensor(np.asarray(coords)), kernel, stride,
                                  padding)
    jf, ji = np.asarray(jf), np.asarray(ji)
    np.testing.assert_array_equal(tf.numpy(), jf)
    np.testing.assert_array_equal(ti.numpy()[jf], ji[jf])
    assert jf.any()


CONV_CASES = [  # kernel, stride, padding, Cin, Cout
    (3, 1, 1, 4, 16), (3, 1, 1, 256, 32), (3, 2, 1, 4, 16), (3, 2, 1, 256, 32),
    ((3, 1, 1), (2, 1, 1), 0, 4, 16), ((3, 1, 1), (2, 1, 1), 0, 256, 32),
    ((2, 1, 1), (2, 1, 1), 0, 4, 16), ((2, 1, 1), (2, 1, 1), 0, 256, 32),
]
CONV_IDS = ["subm3-c4", "subm3-c256", "s2-c4", "s2-c256", "k311-c4", "k311-c256",
            "k211-c4", "k211-c256"]


def _conv_case(kernel, stride, padding, cin, cout, seed=7):
    jst, tst = make_pair(seed=seed, C=cin)
    K = int(np.prod(cuda_conv.triple(kernel)))
    w = (np.random.RandomState(seed + 1).randn(K, cin, cout) / np.sqrt(K * cin)).astype(np.float32)
    return jst, tst, w, K


@pytest.mark.parametrize("kernel,stride,padding,cin,cout", CONV_CASES, ids=CONV_IDS)
def test_conv_modules_match_jax_engine(kernel, stride, padding, cin, cout):
    """SubMConv3d / SparseConv3d of both packages, f32, same weights."""
    jst, tst, w, K = _conv_case(kernel, stride, padding, cin, cout)
    subm = stride == 1
    if subm:
        jmod = JS.SubMConv3d(cout, kernel)
        tmod = TS.SubMConv3d(cin, cout, kernel)
    else:
        jmod = JS.SparseConv3d(cout, kernel, stride, padding)
        tmod = TS.SparseConv3d(cin, cout, kernel, stride, padding)
    jout = jmod.apply({"params": {"kernel": jnp.asarray(w)}}, jst, {})
    with torch.no_grad():
        tmod.weight.copy_(torch.from_numpy(w.reshape(tmod.weight.shape)))
        with f32_mode():
            tout = tmod(tst, {})
    np.testing.assert_array_equal(tout.keys.numpy(), np.asarray(jout.keys))
    np.testing.assert_array_equal(tout.coords.numpy(), np.asarray(jout.coords))
    assert tout.spatial_shape == jout.spatial_shape
    assert_close(tout.features.numpy(), np.asarray(jout.features))
    assert np.abs(np.asarray(jout.features)).max() > 0.1


def _pallas(jst, w, kernel, stride, padding, coords, valid):
    """Pallas conv kernel in interpret mode; inputs wider than its 128-lane
    table run in 128-channel chunks, as the JAX engine does."""
    out = 0
    for c0 in range(0, w.shape[1], 128):
        f = jst.features[:, c0:c0 + 128]
        wc = jnp.asarray(w[:, c0:c0 + 128])
        if stride == 1:
            o = JP.fused_subm_conv(f, jst.coords, jst.keys, jst.valid, jst.spatial_shape,
                                   jst.batch_size, wc, kernel, NB=6, interpret=True)
        else:
            o = JP.fused_conv(f, jst.keys, coords, valid, jst.spatial_shape, jst.batch_size,
                              wc, kernel, stride, padding, NB=6, interpret=True)
        out = out + np.asarray(o)
    return out


@pytest.mark.parametrize("kernel,stride,padding,cin,cout", CONV_CASES, ids=CONV_IDS)
def test_plain_conv_matches_pallas_kernel(kernel, stride, padding, cin, cout):
    """K1's plain version on bf16-rounded inputs against the Pallas kernel
    it replaces (bf16 inputs, f32 accumulation)."""
    jst, tst, w, K = _conv_case(kernel, stride, padding, cin, cout, seed=11)
    if stride == 1:
        coords, valid = jst.coords, jst.valid
    else:
        keys, coords, _, _ = JS.conv_output_sites(jst, kernel, stride, padding, jst.capacity)
        valid = keys != JS.INT32_MAX
    ref = _pallas(jst, w, kernel, stride, padding, coords, valid)
    p = tuple(k // 2 for k in cuda_conv.triple(kernel)) if stride == 1 else padding
    out = cuda_conv.sparse_conv(
        torch.from_numpy(bf16(tst.features.numpy())), tst.keys,
        torch.tensor(np.asarray(coords)), torch.from_numpy(bf16(w)), tst.spatial_shape,
        tst.batch_size, kernel, stride, p)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-2, rtol=2e-2)


def test_masked_batchnorm_eval():
    rng = np.random.RandomState(0)
    x = rng.randn(50, 6).astype(np.float32)
    mask = rng.rand(50) < 0.7
    p = {"scale": rng.randn(6).astype(np.float32), "bias": rng.randn(6).astype(np.float32)}
    s = {"mean": rng.randn(6).astype(np.float32), "var": rng.rand(6).astype(np.float32) + 0.5}
    ref = JS.MaskedBatchNorm().apply({"params": p, "batch_stats": s}, jnp.asarray(x),
                                     jnp.asarray(mask), use_running_average=True)
    bn = TS.MaskedBatchNorm(6).eval()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(p["scale"]))
        bn.bias.copy_(torch.from_numpy(p["bias"]))
        bn.running_mean.copy_(torch.from_numpy(s["mean"]))
        bn.running_var.copy_(torch.from_numpy(s["var"]))
        out = bn(torch.from_numpy(x), torch.from_numpy(mask))
    assert_close(out.numpy(), np.asarray(ref))


def test_dense_matches():
    jst, tst = make_pair(seed=9, C=5)
    for layout in ("zyx", "yzx"):
        np.testing.assert_array_equal(tst.dense(layout).numpy(), np.asarray(jst.dense(layout)))


GRAD_CASES = [(3, 1, 1, 8, 16), (3, 2, 1, 8, 24), ((3, 1, 1), (2, 1, 1), 0, 16, 8),
              (3, 2, (0, 1, 1), 256, 32)]
GRAD_IDS = ["subm3", "s2", "k311", "s2-c256"]


def _port_conv_grads(tst, w, kernel, stride, padding, cin, cout, feats):
    """df, dW of sum(out**2) through the port's conv module (autograd:
    K1 df + K3 dW, plain versions on the CPU)."""
    mod = (TS.SubMConv3d(cin, cout, kernel) if stride == 1
           else TS.SparseConv3d(cin, cout, kernel, stride, padding))
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(w.reshape(mod.weight.shape)))
    f = torch.from_numpy(feats).requires_grad_()
    out = mod(tst.replace(features=f), {})
    (out.features.float() ** 2).sum().backward()
    return f.grad.numpy(), mod.weight.grad.reshape(w.shape).numpy()


@pytest.mark.parametrize("kernel,stride,padding,cin,cout", GRAD_CASES, ids=GRAD_IDS)
def test_conv_gradients_match_jax_engine(kernel, stride, padding, cin, cout):
    """The port's sparse-conv backward (df through K1's plain version, in
    transpose-query mode for strided convs; dW through K3's) against
    `jax.grad` of the JAX engine's `apply_rulebook_matmul`, f32."""
    import jax

    jst, tst, w, K = _conv_case(kernel, stride, padding, cin, cout, seed=21)
    if stride == 1:
        idx, found = JS.subm_rulebook(jst, kernel)
    else:
        keys, coords, _, _ = JS.conv_output_sites(jst, kernel, stride, padding, jst.capacity)
        idx, found = JS.conv_rulebook(jst, coords, keys != JS.INT32_MAX, kernel, stride, padding)
    feats = np.asarray(jst.features)
    rf, rw = jax.grad(lambda f, ww: (JS.apply_rulebook_matmul(f, idx, found, ww) ** 2).sum(),
                      argnums=(0, 1))(jnp.asarray(feats), jnp.asarray(w))
    with f32_mode():
        gf, gw = _port_conv_grads(tst, w, kernel, stride, padding, cin, cout,
                                  tst.features.numpy())
    # jst and tst hold the same rows in the same (key) order
    rf, rw = np.asarray(rf), np.asarray(rw)
    assert_close(gf, rf, rtol=1e-4, atol=1e-4 * np.abs(rf).max())
    assert_close(gw, rw, rtol=1e-4, atol=1e-4 * np.abs(rw).max())
    assert np.abs(rf).max() > 0 and np.abs(rw).max() > 0


@pytest.mark.parametrize("strided", [False, True], ids=["subm", "strided"])
def test_conv_gradients_match_pallas_backward(strided):
    """The port's backward in bf16 against the Pallas backward it replaces
    (`_pallas_subm_ad` / `_pallas_strided_ad`: df through the fused conv
    kernel, dW through `_fused_call_dw`), in interpret mode, at the bf16
    tolerance of tests/test_pallas_conv.py."""
    import jax

    cin, cout = 16, 24
    jst, tst = make_pair(seed=23, n=1200, C=cin)
    w = (np.random.RandomState(24).randn(27, cin, cout) * 0.1).astype(np.float32)
    if strided:
        keys, coords, _, out_shape = JS.conv_output_sites(jst, 3, 2, 1, jst.capacity)
        T = 128
        qk, G, TPG = JP.qkeys_conv(coords, keys != JS.INT32_MAX, jst.spatial_shape,
                                   jst.batch_size, 3, 2, 1, T)
        cfg = (G, TPG, T, 128, 6, keys.shape[0], tuple(int(x) for x in out_shape),
               jst.batch_size, (3, 3, 3), (2, 2, 2), (1, 1, 1), JP.tap_perm(3))

        def pal(f, ww):
            return (JS._pallas_strided_ad(cfg, f, ww, qk, jst.keys, keys, jst.coords) ** 2).sum()
    else:
        qk, G, TPG = JP.qkeys_subm(jst.coords, jst.valid, jst.spatial_shape, jst.batch_size,
                                   3, 256)

        def pal(f, ww):
            cfg = (G, TPG, 256, 128, 6, jst.capacity, JP.tap_perm(3))
            return (JS._pallas_subm_ad(cfg, f, ww, qk, jst.keys) ** 2).sum()

    orig, orig_dw = JP._fused_call, JP._fused_call_dw
    try:
        JP._fused_call = lambda *a, **k: orig(*a, **{**k, "interpret": True})
        JP._fused_call_dw = lambda *a, **k: orig_dw(*a, **{**k, "interpret": True})
        rf, rw = jax.grad(pal, argnums=(0, 1))(jst.features, jnp.asarray(w))
    finally:
        JP._fused_call, JP._fused_call_dw = orig, orig_dw
    feats = bf16(tst.features.numpy())
    gf, gw = _port_conv_grads(tst, bf16(w), 3, 2 if strided else 1, 1, cin, cout, feats)
    np.testing.assert_allclose(gf, np.asarray(rf), atol=0.3, rtol=0.1)
    np.testing.assert_allclose(gw, np.asarray(rw), atol=0.3, rtol=0.1)
    assert np.abs(np.asarray(rw)).max() > 1.0


MAP_CASES = [  # kernel, stride, padding, transpose
    (3, 1, 1, False), (3, 2, 1, False), ((3, 1, 1), (2, 1, 1), 0, False),
    ((2, 1, 1), (2, 1, 1), 0, False), (3, 2, (0, 1, 1), False), (3, 2, 1, True),
    ((3, 1, 1), (2, 1, 1), 0, True)]
MAP_IDS = ["subm3", "s2", "k311", "k211", "s2-p011", "s2-transpose", "k311-transpose"]


@pytest.mark.parametrize("kernel,stride,padding,transpose", MAP_CASES, ids=MAP_IDS)
def test_plain_neighbor_map_matches_rulebook(kernel, stride, padding, transpose):
    """The map kernel's plain version is `where(found, idx, -1)` of the
    rulebook, and that rulebook is the JAX engine's (forward cases; the
    transpose query pairs the strided conv's output table with its input
    sites)."""
    jst, tst = make_pair(seed=12)
    keys, coords, _, out_shape = TS.conv_output_sites(tst, kernel, stride, padding,
                                                      tst.capacity)
    if stride == 1:
        keys, coords, out_shape = tst.keys, tst.coords, tst.spatial_shape
    if transpose:
        table, queries, shape = keys, tst.coords, out_shape
    else:
        table, queries, shape = tst.keys, coords, tst.spatial_shape
    nbr = cuda_conv.neighbor_map(table, queries, shape, tst.batch_size, kernel, stride, padding,
                                 transpose)
    K = int(np.prod(cuda_conv.triple(kernel)))
    assert nbr.dtype == torch.int32 and nbr.shape == (K, queries.shape[0])
    idx, found = cuda_conv.conv_rulebook(table, queries, shape, kernel, stride, padding,
                                         transpose)
    assert torch.equal(nbr, torch.where(found, idx, torch.full_like(idx, -1)).to(torch.int32))
    assert (nbr[:, queries[:, 0] < 0] == -1).all() and found.any()
    if not transpose:
        if stride == 1:
            ji, jf = JS.subm_rulebook(jst, kernel)
        else:
            jk, jc, _, _ = JS.conv_output_sites(jst, kernel, stride, padding, jst.capacity)
            ji, jf = JS.conv_rulebook(jst, jc, jk != JS.INT32_MAX, kernel, stride, padding)
        jref = np.where(np.asarray(jf), np.asarray(ji), -1)
        np.testing.assert_array_equal(nbr.numpy(), jref)


def _count_maps(monkeypatch):
    """Record the (kernel, stride, padding) of every neighbour map built."""
    builds, orig = [], cuda_conv.neighbor_map

    def counting(*a, **k):
        builds.append(tuple(a[4:7]))
        return orig(*a, **k)

    monkeypatch.setattr(cuda_conv, "neighbor_map", counting)
    return builds


def test_convs_that_pair_alike_share_one_map(monkeypatch):
    """Within one forward cache: the subm convs of one key share one map;
    a subm conv with another kernel under the same key builds its own; two
    strided convs onto the same cached sites from the same input table
    share one; a strided conv from another input table builds its own."""
    _, tst = make_pair(seed=13, C=8)
    builds = _count_maps(monkeypatch)
    cache = {}
    with torch.no_grad():
        a = TS.SubMConv3d(8, 8, 3, indice_key="subm1")(tst, cache)
        b = TS.SubMConv3d(8, 8, 3, indice_key="subm1")(a, cache)
        assert len(builds) == 1
        TS.SubMConv3d(8, 8, (3, 1, 1), indice_key="subm1")(b, cache)
        assert len(builds) == 2 and builds[1][0] == (3, 1, 1)
        d1 = TS.SparseConv3d(8, 8, 3, 2, 1, indice_key="spconv2")(b, cache)
        d2 = TS.SparseConv3d(8, 16, 3, 2, 1, indice_key="spconv2")(a, cache)
        assert len(builds) == 3
        assert torch.equal(d1.keys, d2.keys)
        # same sites, another input table (the strided output): a new map
        TS.SparseConv3d(8, 8, 3, 2, 1, indice_key="spconv2")(d1, cache)
        assert len(builds) == 4
    # a new forward (a new cache) builds again
    with torch.no_grad():
        TS.SubMConv3d(8, 8, 3, indice_key="subm1")(tst, {})
    assert len(builds) == 5


@pytest.mark.parametrize("kernel", [3, (3, 1, 1)], ids=["k3", "k311"])
def test_subm_df_reads_the_forward_map(kernel):
    """A subm conv's df through the forward's neighbour map (tap-reversed,
    transposed weights) equals the df through its own pair search, bit for
    bit, and the autograd backward of the module gives the same df."""
    cin, cout = 8, 16
    jst, tst, w, K = _conv_case(kernel, 1, 1, cin, cout, seed=14)
    pad = tuple(k // 2 for k in cuda_conv.triple(kernel))
    nbr = cuda_conv.neighbor_map(tst.keys, tst.coords, tst.spatial_shape, tst.batch_size, kernel,
                                 1, pad)
    g = torch.from_numpy(np.random.RandomState(15).randn(tst.capacity, cout).astype(np.float32))
    w_t = torch.from_numpy(w).flip(0).transpose(1, 2)
    args = (g, tst.keys, tst.coords, w_t, tst.spatial_shape, tst.batch_size, kernel, 1, pad)
    via_map = cuda_conv.sparse_conv_df(*args, transpose=False, nbr=nbr)
    searched = cuda_conv.sparse_conv_df(*args, transpose=False)
    assert torch.equal(via_map, searched) and float(searched.abs().max()) > 0
    mod = TS.SubMConv3d(cin, cout, kernel)
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(w.reshape(mod.weight.shape)))
    f = tst.features.clone().requires_grad_()
    with f32_mode():
        out = mod(tst.replace(features=f), {})
    out.features.backward(torch.where(tst.valid[:, None], g, torch.zeros(())))
    ref = cuda_conv.sparse_conv_df(torch.where(tst.valid[:, None], g, torch.zeros(())),
                                   *args[1:], transpose=False)
    torch.testing.assert_close(f.grad, ref, rtol=0, atol=0)
